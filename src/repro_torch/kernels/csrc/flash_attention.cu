// Flash attention forward for Hopper (sm_90a): blocked online softmax over
// q of shape (B, Tq, H, Dk), k of shape (B, Tk, Hkv, Dk) and v of shape
// (B, Tk, Hkv, Dv), each with its own strides for B, T and heads (the head
// dim at unit stride), float32 or bfloat16:
//   s[i, j] = (q_i . k_j) * scale                                   (float32)
//   s       = cap * tanh(s / cap)                        (logit softcap > 0)
//   s[i, j] = -1e30 unless key j is valid for query i
//   o_i     = sum_j exp(s[i, j] - m_i) v_j / max(l_i, 1e-30)
// with m_i the running row max and l_i the running row sum, in float32,
// written in the input's dtype to o, (B, Tq, H, Dv) with its own strides.
// The (Dk, Dv) pairs built (FA_PAIRS below): (64, 64), (128, 128) and
// (256, 256) for the dense LMs, (96, 96) for phi-3-vision, and MLA's
// (192, 128) (deepseek-v2), (96, 64) (minicpm3) and (48, 32) (the reduced
// MLA configs), where k carries the rope dims and v does not.
// Query head h reads KV head h / (H / Hkv) (GQA; Hkv = H is MHA).  The query
// at row i sits at position i + (Tk - Tq).  Key j is valid when j <= q_pos
// (causal) and j > q_pos - window (sliding window), as in the reference's
// oracle.  The same entry points serve the (B, H, T, D) layout: the caller
// passes that layout's strides.
//
// Replaces the Pallas TPU kernel `_attn_kernel` in
// src/repro/kernels/flash_attention.py.  There the (batch*head, q-block,
// k-block) grid runs in order on one core, and the running (m, l, acc) of a
// q-block live in VMEM scratch from one k-block grid step to the next.
// Hopper blocks run in parallel and in no order, so here one block owns a
// tile of 64 query rows of one (batch, head) and loops over the k-blocks
// itself.  The grid's x runs over (batch, head) and its y over q-blocks,
// the q-blocks of the most keys first, so under causal masking the longest
// blocks of every head start first and the short ones fill the tail.
//
// bfloat16: tensor cores (flash_attention_tc).  One warpgroup (128 threads)
// a block, FlashAttention-3 style with wgmma:
//   - S = Q.K^T by wgmma.m64n64k16 with Q and K read from shared memory by
//     matrix descriptors, float32 accumulators, asynchronously: the scores
//     of k-block j + 1 are issued before the softmax of j, which does not
//     depend on them, so the tensor cores run while it does (K of j + 1 is
//     staged a k-block ahead of V of j for that);
//   - the online softmax in float32 on the accumulators, in registers:
//     each warp owns 16 of the 64 rows, the row max over the 4 lanes that
//     share a row by shuffles, p = __expf(s - m) (the SFU's exp2: relative
//     error ~2^-21 plus 2^-24 |s - m|, far under the hi/lo pair's 2^-18
//     below), the row sum from the float32 p, kept per lane and reduced
//     once at the end;
//   - O += P.V as two bf16 products, P_hi.V + P_lo.V, with P_hi = bf16(p)
//     and P_lo = bf16(p - P_hi), by wgmma.m64n64k16 with A in registers,
//     accumulated in float32.  The reference multiplies the float32 p by
//     v; one bf16 product of bf16(p), as FlashAttention-2/3 and SDPA do,
//     moves the mean |error| at the LM's prefill shape ~80x over what that
//     function allows, and the hi/lo pair (16 bits of p's mantissa) keeps
//     it at ~1.5e-7 (benchmarks/pv_rounding.py).  P never leaves the
//     registers: the accumulators of two 8-key column tiles are the A
//     fragment of one 16-key step, as with mma.sync;
//   - Q, K and V stay bf16 in shared memory in the 128-byte swizzle wgmma
//     reads (64-column blocks of 128-byte rows, 16-byte chunks permuted by
//     row), written by cp.async, which copies each 16-byte chunk from
//     wherever the caller's strides put it and zero-fills the ragged tail;
//     K and V take two stages each, the copies of the next tiles in flight
//     while this k-block computes, one __syncthreads a k-block.  81 KB of
//     dynamic shared memory at D = 128 (2 blocks a SM), 161 KB at 256;
//   - a head dim that is not a multiple of 64 (Dk = 48, 96, 192; Dv = 32,
//     96) keeps the 64-column pitch of the swizzle: its last 64-column
//     block is filled only to the real 16-byte chunks, the rest zero-filled
//     by cp.async.  Q.K^T stops at Dk / 16 k-steps, so it never reads the
//     padding; P.V runs N = 64 on each 64-column block of V, so at Dv = 32
//     or 96 the last block's products include padded columns (zeros), whose
//     outputs are dropped at the store.
// cp.async rather than TMA: a tensor map would have to be encoded on the
// host for every call's strides, and cp.async's zero-fill covers the
// ragged tail.
// Not done yet: a producer warp feeding an mbarrier ring and two consumer
// warpgroups taking turns (FlashAttention-3's ping-pong), so that one's
// softmax hides under the other's products.  An mma.sync design (one warp
// a 16-row tile, every warp reading all of K and V from shared memory) was
// slower at the prefill shape, and so was issuing P.V, rather than the
// next scores, before the softmax.
//
// float32: the CUDA-core body (flash_attention_f32_kernel) of 256 threads
// as 16 x 16, each owning 4 rows x 2 score columns and 4 x Dv/16
// accumulators, float32 FMAs on tiles staged in shared memory.  Kept
// deliberately: a bf16 tensor-core product of float32 q and k cannot meet
// the float32 tolerance (2e-5) that the tests hold this dtype to.
//
// Both bodies mask the ragged tail here: rows past Tq are computed and not
// stored, keys past Tk are read as zeros and get no weight (exp(-inf)), so
// the wrapper copies nothing into padding.  A masked key inside the
// sequence gets -1e30, as in the reference, so a row that has no valid key
// at all averages every key, as the oracle does.
// Skipping k-blocks: when Tq <= Tk, a block visits only the k-blocks that
// hold a valid key of one of its rows (below the causal edge of its last
// row, above the window edge of its first row).  The skipped keys would get
// exp(-1e30 - m) = 0 once a row has met a valid key, so the result is
// unchanged as long as every row has one: true whenever Tq <= Tk and
// window >= 1 (the key at q_pos itself is valid; window <= 0 means no
// window).  With Tq > Tk the first rows may have no valid key and average
// every key, so then every block visits every k-block.
//
// Bound: at the LM's prefill shape (B = 4, H = 16, T = 2048, D = 128, bf16,
// causal) the function needs 6.87e10 useful flops (4 * B*H * D * T*(T+1)/2)
// and 134 MB of q, k, v read and o written: 0.0695 ms at 989 TFLOP/s of
// bf16 tensor cores, 0.040 ms for the bytes at 3.35 TB/s, so it is bound by
// operations.  The hi/lo split is this design's cost, not the function's:
// with the third product the tensor cores do 1.03e11 flops, 0.104 ms at
// 989 TFLOP/s, before the causal diagonal's masked half-tiles.  On an
// NVIDIA H100 80GB HBM3 at 700 W this body takes 0.34 ms there, 4.9x the
// bound (chip_smoke.py phase 5).
//
// Plain C interface, bound with ctypes: each launcher makes `device` current,
// launches on the given stream (PyTorch's current stream) and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kMasked = -1e30f;      // the reference's masked score

// Element strides of q, k, v and o over (batch, time, head); the head
// dim is at unit stride.
struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
};

// Which k-blocks [lo, hi) a q-block of rows [q0, q0 + bq) visits: see the
// note on skipping.
__device__ __forceinline__ void kblock_range(int q0, int bq, int bk, int tq,
                                             int tk, int causal, int window,
                                             int* lo, int* hi) {
  const int nk = (tk + bk - 1) / bk;
  *lo = 0;
  *hi = nk;
  if (tq <= tk) {
    const int off = tk - tq;
    const int first_q = q0 + off;
    const int last_q = min(q0 + bq, tq) - 1 + off;
    if (causal) *hi = min(nk, last_q / bk + 1);
    if (window > 0) *lo = max(0, first_q - window + 1) / bk;
  }
}

// The score after scale, softcap and the masks.
__device__ __forceinline__ float masked_score(float s, float scale,
                                              float softcap, int q_pos,
                                              int k_pos, int tk, int causal,
                                              int window) {
  float x = s * scale;
  if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
  bool valid = true;
  if (causal) valid = valid && k_pos <= q_pos;
  if (window > 0) valid = valid && k_pos > q_pos - window;
  x = valid ? x : kMasked;
  if (k_pos >= tk) x = -INFINITY;      // past the sequence: no weight
  return x;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;          // one warpgroup
constexpr int kBQ = 64;                // query rows a block: one wgmma M
constexpr int kBK = 64;                // keys a k-block: the scores' wgmma N

// Shared tiles hold rows of 64 bf16 (128 bytes) in the 128-byte swizzle
// wgmma reads: a tile of R rows x D is ceil(D / 64) blocks of R x 128
// bytes, and the 16-byte chunk c of row r sits at chunk c ^ (r % 8).  Tiles
// start at 1024-byte boundaries, where the swizzle's period begins.
template <int D>
__host__ __device__ constexpr int col_blocks() { return (D + 63) / 64; }
template <int R>
__host__ __device__ constexpr int block_bytes() { return R * 128; }
template <int R, int D>
__host__ __device__ constexpr int tile_bytes() {
  return col_blocks<D>() * block_bytes<R>();
}

template <int DK, int DV>
constexpr int smem_bytes() {  // Q, 2 stages of K and V, alignment slack
  return tile_bytes<kBQ, DK>() + 2 * tile_bytes<kBK, DK>() +
         2 * tile_bytes<kBK, DV>() + 1024;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !pred (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// Two float32 p as bf16 pairs hi = bf16(p), lo = bf16(p - hi); the element
// of the lower column in the low half, as wgmma's A fragments want it.
__device__ __forceinline__ void split(float x, float y, unsigned* hi,
                                      unsigned* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  *hi = as_u32(h);
  *lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// A shared-memory matrix descriptor, 128-byte swizzle: the start address,
// the leading and stride byte offsets, in 16-byte units.
__device__ __forceinline__ unsigned long long desc(const void* p, int lbo,
                                                   int sbo) {
  return static_cast<unsigned long long>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<unsigned long long>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<unsigned long long>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of r across a wgmma
// fence or wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A . B on 64 x 64 x 16, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], unsigned long long a,
                                       unsigned long long b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B on 64 x 64 x 16, A in registers (a warp's 16 rows as
// mma.sync's A fragment), B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const unsigned (&a)[4],
                                       unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Rows [r0, r0 + R) of a (t, D) bf16 matrix with row stride `stride` into
// a swizzled tile; rows at or past t, and the chunks of the last 64-column
// block past D, read as zeros.
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int t) {
  static_assert(D % 8 == 0, "whole 16-byte chunks");
  constexpr int kChunks = col_blocks<D>() * 8;  // 16-byte chunks a tile row
  static_assert(R * kChunks % kThreads == 0, "whole rounds of the block");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const int row = r0 + r;
    const bool in = row < t && ch < D / 8;
    cp_async16(dst + (ch >> 3) * block_bytes<R>() + r * 128 +
                       (((ch & 7) ^ (r & 7)) << 4),
                   src + (in ? row * stride + ch * 8 : 0), in);
  }
}

// S = Q K^T, 64 rows x kBK keys, issued and committed, not waited for.
// Q and K are K-major: a k-step of 16 columns is 32 bytes into a 64-column
// block (the swizzle applies to the address), 8-row groups 1024 bytes
// apart; the leading offset is unused in this swizzle.
template <int DK>
__device__ __forceinline__ void scores(float (&s)[32],
                                       const unsigned char* s_q,
                                       const unsigned char* sk) {
  static_assert(DK % 16 == 0, "whole k-steps");
  pin(s);
  fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const int off = (kk & 3) * 32;     // 16 columns: 32 bytes
    mma_ss(s, desc(s_q + (kk >> 2) * block_bytes<kBQ>() + off, 16, 1024),
           desc(sk + (kk >> 2) * block_bytes<kBK>() + off, 16, 1024),
           kk > 0);
  }
  commit();
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, DK <= 128 ? 2 : 1)
flash_attention_tc(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int heads, int group,
                   int tq, int tk, Strides st, float scale, int causal,
                   int window, float softcap) {
  constexpr int kDB = col_blocks<DV>();  // 64-column blocks of an output row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_q = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(smem_raw) + 1023) & ~1023ull);
  unsigned char* s_k = s_q + tile_bytes<kBQ, DK>();
  unsigned char* s_v = s_k + 2 * tile_bytes<kBK, DK>();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;             // the row (and row + 8) of a fragment
  const int tig = lane & 3;            // its column pair
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int hk = h / group;
  const __nv_bfloat16* qh = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kh = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vh = v + b * st.vb + hk * st.vh;
  const int off = tk - tq;             // q position of row i: i + off
  int kb_lo, kb_hi;
  kblock_range(q0, kBQ, kBK, tq, tk, causal, window, &kb_lo, &kb_hi);

  const int tq0 = q0 + 16 * warp + off;  // position of the warp's row 0
  auto k_tile = [&](int kb) { return s_k + (kb & 1) * tile_bytes<kBK, DK>(); };
  auto v_tile = [&](int kb) { return s_v + (kb & 1) * tile_bytes<kBK, DV>(); };

  // K of k-block kb + 1 is staged a k-block ahead of V of kb, so that the
  // scores of kb + 1 run on the tensor cores while the softmax of kb runs
  load_tile<DK, kBQ>(s_q, qh, st.qt, q0, tq);
  if (kb_lo < kb_hi) {
    load_tile<DK, kBK>(k_tile(kb_lo), kh, st.kt, kb_lo * kBK, tk);
    load_tile<DV, kBK>(v_tile(kb_lo), vh, st.vt, kb_lo * kBK, tk);
  }
  cp_async_commit();
  if (kb_lo + 1 < kb_hi)
    load_tile<DK, kBK>(k_tile(kb_lo + 1), kh, st.kt, (kb_lo + 1) * kBK, tk);
  cp_async_commit();
  cp_async_wait<1>();
  // cp.async wrote through the generic proxy; wgmma reads through the
  // async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float s[32];
  if (kb_lo < kb_hi) {
    scores<DK>(s, s_q, k_tile(kb_lo));
    wait<0>();
    pin(s);
  }

  float acc[kDB][32];
#pragma unroll
  for (int nb = 0; nb < kDB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.0f;
  float m[2] = {kMasked, kMasked};     // rows g and g + 8
  float l[2] = {0.0f, 0.0f};

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // K of kb + 1 and V of kb have landed for every thread, and every
    // wgmma of the last k-block is done with K of kb and V of kb - 1,
    // whose stages the next copies take
    __syncthreads();
    if (kb + 2 < kb_hi)
      load_tile<DK, kBK>(k_tile(kb + 2), kh, st.kt, (kb + 2) * kBK, tk);
    if (kb + 1 < kb_hi)
      load_tile<DV, kBK>(v_tile(kb + 1), vh, st.vt, (kb + 1) * kBK, tk);
    cp_async_commit();

    float s_next[32];
    if (kb + 1 < kb_hi) scores<DK>(s_next, s_q, k_tile(kb + 1));

    // scale, softcap, masks (only where the warp's rows meet an edge in
    // this k-block), then the online softmax: p = exp(s - m) in float32;
    // s[4 j + e] is row g + 8 (e / 2), key 8 j + 2 tig + e % 2
    const int k0 = kb * kBK;
    const bool edge = k0 + kBK > tk || (causal && k0 + kBK - 1 > tq0) ||
                      (window > 0 && k0 <= tq0 + 15 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x;
      if (edge) {
        x = masked_score(s[i], scale, softcap, tq0 + g + ((i >> 1) & 1) * 8,
                         k0 + 8 * (i >> 2) + 2 * tig + (i & 1), tk, causal,
                         window);
      } else {
        x = s[i] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int w = 1; w < 4; w <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], w));
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = __expf(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[4 * j + 2 * r] = __expf(s[4 * j + 2 * r] - m_new);
        s[4 * j + 2 * r + 1] = __expf(s[4 * j + 2 * r + 1] - m_new);
        sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      }
      l[r] = l[r] * corr + sum;        // this lane's columns; reduced last
#pragma unroll
      for (int nb = 0; nb < kDB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[nb][4 * j + 2 * r] *= corr;
          acc[nb][4 * j + 2 * r + 1] *= corr;
        }
    }

    // O += P_hi V + P_lo V, 16 keys a step: the scores of two 8-key tiles
    // are the A fragment of one step
    unsigned ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(s[8 * kk + 4 * (e >> 1) + 2 * (e & 1)],
              s[8 * kk + 4 * (e >> 1) + 2 * (e & 1) + 1], &ph[kk][e],
              &pl[kk][e]);
    const unsigned char* sv = v_tile(kb);
#pragma unroll
    for (int nb = 0; nb < kDB; ++nb) pin(acc[nb]);
    fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < kDB; ++nb) {
        // keys 16 kk.. of column block nb: MN-major, 64-column atoms
        // block_bytes apart (one an instruction here), 8-key groups 1024
        // bytes apart
        const unsigned long long dv =
            desc(sv + nb * block_bytes<kBK>() + kk * 16 * 128,
                 block_bytes<kBK>(), 1024);
        mma_rs(acc[nb], ph[kk], dv);
        mma_rs(acc[nb], pl[kk], dv);
      }
    commit();
    wait<0>();
#pragma unroll
    for (int nb = 0; nb < kDB; ++nb) pin(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pin(ph[kk]);
      pin(pl[kk]);
    }
    if (kb + 1 < kb_hi) {
      pin(s_next);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = s_next[i];
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* oh = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    const float denom = fmaxf(sum, 1e-30f);
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= tq) continue;
#pragma unroll
    for (int nb = 0; nb < kDB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * nb + 8 * j < DV)      // padded columns are dropped
          *reinterpret_cast<__nv_bfloat162*>(oh + row * st.ot + 64 * nb +
                                             8 * j + 2 * tig) =
              __floats2bfloat162_rn(acc[nb][4 * j + 2 * r] / denom,
                                    acc[nb][4 * j + 2 * r + 1] / denom);
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int heads, int group, int tq, int tk, const Strides& st,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DK, DV>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_tc<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  flash_attention_tc<DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      heads, group, tq, tk, st, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;                // query rows a block
constexpr int kBK = 32;                // keys a k-block
constexpr int kThreads = 256;          // 16 x 16
constexpr int kRows = kBQ / 16;        // query rows a thread
constexpr int kCols = kBK / 16;        // score columns a thread

template <int DK, int DV>
constexpr int smem_bytes() {
  return (kBQ * (DK + 1) + kBK * (DK + 1) + kBK * DV + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

// Rows [r0, r0 + n) of a (t, D) matrix with row stride `stride` into
// shared memory at row pitch `pitch`; rows at or past t read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* __restrict__ src,
                                          long long stride, int r0, int n,
                                          int t) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    const int row = r0 + r;
    dst[r * pitch + d] = row < t ? src[row * stride + d] : 0.0f;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int heads, int group, int tq, int tk, Strides st,
                           float scale, int causal, int window,
                           float softcap) {
  static_assert(DV % 16 == 0, "whole accumulator columns a thread");
  constexpr int kAcc = DV / 16;        // accumulator columns a thread
  extern __shared__ float smem[];
  float* s_q = smem;                   // kBQ x (DK + 1)
  float* s_k = s_q + kBQ * (DK + 1);   // kBK x (DK + 1)
  float* s_v = s_k + kBK * (DK + 1);   // kBK x DV
  float* s_p = s_v + kBK * DV;         // kBQ x (kBK + 1)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int hk = h / group;
  const float* qh = q + b * st.qb + h * st.qh;
  const float* kh = k + b * st.kb + hk * st.kh;
  const float* vh = v + b * st.vb + hk * st.vh;
  const int off = tk - tq;             // q position of row i: i + off
  int kb_lo, kb_hi;
  kblock_range(q0, kBQ, kBK, tq, tk, causal, window, &kb_lo, &kb_hi);

  load_tile<DK>(s_q, DK + 1, qh, st.qt, q0, kBQ, tq);

  float m[kRows], l[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.0f;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                   // s_k, s_v, s_p of the last k-block
    load_tile<DK>(s_k, DK + 1, kh, st.kt, k0, kBK, tk);
    load_tile<DV>(s_v, DV, vh, st.vt, k0, kBK, tk);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      float kd[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kd[j] = s_k[(tx + 16 * j) * (DK + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qd = s_q[(ty * kRows + i) * (DK + 1) + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qd, kd[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + ty * kRows + i + off;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = masked_score(s[i][j], scale, softcap, q_pos,
                               k0 + tx + 16 * j, tk, causal, window);
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, w, 16));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        s_p[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w, 16);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vc[kAcc];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) vc[j] = s_v[c * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = s_p[(ty * kRows + i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc[i][j] = fmaf(p, vc[j], acc[i][j]);
      }
    }
  }

  float* oh = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      oh[row * st.ot + tx + 16 * j] = acc[i][j] / denom;
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int heads, int group, int tq, int tk, const Strides& st,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DK, DV>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_f32_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  flash_attention_f32_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, group, tq,
      tk, st, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// A head-dim pair as a type, for the dispatch below.
template <int K, int V>
struct Dims {
  static constexpr int kDK = K, kDV = V;
};

// Calls f(Dims<Dk, Dv>{}) for the pair (dk, dv) the kernels are built for;
// cudaErrorInvalidValue for any other pair.
template <typename F>
int dispatch(int dk, int dv, F&& f) {
#define FA_PAIRS(X) \
  X(64, 64) X(128, 128) X(256, 256) X(96, 96) X(192, 128) X(96, 64) X(48, 32)
#define FA_CASE(K, V) \
  if (dk == K && dv == V) return f(Dims<K, V>{});
  FA_PAIRS(FA_CASE)
#undef FA_CASE
#undef FA_PAIRS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The checks both entries share; 0 when the launch may go ahead, -1 when
// there is nothing to do, else a cudaError_t.
int check(int batch, int heads, int kv_heads, int tq, int tk, int dk, int dv,
          int bq, int device) {
  if (batch < 0 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      tq < 0 || tk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dispatch(dk, dv, [](auto) { return 0; }) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * heads > 0x7fffffffLL ||
      (tq + bq - 1) / bq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || tq == 0) return -1;
  return static_cast<int>(cudaSetDevice(device));
}

Strides strides_of(const long long* s) {
  return {s[0], s[1], s[2], s[3], s[4],  s[5],
          s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// q (B, Tq, H, Dk), k (B, Tk, Hkv, Dk), v (B, Tk, Hkv, Dv), o (B, Tq, H, Dv),
// each at the element strides `strides` gives over (batch, time, head): q's
// three, then k's, v's and o's; the head dim at unit stride.  (dk, dv) one
// of the pairs of FA_PAIRS.  window <= 0: no window; softcap <= 0: no
// softcap.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int batch,
                                   int heads, int kv_heads, int tq, int tk,
                                   int dk, int dv, const long long* strides,
                                   float scale, int causal, int window,
                                   float softcap, int device, void* stream) {
  const int ok = check(batch, heads, kv_heads, tq, tk, dk, dv, f32::kBQ,
                       device);
  if (ok != 0) return ok < 0 ? 0 : ok;
  const Strides st = strides_of(strides);
  const int bh = batch * heads, group = heads / kv_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dk, dv, [&](auto d) {
    using P = decltype(d);
    return f32::launch<P::kDK, P::kDV>(q, k, v, o, bh, heads, group, tq, tk,
                                       st, scale, causal, window, softcap, s);
  });
}

// As flash_attention_f32; besides, q, k, v must be 16-byte aligned with
// strides that are multiples of 8 elements (cp.async copies 16 bytes), and
// o 4-byte aligned with even strides.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int heads, int kv_heads, int tq, int tk,
                                    int dk, int dv, const long long* strides,
                                    float scale, int causal, int window,
                                    float softcap, int device, void* stream) {
  const int ok = check(batch, heads, kv_heads, tq, tk, dk, dv, tc::kBQ,
                       device);
  if (ok != 0) return ok < 0 ? 0 : ok;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 9; i < 12; ++i)
    if (strides[i] % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<unsigned long long>(q) |
       reinterpret_cast<unsigned long long>(k) |
       reinterpret_cast<unsigned long long>(v)) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(o) % 4 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Strides st = strides_of(strides);
  const int bh = batch * heads, group = heads / kv_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dk, dv, [&](auto d) {
    using P = decltype(d);
    return tc::launch<P::kDK, P::kDV>(q, k, v, o, bh, heads, group, tq, tk,
                                      st, scale, causal, window, softcap, s);
  });
}
