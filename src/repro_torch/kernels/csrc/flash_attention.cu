// Flash attention forward for Hopper (sm_90a): blocked online softmax over
// q/k/v of shape (B, H, T, D), float32 or bfloat16, for one (batch, head)
// slice at a time:
//   s[i, j] = (q_i . k_j) * scale                                   (float32)
//   s       = cap * tanh(s / cap)                        (logit softcap > 0)
//   s[i, j] = -1e30 unless key j is valid for query i
//   o_i     = sum_j exp(s[i, j] - m_i) v_j / max(l_i, 1e-30)
// with m_i the running row max and l_i the running row sum, in float32,
// written in the input's dtype.  The query at row i sits at position
// i + (Tk - Tq).  Key j is valid when j <= q_pos (causal) and
// j > q_pos - window (sliding window), as in the reference's oracle.
//
// Replaces the Pallas TPU kernel `_attn_kernel` in
// src/repro/kernels/flash_attention.py.  There the (batch*head, q-block,
// k-block) grid runs in order on one core, and the running (m, l, acc) of a
// q-block live in VMEM scratch from one k-block grid step to the next.
// Hopper blocks run in parallel and in no order, so here one block owns a
// tile of kBQ = 64 query rows of one (batch, head) and loops over the
// k-blocks itself:
//   - the q tile stays in shared memory for the whole loop; each k-block's K
//     and V tiles (kBK = 32 keys) are staged there in float32, with the
//     shared memory above 48 KB taken as dynamic shared memory (137 KB at
//     D = 256); rows of q and K are padded by one float, so the threads of
//     a warp read distinct banks;
//   - 256 threads as 16 x 16: a thread owns 4 query rows, 2 score columns
//     of the 64 x 32 score tile and 4 x D/16 accumulators, in registers;
//     row max and row sum reduce over the 16 threads of a row by shuffles;
//     the probabilities go through shared memory to the P.V product;
//   - scores, softmax statistics and the accumulator are float32, and the
//     products are float32 FMAs on the CUDA cores (no tensor cores);
//   - the ragged tail is masked here: rows past Tq are computed and not
//     stored, keys past Tk are read as zeros and get no weight (exp(-inf)),
//     so the wrapper copies nothing into padding.  A masked key inside the
//     sequence gets -1e30, as in the reference, so a row that has no valid
//     key at all averages every key, as the oracle does.
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
// and 134 MB of q, k, v read and o written: 0.069 ms at 989 TFLOP/s of bf16
// tensor cores, 1.03 ms for any design on float32 CUDA cores at 67 TFLOP/s,
// 0.040 ms for the bytes at 3.35 TB/s.  So it is bound by operations, and
// this design, on the CUDA cores and reading every operand of a product from
// shared memory (6 loads for 8 FMAs in the scores, 4 + D/16 for 4 * D/16 in
// P.V), cannot come near the tensor-core bound: a first version that is
// right.  Closing the gap takes mma.sync / wgmma on bf16 tiles with TMA
// loads, the work of a later version.
//
// Plain C interface, bound with ctypes: each launcher makes `device` current,
// launches on the given stream (PyTorch's current stream) and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                // query rows a block
constexpr int kBK = 32;                // keys a k-block
constexpr int kThreads = 256;          // 16 x 16
constexpr int kRows = kBQ / 16;        // query rows a thread
constexpr int kCols = kBK / 16;        // score columns a thread
constexpr float kMasked = -1e30f;      // the reference's masked score

template <int D>
constexpr int smem_bytes() {
  return (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float y) { *p = y; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float y) {
  *p = __float2bfloat16(y);  // round to nearest even, as torch's .to()
}

// Rows [r0, r0 + n) of a (t, D) matrix into shared memory as float32, row
// stride `stride`; rows at or past t read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src, int r0,
                                          int n, int t) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    const int row = r0 + r;
    dst[r * stride + d] =
        row < t ? to_f32(src[static_cast<long long>(row) * D + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int tq,
                       int tk, float scale, int causal, int window,
                       float softcap) {
  constexpr int kAcc = D / 16;         // accumulator columns a thread
  extern __shared__ float smem[];
  float* s_q = smem;                   // kBQ x (D + 1)
  float* s_k = s_q + kBQ * (D + 1);    // kBK x (D + 1)
  float* s_v = s_k + kBK * (D + 1);    // kBK x D
  float* s_p = s_v + kBK * D;          // kBQ x (kBK + 1)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // the q-blocks of the most keys first: they run longest under causal
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const long long bh = blockIdx.y;
  const T* qh = q + bh * tq * D;
  const T* kh = k + bh * tk * D;
  const T* vh = v + bh * tk * D;
  const int off = tk - tq;             // q position of row i: i + off

  const int nk = (tk + kBK - 1) / kBK;
  int kb_lo = 0, kb_hi = nk;
  if (tq <= tk) {                      // each row has a valid key: note
    const int first_q = q0 + off;
    const int last_q = min(q0 + kBQ, tq) - 1 + off;
    if (causal) kb_hi = min(nk, last_q / kBK + 1);
    if (window > 0) kb_lo = max(0, first_q - window + 1) / kBK;
  }

  load_tile<T, D>(s_q, D + 1, qh, q0, kBQ, tq);

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
    load_tile<T, D>(s_k, D + 1, kh, k0, kBK, tk);
    load_tile<T, D>(s_v, D, vh, k0, kBK, tk);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kd[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kd[j] = s_k[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qd = s_q[(ty * kRows + i) * (D + 1) + d];
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
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool valid = true;
        if (causal) valid = valid && k_pos <= q_pos;
        if (window > 0) valid = valid && k_pos > q_pos - window;
        x = valid ? x : kMasked;
        if (k_pos >= tk) x = -INFINITY;  // past the sequence: no weight
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
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
      for (int j = 0; j < kAcc; ++j) vc[j] = s_v[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = s_p[(ty * kRows + i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc[i][j] = fmaf(p, vc[j], acc[i][j]);
      }
    }
  }

  T* oh = o + bh * tq * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      store(&oh[static_cast<long long>(row) * D + tx + 16 * j],
            acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int bh,
             int tq, int tk, float scale, int causal, int window,
             float softcap, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((tq + kBQ - 1) / kBQ, bh);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tk, scale, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int tq, int tk, int d, float scale, int causal, int window,
           float softcap, int device, void* stream) {
  if (bh < 0 || tq < 0 || tk < 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d != 64 && d != 128 && d != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tq == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_d<T, 64>(q, k, v, o, bh, tq, tk, scale, causal, window,
                             softcap, s);
    case 128:
      return launch_d<T, 128>(q, k, v, o, bh, tq, tk, scale, causal, window,
                              softcap, s);
    default:
      return launch_d<T, 256>(q, k, v, o, bh, tq, tk, scale, causal, window,
                              softcap, s);
  }
}

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int bh, int tq,
                                   int tk, int d, float scale, int causal,
                                   int window, float softcap,
                                   int device, void* stream) {
  return launch<float>(q, k, v, o, bh, tq, tk, d, scale, causal, window,
                       softcap, device, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int bh, int tq,
                                    int tk, int d, float scale, int causal,
                                    int window, float softcap,
                                    int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, tq, tk, d, scale, causal,
                               window, softcap, device, stream);
}
