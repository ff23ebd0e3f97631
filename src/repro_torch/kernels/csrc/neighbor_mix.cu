// D-PSGD's and AD-PSGD's sparse gossip averaging for Hopper (sm_90a), over
// a list of parameter leaves in one launch:
//   y_j[k, c] = sw[k] * x_j[k, c] + sum_d w[k, d] * src_j[idx[k, d], c]
// for each stacked (K, n_j) leaf x_j, over padded (K, D) neighbor lists (idx
// padded with the node's own index, w padded with 0), accumulated in
// float32 and written in the leaf's dtype (round to nearest even).
//
// The gather source of a leaf is a stack of "staged rows": the leaf's own K
// rows, then E rows of `src` (row e at src + e * src_ld + off_j, where off_j
// is the leaf's column offset); idx[k, d] names staged row base + idx[k, d].
//   - D-PSGD (`ops.neighbor_mix_many`): E = 0, base = 0, M = K.
//   - AD-PSGD (`ops.neighbor_mix_push_many`): src is the old ((S + 1) K, N)
//     snapshot buffer, E = S K (its slots 0 .. S - 1), base = 0, M = (S + 1)
//     K, so the staged rows are the new buffer: slot 0 the leaves, slot s
//     the old slot s - 1.  The same pass writes every staged row to the new
//     buffer `snaps` at the leaf's columns (the snapshot push), and idx =
//     staleness * K + neighbour reads slot `staleness` of it.
//   - The raw op with `src=` (`ops.neighbor_mix(..., src=)`): one leaf, src
//     the whole (M, N) source, E = M, base = K (the self term on x, every
//     neighbour row from src).
// Nothing a block reads is written by the same launch, so blocks do not
// depend on each other.
//
// Replaces the Pallas TPU kernels `_mix_kernel` and `_mix_src_kernel` in
// src/repro/kernels/neighbor_mix.py.  The TPU versions stream (K, rows, 128)
// (and (M, rows, 128)) column blocks of one flat (K, N) matrix through VMEM,
// the k/d loops unrolled over the static (K, D) shape; the caller
// concatenates the model into that matrix, splits it back and, for
// AD-PSGD, rebuilds the snapshot buffer around the call.  Here:
//   - one launch covers up to 32 leaves, read where they lie: their pointers,
//     per-node sizes, column offsets and first tiles go to the kernel by
//     value in a table, as in gaia_select.cu.  Tiles never straddle leaves.
//   - one block owns one column tile of one leaf for all K output rows.  It
//     stages the tile of every source row in shared memory once, with
//     cp.async 16-byte copies where a row's address allows (4-byte copies,
//     or for bfloat16 plain loads, where it does not: the odd rows of a
//     snapshot buffer whose N is 2 mod 4, as GN-LeNet's 96,682), all in
//     flight together, and loads idx, w and sw into shared memory beside
//     them; the push writes each staged row the same way.  One barrier,
//     then each thread computes 16 bytes of columns (4 float32 or 8
//     bfloat16) for every k from shared memory and stores them with one
//     16-byte store where the output row allows, else element by element.
//   - the order of the arithmetic is the earlier one-thread-an-output
//     body's, with nvcc's default contraction written out:
//     acc = sw[k] * x (rounded), then acc = fma(w[k, d], src, acc) for d =
//     0 .. D - 1, the same for every element whichever route staged it, so
//     the leaf-table launch and the one-matrix launch agree bit for bit,
//     and AD-PSGD at staleness 0 is D-PSGD.
//   - K, D, M and the table are runtime values and idx, w, sw device
//     pointers: a new graph, a staleness rung or a participation mask
//     changes operand values only.
//
// Tile: 64 threads a block, 16 bytes a thread, so a staged row's tile is
// 1 KB (256 float32 or 512 bfloat16 columns).  At GN-LeNet's 16 leaves
// (96,682 columns) that is 388 blocks, about three an SM of the 132, all
// resident at once; shared memory is R KB for R staged rows (5 KB for
// D-PSGD at K = 5, 15 KB for AD-PSGD at K = 5, S = 2) plus the operands,
// and up to 227 rows fit in a block's 227 KB.
//
// Bound: bytes.  D-PSGD reads and writes each leaf once (2 K N elements);
// AD-PSGD with the push reads the leaves and S old slots and writes S + 1
// new slots and the outputs ((2 S + 3) K N elements), for 2 (D + 1) flops
// an output.  At these sizes a launch costs more than the bytes, so the
// design's aim is one launch a step with no pass around it.
// An index outside [0, M) contributes nothing.  That guard is memory
// safety only: `ops.mix_operands` refuses such an index on the host, and
// the raw `ops.neighbor_mix` before it launches.
//
// Plain C interface, bound with ctypes: the launcher makes `device`
// current, launches on the given stream (PyTorch's current stream), writes
// the number of launches it made to *launches and returns the cudaError_t
// of the last launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>

namespace {

constexpr int kThreads = 64;                   // threads a block
constexpr int kVecBytes = 16;                  // bytes a thread a row
constexpr int kTileBytes = kThreads * kVecBytes;
constexpr int kMaxLeaves = 32;                 // leaves a launch
constexpr int kMaxSmem = 232448;               // a Hopper block's 227 KB
constexpr int kStaticSmem = 48 * 1024;         // without opting in

// The leaves of one launch, passed by value.
struct Leaves {
  const void* x[kMaxLeaves];
  void* out[kMaxLeaves];
  long long n[kMaxLeaves];     // columns a node (a row's length)
  long long off[kMaxLeaves];   // column offset in src and snaps rows
  int tile0[kMaxLeaves + 1];   // first block of each leaf; then the grid
  int count;
};

// The round's operands and where the rows past the leaf's own come from.
struct Mix {
  const int* idx;
  const float* w;
  const float* self_w;
  const void* src;       // E extra staged rows (null when E == 0)
  long long src_ld;
  void* snaps;           // every staged row is pushed here (null: no push)
  long long snaps_ld;
  int K, D, E, base, M;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// 16 bytes as floats, and floats back as 16 bytes of T.
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bfloat16 bits are a float's upper half
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = static_cast<unsigned>(
               __bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
           (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])))
            << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One element into shared memory: an asynchronous 4-byte copy in float32;
// a plain load and store in bfloat16 (cp.async has no 2-byte size).
__device__ __forceinline__ void stage_elem(float* s, const float* g) {
  cp_async4(s, g);
}
__device__ __forceinline__ void stage_elem(__nv_bfloat16* s,
                                           const __nv_bfloat16* g) {
  *s = *g;
}

// Starts the copy of `len` elements of a row from g into shared s (16-byte
// aligned): whole 16-byte vectors where g is aligned, one element a thread
// otherwise and for the tail.
template <typename T>
__device__ __forceinline__ void stage_row(T* s, const T* g, int len) {
  constexpr int V = kVecBytes / sizeof(T);
  int e0 = 0;
  if (aligned16(g)) {
    const int nv = len / V;              // at most kThreads
    if (static_cast<int>(threadIdx.x) < nv)
      cp_async16(s + threadIdx.x * V, g + threadIdx.x * V);
    e0 = nv * V;
  }
  for (int e = e0 + threadIdx.x; e < len; e += kThreads)
    stage_elem(s + e, g + e);
}

// Writes `len` elements of a staged row s to g, as stage_row reads.
template <typename T>
__device__ __forceinline__ void push_row(T* g, const T* s, int len) {
  constexpr int V = kVecBytes / sizeof(T);
  int e0 = 0;
  if (aligned16(g)) {
    const int nv = len / V;
    if (static_cast<int>(threadIdx.x) < nv)
      reinterpret_cast<uint4*>(g)[threadIdx.x] =
          reinterpret_cast<const uint4*>(s)[threadIdx.x];
    e0 = nv * V;
  }
  for (int e = e0 + threadIdx.x; e < len; e += kThreads) g[e] = s[e];
}

// The leaf whose tiles hold this block (leaves of no tile are passed by).
__device__ __forceinline__ int leaf_of_block(const Leaves& tab) {
  int j = 0;
  while (j + 1 < tab.count && static_cast<int>(blockIdx.x) >= tab.tile0[j + 1])
    ++j;
  return j;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
neighbor_mix_kernel(const Leaves tab, const Mix mix) {
  constexpr int V = kVecBytes / sizeof(T);
  constexpr int kTile = kThreads * V;          // columns a block
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = mix.K, D = mix.D, R = mix.K + mix.E;
  T* stage = reinterpret_cast<T*>(smem);       // R rows of kTile
  int* s_idx = reinterpret_cast<int*>(smem + static_cast<size_t>(R) *
                                                 kTileBytes);
  float* s_w = reinterpret_cast<float*>(s_idx + K * D);
  float* s_sw = s_w + K * D;

  const int j = leaf_of_block(tab);
  const long long n = tab.n[j];
  const long long c0 = static_cast<long long>(blockIdx.x - tab.tile0[j]) *
                       kTile;
  const int len = static_cast<int>(n - c0 < kTile ? n - c0 : kTile);
  const T* x = static_cast<const T*>(tab.x[j]) + c0;

  // every staged row's tile, all copies in flight together
  for (int r = 0; r < K; ++r)
    stage_row(stage + r * kTile, x + r * n, len);
  if (mix.E > 0) {
    const T* src = static_cast<const T*>(mix.src) + tab.off[j] + c0;
    for (int e = 0; e < mix.E; ++e)
      stage_row(stage + (K + e) * kTile, src + e * mix.src_ld, len);
  }
  for (int i = threadIdx.x; i < K * D; i += kThreads) {
    s_idx[i] = mix.idx[i];
    s_w[i] = mix.w[i];
  }
  for (int i = threadIdx.x; i < K; i += kThreads) s_sw[i] = mix.self_w[i];
  cp_async_wait_all();
  __syncthreads();

  if (mix.snaps != nullptr) {                  // the snapshot push
    T* snaps = static_cast<T*>(mix.snaps) + tab.off[j] + c0;
    for (int r = 0; r < R; ++r)
      push_row(snaps + r * mix.snaps_ld, stage + r * kTile, len);
  }

  const int col = threadIdx.x * V;
  if (col >= len) return;
  const int valid = len - col < V ? len - col : V;
  T* out = static_cast<T*>(tab.out[j]) + c0 + col;
  for (int k = 0; k < K; ++k) {
    float acc[V], v[V];
    unpack(*reinterpret_cast<const uint4*>(stage + k * kTile + col), v);
    const float sw = s_sw[k];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = __fmul_rn(sw, v[q]);
    for (int d = 0; d < D; ++d) {
      const int m = s_idx[k * D + d];
      if (m < 0 || m >= mix.M) continue;
      const float wd = s_w[k * D + d];
      unpack(*reinterpret_cast<const uint4*>(
                 stage + (mix.base + m) * kTile + col), v);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = __fmaf_rn(wd, v[q], acc[q]);
    }
    T* o = out + k * n;
    if (valid == V && aligned16(o)) {
      *reinterpret_cast<uint4*>(o) = pack(acc);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q)
        if (q < valid) o[q] = from_f32<T>(acc[q]);
    }
  }
}

template <typename T>
int launch(const void* const* x, void* const* out, const long long* n,
           const long long* off, int count, const void* idx, const void* w,
           const void* self_w, int K, int D, const void* src,
           long long src_ld, int E, int base, int M, void* snaps,
           long long snaps_ld, int device, void* stream, int* launches) {
  constexpr int V = kVecBytes / sizeof(T);
  constexpr int kTile = kThreads * V;
  *launches = 0;
  if (count < 0 || K <= 0 || D < 0 || E < 0 || (E > 0 && src == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(K + E) * kTileBytes +
                         static_cast<long long>(K) * D * 8 + K * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (smem > kStaticSmem) {
    const cudaError_t attr = cudaFuncSetAttribute(
        neighbor_mix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const Mix mix = {static_cast<const int*>(idx), static_cast<const float*>(w),
                   static_cast<const float*>(self_w), src, src_ld, snaps,
                   snaps_ld, K, D, E, base, M};
  for (int first = 0; first < count; first += kMaxLeaves) {
    Leaves tab = {};
    tab.count = count - first < kMaxLeaves ? count - first : kMaxLeaves;
    long long tiles = 0;
    for (int j = 0; j < tab.count; ++j) {
      if (n[first + j] < 0 || off[first + j] < 0)
        return static_cast<int>(cudaErrorInvalidValue);
      tab.x[j] = x[first + j];
      tab.out[j] = out[first + j];
      tab.n[j] = n[first + j];
      tab.off[j] = off[first + j];
      tab.tile0[j] = static_cast<int>(tiles);
      tiles += (n[first + j] + kTile - 1) / kTile;
      if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    }
    tab.tile0[tab.count] = static_cast<int>(tiles);
    if (tiles == 0) continue;
    neighbor_mix_kernel<T><<<static_cast<unsigned>(tiles), kThreads,
                             static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(tab, mix);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // namespace

// x, out: `count` leaf pointers, each (K, n[j]) contiguous; off: each
// leaf's column offset in src and snaps rows; idx (K, D) int32, w (K, D)
// and self_w (K,) float32 on the device; src: E extra rows of stride
// src_ld (null when E == 0); snaps: the push's destination of stride
// snaps_ld (null: no push).
extern "C" int neighbor_mix_f32(
    const void* const* x, void* const* out, const long long* n,
    const long long* off, int count, const void* idx, const void* w,
    const void* self_w, int K, int D, const void* src, long long src_ld,
    int E, int base, int M, void* snaps, long long snaps_ld, int device,
    void* stream, int* launches) {
  return launch<float>(x, out, n, off, count, idx, w, self_w, K, D, src,
                       src_ld, E, base, M, snaps, snaps_ld, device, stream,
                       launches);
}

extern "C" int neighbor_mix_bf16(
    const void* const* x, void* const* out, const long long* n,
    const long long* off, int count, const void* idx, const void* w,
    const void* self_w, int K, int D, const void* src, long long src_ld,
    int E, int base, int M, void* snaps, long long snaps_ld, int device,
    void* stream, int* launches) {
  return launch<__nv_bfloat16>(x, out, n, off, count, idx, w, self_w, K, D,
                               src, src_ld, E, base, M, snaps, snaps_ld,
                               device, stream, launches);
}
