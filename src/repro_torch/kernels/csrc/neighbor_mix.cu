// D-PSGD's and AD-PSGD's sparse gossip averaging for Hopper (sm_90a):
//   y[k, c] = sw[k] * x[k, c] + sum_d w[k, d] * src[idx[k, d], c]
// over padded (K, D) neighbor lists (idx padded with the node's own index,
// w padded with 0), accumulated in float32 and written in x's dtype.
// D-PSGD gathers its neighbours from x itself (src = x, M = K); AD-PSGD
// gathers them from its flattened ((S + 1) * K, N) snapshot buffer, with
// idx = staleness * K + neighbour (src = snapshots, M = (S + 1) * K).
//
// Replaces the Pallas TPU kernels `_mix_kernel` and `_mix_src_kernel` in
// src/repro/kernels/neighbor_mix.py.  The TPU versions stream (K, rows, 128)
// (and (M, rows, 128)) column blocks through VMEM with the k/d loops
// unrolled over the static (K, D) shape.  Here one body serves both: one
// thread owns one (k, column) output, the grid is (column blocks, K), K, D
// and M are runtime ints, and idx, w and sw are device pointers, so a
// schedule that changes the graph every round, or a staleness rung that
// moves, changes only operand values and never rebuilds anything.
//
// Bound: bytes.  The mix reads x once, the src rows that idx names once,
// and writes y once, for 2 * (D + 1) flops per output.  Threads of a warp
// read neighbouring columns of the same row, so every load is coalesced;
// a src row that several nodes read comes from L2 after the first.
// An index outside [0, M) contributes nothing.  That guard is memory
// safety only: `ops.neighbor_mix` refuses such an index before it launches,
// as the CPU route does.
//
// Plain C interface, bound with ctypes: each launcher makes `device` current,
// launches on the given stream (PyTorch's current stream) and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
neighbor_mix_kernel(const T* __restrict__ x, const T* __restrict__ src,
                    const int* __restrict__ idx, const float* __restrict__ w,
                    const float* __restrict__ self_w, T* __restrict__ out,
                    int K, int D, int M, long long N) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (col >= N) return;
  float acc = self_w[k] * to_f32(x[(long long)k * N + col]);
  for (int d = 0; d < D; ++d) {
    const int j = idx[k * D + d];
    if (j >= 0 && j < M)
      acc += w[k * D + d] * to_f32(src[(long long)j * N + col]);
  }
  out[(long long)k * N + col] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const void* src, const void* idx, const void* w,
           const void* self_w, void* out, int K, int D, int M, long long N,
           int device, void* stream) {
  if (K <= 0 || N <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)K);
  neighbor_mix_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(src),
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(self_w), static_cast<T*>(out), K, D, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Neighbour rows from x itself: D-PSGD.
extern "C" int neighbor_mix_f32(const void* x, const void* idx, const void* w,
                                const void* self_w, void* out, int K, int D,
                                long long N, int device, void* stream) {
  return launch<float>(x, x, idx, w, self_w, out, K, D, K, N, device, stream);
}

extern "C" int neighbor_mix_bf16(const void* x, const void* idx,
                                 const void* w, const void* self_w, void* out,
                                 int K, int D, long long N, int device,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, x, idx, w, self_w, out, K, D, K, N, device,
                               stream);
}

// Neighbour rows from src (M, N), self term from x (K, N): AD-PSGD.
extern "C" int neighbor_mix_src_f32(const void* x, const void* src,
                                    const void* idx, const void* w,
                                    const void* self_w, void* out, int K,
                                    int D, int M, long long N, int device,
                                    void* stream) {
  return launch<float>(x, src, idx, w, self_w, out, K, D, M, N, device,
                       stream);
}

extern "C" int neighbor_mix_src_bf16(const void* x, const void* src,
                                     const void* idx, const void* w,
                                     const void* self_w, void* out, int K,
                                     int D, int M, long long N, int device,
                                     void* stream) {
  return launch<__nv_bfloat16>(x, src, idx, w, self_w, out, K, D, M, N,
                               device, stream);
}
