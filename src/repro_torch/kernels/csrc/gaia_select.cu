// Gaia's significance filter (Algorithm 1, line 8) for Hopper (sm_90a):
//   out[i] = |v[i]| > t * |w[i]| ? v[i] : 0      (compared in float32)
//   *count += number of selected entries
//
// Replaces the Pallas TPU kernel `_gaia_kernel` in
// src/repro/kernels/gaia_select.py.  The TPU version lays the tensor out as
// (rows, 128) VMEM tiles, pads w with 1 so the tail never selects, and
// writes one partial count per grid step for the caller to sum.  Here one
// grid-stride pass covers the flat n elements, the tail is bounded by
// `i < n` (no padding copy), and the count is reduced inside each block
// (warp shuffles, then one warp over the per-warp sums) and added with one
// atomicAdd per block into an int32 the wrapper zeroed.
//
// Bound: bytes.  Each element reads v and w and writes out (3 * n * 4 bytes
// in float32) for 3 flops, far below the card's ops-per-byte line; the
// design keeps to one coalesced pass and no extra buffers.
//
// Plain C interface, bound with ctypes: each launcher makes `device` current,
// launches on the given stream (PyTorch's current stream) and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 8 blocks on each of the 132 SMs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gaia_select_kernel(const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ threshold, T* __restrict__ out,
                   int* __restrict__ count, long long n) {
  const float t = *threshold;
  int local = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T vi = v[i];
    const bool keep = fabsf(to_f32(vi)) > t * fabsf(to_f32(w[i]));
    out[i] = keep ? vi : zero<T>();
    local += keep ? 1 : 0;
  }
  // block-wide count: shuffle within each warp, then warp 0 sums the warps
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  if (warp == 0) {
    local = lane < (kThreads / 32) ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if (lane == 0 && local != 0) atomicAdd(count, local);
  }
}

template <typename T>
int launch(const void* v, const void* w, const void* threshold, void* out,
           void* count, long long n, int device, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gaia_select_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(threshold), static_cast<T*>(out),
      static_cast<int*>(count), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gaia_select_f32(const void* v, const void* w,
                               const void* threshold, void* out, void* count,
                               long long n, int device, void* stream) {
  return launch<float>(v, w, threshold, out, count, n, device, stream);
}

extern "C" int gaia_select_bf16(const void* v, const void* w,
                                const void* threshold, void* out, void* count,
                                long long n, int device, void* stream) {
  return launch<__nv_bfloat16>(v, w, threshold, out, count, n, device,
                               stream);
}
