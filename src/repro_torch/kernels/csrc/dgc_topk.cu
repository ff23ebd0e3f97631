// DGC's histogram-thresholded top-s% sparsification for Hopper (sm_90a), in
// three kernels that ops.dgc_sparsify launches in order on one stream:
//
//   abs_max:        *vmax = max_i |v[i]|                         (float32)
//   abs_histogram:  hist[b] += #{i : bin(|v[i]|) == b}, with
//                   bin(a) = clamp(int(a / max(*vmax, 1e-30) * n_bins),
//                              0, n_bins - 1)
//   dgc_select:     out[i] = |v[i]| > *t ? v[i] : 0; *count += #selected
//
// Between the last two, ops.py picks the threshold t from the histogram with
// a few tensor ops on the device (kernels/dgc_topk.py); nothing goes to the
// host.
//
// Replaces the Pallas TPU kernels `_hist_fused_kernel`, `_hist_kernel` and
// `_select_kernel` in src/repro/kernels/dgc_topk.py.
//
// - `_hist_fused_kernel` runs a (2, blocks) grid: sweep 0 folds max|v| into
//   an SMEM scalar, sweep 1 bins every block against it.  That relies on the
//   TPU running its grid in order.  Hopper runs blocks in no order, so the
//   max finishes in its own launch (`abs_max`), and `abs_histogram` starts
//   after it on the same stream and reads the max through a device pointer.
//   The max is reduced as the uint32 bits of |x| (for non-negative floats the
//   bits order as the values do, and a NaN stays above every number), warp
//   shuffles then one atomicMax per block into a float the wrapper zeroed.
// - The TPU kernels bin a block with a one-hot (rows*128, n_bins) matmul-
//   friendly sum and pad the tail with zeros that land in bin 0 and are
//   subtracted afterwards.  Here each block keeps n_bins int32 counters in
//   shared memory, adds to them with shared atomics, and adds each non-zero
//   counter to the global histogram with one atomicAdd; the tail is bounded
//   by `i < n`, so no padding is counted.  Integer additions commute, so the
//   histogram is the same whatever order the blocks run in.
// - The bin must be the reference's bit for bit: one ulp in the quotient
//   moves an element across a bin edge and the threshold with it.  The
//   division is IEEE round-to-nearest (__fdiv_rn; never build with
//   --use_fast_math), the product __fmul_rn, and the float-to-int conversion
//   __float2int_rz, which saturates (and maps NaN to 0) as XLA's conversion
//   does when *vmax lies below max|v| or is floored at 1e-30.
// - `dgc_select` is gaia_select.cu's pass with an absolute threshold read
//   through a device pointer, the count reduced in the block and added with
//   one atomicAdd.
//
// Bound: bytes.  abs_max and abs_histogram each read v once (4n bytes in
// float32), dgc_select reads v and writes out (8n): 16n bytes for the whole
// sparsification, against a handful of operations an element.
//
// Plain C interface, bound with ctypes: each launcher makes `device` current,
// launches on the given stream (PyTorch's current stream) and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 8 blocks on each of the 132 SMs
constexpr int kMaxBins = 1024;    // shared-memory counters a block keeps

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

long long grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
abs_max_kernel(const T* __restrict__ v, unsigned int* __restrict__ vmax_bits,
               long long n) {
  unsigned int local = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    local = max(local, __float_as_uint(fabsf(to_f32(v[i]))));
  __shared__ unsigned int warp_max[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    local = max(local, __shfl_down_sync(0xffffffffu, local, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = local;
  __syncthreads();
  if (warp == 0) {
    local = lane < (kThreads / 32) ? warp_max[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      local = max(local, __shfl_down_sync(0xffffffffu, local, off));
    if (lane == 0 && local != 0u) atomicMax(vmax_bits, local);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
abs_histogram_kernel(const T* __restrict__ v, const float* __restrict__ vmax,
                     int* __restrict__ hist, long long n, int n_bins) {
  __shared__ int counts[kMaxBins];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  float vm = *vmax;
  if (!(isnan(vm) || vm > 1e-30f)) vm = 1e-30f;  // jnp.maximum(vmax, 1e-30)
  const float bins = (float)n_bins;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float q = __fmul_rn(__fdiv_rn(fabsf(to_f32(v[i])), vm), bins);
    int b = __float2int_rz(q);
    b = b < 0 ? 0 : (b > n_bins - 1 ? n_bins - 1 : b);
    atomicAdd(&counts[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
    if (counts[b] != 0) atomicAdd(&hist[b], counts[b]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dgc_select_kernel(const T* __restrict__ v, const float* __restrict__ threshold,
                  T* __restrict__ out, int* __restrict__ count, long long n) {
  const float t = *threshold;
  int local = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T vi = v[i];
    const bool keep = fabsf(to_f32(vi)) > t;
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
int launch_abs_max(const void* v, void* vmax, long long n, int device,
                   void* stream) {
  if (n <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  abs_max_kernel<T><<<(unsigned)grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<unsigned int*>(vmax), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_abs_histogram(const void* v, const void* vmax, void* hist,
                         long long n, int n_bins, int device, void* stream) {
  if (n_bins < 1 || n_bins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  abs_histogram_kernel<T><<<(unsigned)grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const float*>(vmax),
      static_cast<int*>(hist), n, n_bins);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dgc_select(const void* v, const void* threshold, void* out,
                      void* count, long long n, int device, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  dgc_select_kernel<T><<<(unsigned)grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const float*>(threshold),
      static_cast<T*>(out), static_cast<int*>(count), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int abs_max_f32(const void* v, void* vmax, long long n, int device,
                           void* stream) {
  return launch_abs_max<float>(v, vmax, n, device, stream);
}

extern "C" int abs_max_bf16(const void* v, void* vmax, long long n,
                            int device, void* stream) {
  return launch_abs_max<__nv_bfloat16>(v, vmax, n, device, stream);
}

extern "C" int abs_histogram_f32(const void* v, const void* vmax, void* hist,
                                 long long n, int n_bins, int device,
                                 void* stream) {
  return launch_abs_histogram<float>(v, vmax, hist, n, n_bins, device,
                                     stream);
}

extern "C" int abs_histogram_bf16(const void* v, const void* vmax, void* hist,
                                  long long n, int n_bins, int device,
                                  void* stream) {
  return launch_abs_histogram<__nv_bfloat16>(v, vmax, hist, n, n_bins, device,
                                             stream);
}

extern "C" int dgc_select_f32(const void* v, const void* threshold, void* out,
                              void* count, long long n, int device,
                              void* stream) {
  return launch_dgc_select<float>(v, threshold, out, count, n, device, stream);
}

extern "C" int dgc_select_bf16(const void* v, const void* threshold, void* out,
                               void* count, long long n, int device,
                               void* stream) {
  return launch_dgc_select<__nv_bfloat16>(v, threshold, out, count, n, device,
                                          stream);
}
