// GroupNorm forward over NHWC activations for Hopper (sm_90a), per sample and
// group of `group_size` adjacent channels (the paper's BatchNorm fix, §5.2):
//   mu  = mean over (h, w, j) of x[b, h, w, g*gs + j]               (float32)
//   var = mean over (h, w, j) of (x - mu)^2                         (float32)
//   y[b, h, w, c] = (x - mu) / sqrt(var + eps) * scale[c] + bias[c]
// written in x's dtype; scale and bias are float32 (C,).
//
// Replaces the Pallas TPU kernel `_gn_kernel` in
// src/repro/kernels/group_norm.py.  The TPU version takes one sample's whole
// (H*W, C) tile into VMEM a grid step and reduces every group of it there.
// Here one block takes one (sample, group): B*G blocks, enough to fill the
// card at the shapes GroupNorm runs at (many samples, small feature maps).
// The block reads the group's H*W*group_size elements at stride C (group_size
// adjacent channels a pixel) three times: the sum for the mean, the sum of
// squared deviations for the variance (two passes, as `_gn_kernel` computes
// them), and the normalise-and-affine pass that writes y.  The later reads
// hit L1/L2, since a group is at most a few hundred KB.  Forward only, as the
// reference: it has no backward kernel.
//
// Bound: bytes.  x is read once and y written once (2 * B*H*W*C elements),
// scale and bias read once; ~8 flops an element.  The strided reads of
// group_size adjacent channels use a fraction of each 32-byte sector, so this
// first version is far from the bound at small group_size; a block over whole
// pixels (all groups of a row of pixels) would read x coalesced.
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
__device__ __forceinline__ void store(float* p, float y) { *p = y; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float y) {
  *p = __float2bfloat16(y);  // round to nearest even, as torch's .to()
}

// Sum of `x` over the block; every thread gets the result.
__device__ float block_sum(float x, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (kThreads / 32) ? scratch[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) scratch[0] = x;
  }
  __syncthreads();
  const float total = scratch[0];
  __syncthreads();  // scratch is reused by the next call
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  long long hw, int c, int group_size, float eps) {
  __shared__ float scratch[kThreads / 32];
  const int groups = c / group_size;
  const long long b = blockIdx.x / groups;
  const int c0 = (int)(blockIdx.x % groups) * group_size;
  const long long base = b * hw * c + c0;
  const long long count = hw * group_size;
  // element e of the group: pixel e / group_size, channel c0 + e % group_size
  auto at = [&](long long e) {
    return base + (e / group_size) * c + (e % group_size);
  };

  float s = 0.0f;
  for (long long e = threadIdx.x; e < count; e += blockDim.x)
    s += to_f32(x[at(e)]);
  const float mu = block_sum(s, scratch) / (float)count;

  float ss = 0.0f;
  for (long long e = threadIdx.x; e < count; e += blockDim.x) {
    const float d = to_f32(x[at(e)]) - mu;
    ss += d * d;
  }
  const float var = block_sum(ss, scratch) / (float)count;
  const float inv = 1.0f / sqrtf(var + eps);

  for (long long e = threadIdx.x; e < count; e += blockDim.x) {
    const long long i = at(e);
    const int ch = c0 + (int)(e % group_size);
    store(&y[i], (to_f32(x[i]) - mu) * inv * scale[ch] + bias[ch]);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           long long batch, long long hw, int c, int group_size, float eps,
           int device, void* stream) {
  if (group_size < 1 || c % group_size != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = batch * (c / group_size);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0 || hw == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  group_norm_kernel<T><<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), hw, c, group_size,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int group_norm_f32(const void* x, const void* scale,
                              const void* bias, void* y, long long batch,
                              long long hw, int c, int group_size, float eps,
                              int device, void* stream) {
  return launch<float>(x, scale, bias, y, batch, hw, c, group_size, eps,
                       device, stream);
}

extern "C" int group_norm_bf16(const void* x, const void* scale,
                               const void* bias, void* y, long long batch,
                               long long hw, int c, int group_size, float eps,
                               int device, void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, y, batch, hw, c, group_size,
                               eps, device, stream);
}
