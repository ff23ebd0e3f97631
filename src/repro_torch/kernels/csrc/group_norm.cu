// GroupNorm forward over NHWC activations for Hopper (sm_90a), per sample and
// group of `group_size` adjacent channels (the paper's BatchNorm fix, §5.2):
//   mu  = mean over (h, w, j) of x[b, h, w, g*gs + j]               (float32)
//   var = mean over (h, w, j) of (x - mu)^2                         (float32)
//   y[b, h, w, c] = (x - mu) / sqrt(var + eps) * scale[c] + bias[c]
// written in x's dtype; scale and bias are float32 (C,).
//
// Replaces the Pallas TPU kernel `_gn_kernel` in
// src/repro/kernels/group_norm.py, which takes one sample's whole (H*W, C)
// tile into VMEM a grid step and reduces every group of it there.  Two
// routes, picked on the host by ops.group_norm_route from the shape and
// dtype alone:
//
// - "sample" (route 0): one block a sample, as the TPU kernel.  The block
//   copies the sample's tile into shared memory in x's dtype, 16 bytes a
//   thread where the pointers allow, so x is read from HBM once and
//   coalesced.  Each thread then sums one channel over a strided set of
//   pixels (threads on adjacent channels read adjacent shared words), the
//   partial sums of a group are added in a fixed order (no atomics: the
//   result does not depend on the schedule), and the mean is their quotient;
//   the biased variance is a second pass over the shared copy, as
//   `_gn_kernel` computes it; the third pass writes y once, 16 bytes a
//   thread.  Every GroupNorm shape of the CNN zoo is at most 32 KB a sample,
//   so a block fits one sample with room to spare.
// - "group" (route 1): one block a (sample, group), for a sample whose tile
//   outgrows a block's shared memory (about 200 KB).  The block reads the
//   group's H*W*group_size elements at stride C three times (the sum, the
//   squared deviations, the write); the later reads hit L1/L2.  A Hopper
//   thread-block cluster splitting a sample over distributed shared memory
//   would read it once, but no shape of the repo needs one.
//
// Bound: bytes.  x is read once and y written once (2 * B*H*W*C elements),
// scale and bias read once; ~8 flops an element.  Forward only, as the
// reference: it has no backward kernel.
//
// Plain C interface, bound with ctypes: the launcher makes `device` current,
// launches on the given stream (PyTorch's current stream) and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;        // the group route
constexpr int kSampleThreads = 256;  // the sample route

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

// ------------------------------------------------------------ group route

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_group_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
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

// ----------------------------------------------------------- sample route

// 16 bytes of T, the unit of a vector access
template <typename T>
struct alignas(16) Pack {
  T x[16 / sizeof(T)];
};

// Bytes of dynamic shared memory a sample-route block takes; mirrored by
// ops.group_norm_sample_smem.
template <typename T>
long long sample_smem(long long hw, int c, int group_size) {
  const long long tile = (hw * c * (long long)sizeof(T) + 15) / 16 * 16;
  const int part = c > kSampleThreads ? c : kSampleThreads;
  return tile + 4LL * (part + 2 * (c / group_size));
}

// part[r * c + ch] = sum over pixels p = r, r + rows, ... of f(tile[p, ch]),
// rows = max(1, kSampleThreads / c); returns rows.
template <typename T, typename F>
__device__ __forceinline__ int channel_sums(const T* tile, int hw, int c,
                                            float* part, F&& f) {
  const int rows = c < kSampleThreads ? kSampleThreads / c : 1;
  for (int s = threadIdx.x; s < rows * c; s += kSampleThreads) {
    const int ch = s % c;
    float acc = 0.0f;
    for (int p = s / c; p < hw; p += rows) acc += f(to_f32(tile[p * c + ch]),
                                                    ch);
    part[s] = acc;
  }
  __syncthreads();
  return rows;
}

// stat[g] = (sum over rows and the group's channels of part) / count, in a
// fixed order.
__device__ __forceinline__ void group_means(const float* part, int rows,
                                            int c, int group_size,
                                            float count, float* stat) {
  for (int g = threadIdx.x; g < c / group_size; g += kSampleThreads) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r)
      for (int j = 0; j < group_size; ++j)
        acc += part[r * c + g * group_size + j];
    stat[g] = acc / count;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kSampleThreads)
group_norm_sample_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y,
                         int hw, int c, int group_size, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kW = 16 / sizeof(T);
  const int elems = hw * c;
  const int groups = c / group_size;
  T* tile = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(
      smem + ((long long)elems * sizeof(T) + 15) / 16 * 16);
  float* mu = part + (c > kSampleThreads ? c : kSampleThreads);
  float* inv = mu + groups;
  const long long base = (long long)blockIdx.x * elems;
  const T* __restrict__ xs = x + base;
  T* __restrict__ ys = y + base;
  const bool vec = ((reinterpret_cast<unsigned long long>(xs) |
                     reinterpret_cast<unsigned long long>(ys)) & 15) == 0;
  const int nvec = vec ? elems / kW : 0;

  // 1. the sample's tile into shared memory, four 16-byte loads in flight
  // a thread
  {
    const uint4* src = reinterpret_cast<const uint4*>(xs);
    uint4* dst = reinterpret_cast<uint4*>(tile);
    for (int i0 = threadIdx.x; i0 < nvec; i0 += 4 * kSampleThreads) {
      uint4 r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kSampleThreads;
        if (i < nvec) r[k] = src[i];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kSampleThreads;
        if (i < nvec) dst[i] = r[k];
      }
    }
    for (int e = nvec * kW + threadIdx.x; e < elems; e += kSampleThreads)
      tile[e] = xs[e];
  }
  __syncthreads();

  // 2. each group's mean, then its biased variance over the shared copy
  const float count = (float)(hw * group_size);
  int rows = channel_sums(tile, hw, c, part,
                          [](float v, int) { return v; });
  group_means(part, rows, c, group_size, count, mu);
  rows = channel_sums(tile, hw, c, part, [&](float v, int ch) {
    const float d = v - mu[ch / group_size];
    return d * d;
  });
  group_means(part, rows, c, group_size, count, inv);
  for (int g = threadIdx.x; g < groups; g += kSampleThreads)
    inv[g] = 1.0f / sqrtf(inv[g] + eps);
  __syncthreads();

  // 3. y, written once
  auto norm = [&](T v, int ch) {
    const int g = ch / group_size;
    return (to_f32(v) - mu[g]) * inv[g] * scale[ch] + bias[ch];
  };
  if (vec) {
    for (int i = threadIdx.x; i < nvec; i += kSampleThreads) {
      Pack<T> o;
      int ch = (i * kW) % c;
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        store(&o.x[k], norm(tile[i * kW + k], ch));
        ch = ch + 1 == c ? 0 : ch + 1;
      }
      reinterpret_cast<Pack<T>*>(ys)[i] = o;
    }
  }
  for (int e = nvec * kW + threadIdx.x; e < elems; e += kSampleThreads)
    store(&ys[e], norm(tile[e], e % c));
}

template <typename T>
int launch(int route, const void* x, const void* scale, const void* bias,
           void* y, long long batch, long long hw, int c, int group_size,
           float eps, int device, void* stream) {
  if (group_size < 1 || c < 1 || c % group_size != 0 || batch < 0 || hw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = route == 0 ? batch : batch * (c / group_size);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0 || hw == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const long long smem = sample_smem<T>(hw, c, group_size);
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > most || hw * c > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(group_norm_sample_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    group_norm_sample_kernel<T><<<(unsigned)blocks, kSampleThreads,
                                  (size_t)smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y), (int)hw, c,
        group_size, eps);
  } else if (route == 1) {
    group_norm_group_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y), hw, c,
        group_size, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int group_norm_f32(int route, const void* x, const void* scale,
                              const void* bias, void* y, long long batch,
                              long long hw, int c, int group_size, float eps,
                              int device, void* stream) {
  return launch<float>(route, x, scale, bias, y, batch, hw, c, group_size,
                       eps, device, stream);
}

extern "C" int group_norm_bf16(int route, const void* x, const void* scale,
                               const void* bias, void* y, long long batch,
                               long long hw, int c, int group_size, float eps,
                               int device, void* stream) {
  return launch<__nv_bfloat16>(route, x, scale, bias, y, batch, hw, c,
                               group_size, eps, device, stream);
}
