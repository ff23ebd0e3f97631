// DGC's seeded rand-k sparsification for Hopper (sm_90a):
//   out[i] = uniform01(seed, i) < keep_prob ? v[i] : 0   (compared in float32)
//   *count += number of kept entries
// where uniform01(seed, i) = (lowbias32(i ^ (seed * 0x9E3779B9)) >> 8) * 2^-24,
// all in uint32 arithmetic, bit-equal to src/repro_torch/kernels/rng.py.
//
// Replaces the Pallas TPU kernel `_randk_kernel` in
// src/repro/kernels/dgc_topk.py.  The TPU version lays the tensor out as
// (rows, 128) VMEM tiles padded up to whole blocks, builds the flat index
// of each lane from two iotas, masks the padding with `idx < n`, and writes
// one partial count per grid step.  Here one grid-stride pass covers the
// flat n elements, the tail is bounded by `i < n` (no padded copy), the
// hash runs in uint32 registers (no random array is materialised), and the
// count is reduced inside each block (warp shuffles, then one warp over the
// per-warp sums) and added with one atomicAdd per block into an int32 the
// wrapper zeroed.  `seed` and `keep_prob` come by value, so a per-leaf,
// per-step seed costs no host-to-device copy.
//
// Bound: bytes.  Each element reads v and writes out (2 * n * 4 bytes in
// float32); the hash is ~12 integer operations per element, under a fifth
// of the time the bytes take at the card's integer rate.
//
// Plain C interface, bound with ctypes: each launcher makes `device` current,
// launches on the given stream (PyTorch's current stream) and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 8 blocks on each of the 132 SMs

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// lowbias32: full-avalanche 32-bit hash (Wellons)
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rand_k_select_kernel(const T* __restrict__ v, T* __restrict__ out,
                     int* __restrict__ count, long long n, uint32_t key,
                     float keep_prob) {
  int local = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // the counter is the flat index taken modulo 2^32, as the uint32 cast
    // of the reference's int32 iota
    const uint32_t bits = lowbias32((uint32_t)i ^ key);
    const float u = (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
    const bool keep = u < keep_prob;
    out[i] = keep ? v[i] : zero<T>();
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
int launch(const void* v, void* out, void* count, long long n,
           unsigned int seed, float keep_prob, int device, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const uint32_t key = (uint32_t)seed * 0x9E3779B9u;  // stream-key spreading
  rand_k_select_kernel<T><<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<int*>(count), n, key, keep_prob);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rand_k_select_f32(const void* v, void* out, void* count,
                                 long long n, unsigned int seed,
                                 float keep_prob, int device, void* stream) {
  return launch<float>(v, out, count, n, seed, keep_prob, device, stream);
}

extern "C" int rand_k_select_bf16(const void* v, void* out, void* count,
                                  long long n, unsigned int seed,
                                  float keep_prob, int device, void* stream) {
  return launch<__nv_bfloat16>(v, out, count, n, seed, keep_prob, device,
                               stream);
}
