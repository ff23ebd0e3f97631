// Gaia's significance filter (Algorithm 1, line 8) for Hopper (sm_90a), over
// a list of tensors in one launch:
//   out_j[i] = |v_j[i]| > t * |w_j[i]| ? v_j[i] : 0      (compared in float32)
//   count_j += number of selected entries of tensor j
//
// Replaces the Pallas TPU kernel `_gaia_kernel` in
// src/repro/kernels/gaia_select.py.  The TPU version lays one tensor out as
// (rows, 128) VMEM tiles, pads w with 1 so the tail never selects, and
// writes one partial count per grid step for the caller to sum; the caller
// runs it once per parameter tensor.  Here one launch covers every tensor of
// a step (16 for GN-LeNet): the tensors' pointers and sizes go to the kernel
// by value in a table (no host-to-device copy, though they change every
// step), each block owns one 2048-element tile of one tensor, found from the
// table's per-tensor first-tile prefix, and tiles never straddle tensors, so
// the block's count (warp shuffles, then one warp over the per-warp sums)
// goes with one atomicAdd into that tensor's int32 count, zeroed by the
// wrapper.  In float32 each thread moves 16 bytes at a time where the
// tensor's three pointers are 16-byte aligned, with a scalar tail past the
// last whole vector; otherwise (and in bfloat16) one element at a time.
// More tensors than a table holds take one launch per table.  v and w may
// differ in dtype: the float32-v, bfloat16-w instance reads a bf16 model's
// weights as they lie against its float32 accumulated update (LM training's
// Gaia step), where one dtype would need a float32 copy of the weights.
//
// Bound: bytes.  Each element reads v and w and writes out (3 * n * 4 bytes
// in float32) for 3 flops, far below the card's ops-per-byte line.  At
// GN-LeNet's K = 5 step (483,410 floats in 16 tensors) that is 1.7 us at
// 3.35 TB/s: the launch itself is the cost, hence one launch a step.
//
// Plain C interface, bound with ctypes: each launcher makes `device` current,
// launches on the given stream (PyTorch's current stream), writes the number
// of launches it made to *launches and returns the cudaError_t of the last
// launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // elements a block
constexpr int kMaxTensors = 32;               // tensors a launch

// The tensors of one launch, passed by value.
struct Table {
  const void* v[kMaxTensors];
  const void* w[kMaxTensors];
  void* out[kMaxTensors];
  long long n[kMaxTensors];
  int tile0[kMaxTensors + 1];  // first block of each tensor; then the grid
  int count;                   // tensors in the table
};

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

template <typename T, typename TW>
__device__ __forceinline__ T select(T vi, TW wi, float t, int* local) {
  const bool keep = fabsf(to_f32(vi)) > t * fabsf(to_f32(wi));
  *local += keep ? 1 : 0;
  return keep ? vi : zero<T>();
}

// The tensor whose tiles hold this block (tensors of no tile are passed by).
__device__ __forceinline__ int tensor_of_block(const Table& tab) {
  int j = 0;
  while (j + 1 < tab.count && static_cast<int>(blockIdx.x) >= tab.tile0[j + 1])
    ++j;
  return j;
}

// Adds the block's `local` counts into *count: shuffle within each warp,
// then warp 0 sums the warps, one atomicAdd.
__device__ __forceinline__ void block_count_add(int local, int* count) {
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

// T: v's and out's dtype; TW: w's.
template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
gaia_select_kernel(const Table tab, const float* __restrict__ threshold,
                   int* __restrict__ counts) {
  const int j = tensor_of_block(tab);
  const T* __restrict__ v = static_cast<const T*>(tab.v[j]);
  const TW* __restrict__ w = static_cast<const TW*>(tab.w[j]);
  T* __restrict__ out = static_cast<T*>(tab.out[j]);
  const long long n = tab.n[j];
  const long long base =
      static_cast<long long>(blockIdx.x - tab.tile0[j]) * kTile;
  const float t = *threshold;
  int local = 0;
  bool vec = false;
  if constexpr (std::is_same<T, float>::value &&
                std::is_same<TW, float>::value)
    vec = ((reinterpret_cast<unsigned long long>(v) |
            reinterpret_cast<unsigned long long>(w) |
            reinterpret_cast<unsigned long long>(out)) & 15) == 0;
  if (vec) {
#pragma unroll
    for (int e = 0; e < kPerThread / 4; ++e) {
      const long long i = base + 4LL * (e * kThreads + threadIdx.x);
      if (i + 4 <= n) {
        const float4 a = *reinterpret_cast<const float4*>(v + i);
        const float4 b = *reinterpret_cast<const float4*>(w + i);
        float4 o;
        o.x = select(a.x, b.x, t, &local);
        o.y = select(a.y, b.y, t, &local);
        o.z = select(a.z, b.z, t, &local);
        o.w = select(a.w, b.w, t, &local);
        *reinterpret_cast<float4*>(out + i) = o;
      } else {
        for (long long k = i; k < n; ++k)  // the tail: at most 3 elements
          out[k] = select(v[k], w[k], t, &local);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long i = base + e * kThreads + threadIdx.x;
      if (i < n) out[i] = select(v[i], w[i], t, &local);
    }
  }
  block_count_add(local, counts + j);
}

template <typename T, typename TW>
int launch(const void* const* v, const void* const* w, void* const* out,
           const long long* n, int count, const void* threshold,
           void* counts, int device, void* stream, int* launches) {
  *launches = 0;
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  for (int first = 0; first < count; first += kMaxTensors) {
    Table tab = {};
    tab.count = count - first < kMaxTensors ? count - first : kMaxTensors;
    long long tiles = 0;
    for (int j = 0; j < tab.count; ++j) {
      if (n[first + j] < 0) return static_cast<int>(cudaErrorInvalidValue);
      tab.v[j] = v[first + j];
      tab.w[j] = w[first + j];
      tab.out[j] = out[first + j];
      tab.n[j] = n[first + j];
      tab.tile0[j] = static_cast<int>(tiles);
      tiles += (n[first + j] + kTile - 1) / kTile;
      if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    }
    tab.tile0[tab.count] = static_cast<int>(tiles);
    if (tiles == 0) continue;
    gaia_select_kernel<T, TW><<<static_cast<unsigned>(tiles), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        tab, static_cast<const float*>(threshold),
        static_cast<int*>(counts) + first);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // namespace

// v, w, out: `count` pointers each; n: their element counts; threshold: a
// float32 on the device; counts: `count` zeroed int32 on the device.
extern "C" int gaia_select_f32(const void* const* v, const void* const* w,
                               void* const* out, const long long* n,
                               int count, const void* threshold, void* counts,
                               int device, void* stream, int* launches) {
  return launch<float, float>(v, w, out, n, count, threshold, counts,
                              device, stream, launches);
}

extern "C" int gaia_select_bf16(const void* const* v, const void* const* w,
                                void* const* out, const long long* n,
                                int count, const void* threshold,
                                void* counts, int device, void* stream,
                                int* launches) {
  return launch<__nv_bfloat16, __nv_bfloat16>(v, w, out, n, count,
                                              threshold, counts, device,
                                              stream, launches);
}

// v and out float32, w bfloat16.
extern "C" int gaia_select_f32_bf16(const void* const* v,
                                    const void* const* w, void* const* out,
                                    const long long* n, int count,
                                    const void* threshold, void* counts,
                                    int device, void* stream,
                                    int* launches) {
  return launch<float, __nv_bfloat16>(v, w, out, n, count, threshold,
                                      counts, device, stream, launches);
}
