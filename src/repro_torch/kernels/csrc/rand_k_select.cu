// DGC's seeded rand-k sparsification for Hopper (sm_90a), over a list of
// tensors in one launch.  For element i of tensor j:
//   keep        = uniform01(seed_j, c_j(i)) < keep_prob        (in float32)
//   shared_j[i] = keep ? acc_j[i] : 0
//   new_vel_j[i] = vel_j[i] - (keep ? vel_j[i] : 0)     (when vel_j is given)
//   count_j    += number of kept entries of acc_j
// where uniform01(seed, c) = (lowbias32(c ^ (seed * 0x9E3779B9)) >> 8) * 2^-24,
// all in uint32 arithmetic, bit-equal to src/repro_torch/kernels/rng.py, and
// the counter c_j(i) is the flat index, in the reference's layout, of the
// element at flat index i of this (port's) layout, taken modulo 2^32.
//
// Replaces the Pallas TPU kernel `_randk_kernel` in
// src/repro/kernels/dgc_topk.py.  The TPU version lays one tensor out as
// (rows, 128) VMEM tiles padded up to whole blocks, builds the flat index of
// each lane from two iotas, masks the padding with `idx < n`, and writes one
// partial count per grid step; DGC calls it twice per parameter tensor (v
// and u, same seed), on tensors already in the reference's layout.  Here one
// launch covers acc and vel of every tensor of a step (16 for GN-LeNet):
// - the table of tensors (pointers, sizes, key, counter layout, first tile)
//   goes to the kernel by value, so the per-step pointers and seeds need no
//   host-to-device copy;
// - each block owns one 2048-element tile of one tensor, found from the
//   table's first-tile prefix; tiles never straddle tensors, so the block's
//   count (warp shuffles, then one warp over the warp sums) goes with one
//   atomicAdd into that tensor's int32 count, zeroed by the wrapper;
// - the hash runs in uint32 registers once per element and masks acc and
//   vel together (no random array, no mask is materialised);
// - a tensor the port keeps in another layout than the reference (a conv
//   weight, OIHW against HWIO) is read where it lies: the kernel splits i
//   into the port's dims and sums each index times that dim's stride in
//   the reference's flat layout (uint32, so modulo 2^32), in place of
//   permuted copies into the reference's layout and back;
// - new_vel is written as the literal vel - (keep ? vel : 0), so it is
//   bit-equal to the plain version's vel - select(vel), signed zeros
//   included;
// - in float32 each thread moves 16 bytes at a time where the tensor's
//   pointers are 16-byte aligned, with a scalar tail; otherwise (and in
//   bfloat16) one element at a time.
// More tensors than a table holds take one launch per table.
//
// Bound: bytes.  Each element reads acc and vel and writes shared and
// new_vel (4 * n * 4 bytes in float32); the hash is ~12 integer operations
// an element and a permuted tensor's counter a few integer divisions more,
// under the time of the bytes at the card's integer rate.  At GN-LeNet's
// K = 5 step (483,410 floats in 16 tensors) the bytes take 2.3 us at
// 3.35 TB/s: the launch itself is the cost, hence one launch a step.
//
// Plain C interface, bound with ctypes: each launcher makes `device` current,
// launches on the given stream (PyTorch's current stream), writes the number
// of launches it made to *launches and returns the cudaError_t of the last
// launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // elements a block
constexpr int kMaxTensors = 32;               // tensors a launch
constexpr int kMaxDims = 5;                   // the node axis and 4 of a conv

// The tensors of one launch, passed by value.  dims[j] = 0: the counter is
// the flat index; else size[j][0..dims) are the port's dims, outermost
// first, and cstride[j][d] is dim d's stride in the reference's flat index.
struct Table {
  const void* acc[kMaxTensors];
  const void* vel[kMaxTensors];  // null: acc only
  void* shared[kMaxTensors];
  void* new_vel[kMaxTensors];
  long long n[kMaxTensors];
  uint32_t key[kMaxTensors];     // seed * 0x9E3779B9
  int dims[kMaxTensors];
  uint32_t size[kMaxTensors][kMaxDims];
  uint32_t cstride[kMaxTensors][kMaxDims];
  int tile0[kMaxTensors + 1];    // first block of each tensor; then the grid
  int count;                     // tensors in the table
};

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
  return __float2bfloat16(x);
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

// One tensor's counter layout, in registers.
struct Counter {
  int dims;
  uint32_t size[kMaxDims];
  uint32_t cstride[kMaxDims];

  __device__ __forceinline__ uint32_t at(long long i) const {
    if (dims == 0) return static_cast<uint32_t>(i);  // the uint32 iota
    uint32_t rem = static_cast<uint32_t>(i), c = 0;
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {  // innermost first
      if (d < dims) {
        const uint32_t s = size[d];
        c += (rem % s) * cstride[d];
        rem /= s;
      }
    }
    return c;
  }
};

template <typename T>
struct Tensor {
  const T* __restrict__ acc;
  const T* __restrict__ vel;
  T* __restrict__ shared;
  T* __restrict__ new_vel;
  uint32_t key;
  float keep_prob;

  // Whether the element of counter c is kept.
  __device__ __forceinline__ bool kept(uint32_t c) const {
    const uint32_t bits = lowbias32(c ^ key);
    const float u = (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
    return u < keep_prob;
  }

  // Element i, whose counter is c; returns 1 when kept.
  __device__ __forceinline__ int apply(long long i, uint32_t c) const {
    const bool keep = kept(c);
    shared[i] = keep ? acc[i] : from_f32<T>(0.0f);
    if (vel != nullptr) {
      const float x = to_f32(vel[i]);
      new_vel[i] = from_f32<T>(x - (keep ? x : 0.0f));
    }
    return keep ? 1 : 0;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rand_k_select_kernel(const Table tab, float keep_prob,
                     int* __restrict__ counts) {
  const int j = tensor_of_block(tab);
  const Tensor<T> ten{static_cast<const T*>(tab.acc[j]),
                      static_cast<const T*>(tab.vel[j]),
                      static_cast<T*>(tab.shared[j]),
                      static_cast<T*>(tab.new_vel[j]), tab.key[j], keep_prob};
  Counter ctr;
  ctr.dims = tab.dims[j];
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    ctr.size[d] = tab.size[j][d];
    ctr.cstride[d] = tab.cstride[j][d];
  }
  const long long n = tab.n[j];
  const long long base =
      static_cast<long long>(blockIdx.x - tab.tile0[j]) * kTile;
  int local = 0;
  bool vec = false;
  if constexpr (std::is_same<T, float>::value)
    vec = ((reinterpret_cast<unsigned long long>(ten.acc) |
            reinterpret_cast<unsigned long long>(ten.vel) |
            reinterpret_cast<unsigned long long>(ten.shared) |
            reinterpret_cast<unsigned long long>(ten.new_vel)) & 15) == 0;
  if (vec) {
#pragma unroll
    for (int e = 0; e < kPerThread / 4; ++e) {
      const long long i = base + 4LL * (e * kThreads + threadIdx.x);
      if (i + 4 <= n) {
        bool k[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          k[c] = ten.kept(ctr.at(i + c));
          local += k[c] ? 1 : 0;
        }
        const float4 a = *reinterpret_cast<const float4*>(ten.acc + i);
        *reinterpret_cast<float4*>(ten.shared + i) =
            make_float4(k[0] ? a.x : 0.0f, k[1] ? a.y : 0.0f,
                        k[2] ? a.z : 0.0f, k[3] ? a.w : 0.0f);
        if (ten.vel != nullptr) {
          const float4 x = *reinterpret_cast<const float4*>(ten.vel + i);
          *reinterpret_cast<float4*>(ten.new_vel + i) = make_float4(
              x.x - (k[0] ? x.x : 0.0f), x.y - (k[1] ? x.y : 0.0f),
              x.z - (k[2] ? x.z : 0.0f), x.w - (k[3] ? x.w : 0.0f));
        }
      } else {
        for (long long c = i; c < n; ++c)  // the tail: at most 3 elements
          local += ten.apply(c, ctr.at(c));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long i = base + e * kThreads + threadIdx.x;
      if (i < n) local += ten.apply(i, ctr.at(i));
    }
  }
  block_count_add(local, counts + j);
}

template <typename T>
int launch(const void* const* acc, const void* const* vel,
           void* const* shared, void* const* new_vel, const long long* n,
           const unsigned* seeds, const int* dims, const unsigned* sizes,
           const unsigned* cstrides, int count, float keep_prob,
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
      const int g = first + j;
      if (n[g] < 0 || dims[g] < 0 || dims[g] > kMaxDims)
        return static_cast<int>(cudaErrorInvalidValue);
      tab.acc[j] = acc[g];
      tab.vel[j] = vel[g];
      tab.shared[j] = shared[g];
      tab.new_vel[j] = new_vel[g];
      tab.n[j] = n[g];
      tab.key[j] = static_cast<uint32_t>(seeds[g]) * 0x9E3779B9u;  // spread
      tab.dims[j] = dims[g];
      for (int d = 0; d < kMaxDims; ++d) {
        tab.size[j][d] = sizes[g * kMaxDims + d];
        tab.cstride[j][d] = cstrides[g * kMaxDims + d];
        if (d < dims[g] && tab.size[j][d] == 0)
          return static_cast<int>(cudaErrorInvalidValue);
      }
      tab.tile0[j] = static_cast<int>(tiles);
      tiles += (n[g] + kTile - 1) / kTile;
      if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    }
    tab.tile0[tab.count] = static_cast<int>(tiles);
    if (tiles == 0) continue;
    rand_k_select_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        tab, keep_prob, static_cast<int*>(counts) + first);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // namespace

// acc, vel, shared, new_vel: `count` pointers each (vel and new_vel null
// where only acc is masked); n: the element counts; seeds: one per tensor;
// dims, sizes and cstrides: each tensor's counter layout as in Table, the
// sizes and strides `count` rows of 5; counts: `count` zeroed int32 on the
// device.
extern "C" int rand_k_select_f32(const void* const* acc,
                                 const void* const* vel, void* const* shared,
                                 void* const* new_vel, const long long* n,
                                 const unsigned* seeds, const int* dims,
                                 const unsigned* sizes,
                                 const unsigned* cstrides, int count,
                                 float keep_prob, void* counts, int device,
                                 void* stream, int* launches) {
  return launch<float>(acc, vel, shared, new_vel, n, seeds, dims, sizes,
                       cstrides, count, keep_prob, counts, device, stream,
                       launches);
}

extern "C" int rand_k_select_bf16(const void* const* acc,
                                  const void* const* vel, void* const* shared,
                                  void* const* new_vel, const long long* n,
                                  const unsigned* seeds, const int* dims,
                                  const unsigned* sizes,
                                  const unsigned* cstrides, int count,
                                  float keep_prob, void* counts, int device,
                                  void* stream, int* launches) {
  return launch<__nv_bfloat16>(acc, vel, shared, new_vel, n, seeds, dims,
                               sizes, cstrides, count, keep_prob, counts,
                               device, stream, launches);
}
