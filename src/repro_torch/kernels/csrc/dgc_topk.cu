// DGC's histogram-thresholded top-s% sparsification for Hopper (sm_90a), in
// one cooperative kernel whose phases are chosen at compile time:
//
//   max:        v_max = max_i |v[i]|                            (float32)
//   histogram:  hist[b] = #{i : bin(|v[i]|) == b}, with
//               bin(a) = clamp(int(a / max(v_max, 1e-30) * n_bins),
//                          0, n_bins - 1)
//   threshold:  b* = the first bin whose float32 cumulative count reaches
//               float32(sparsity) * total, clipped to n_bins - 1;
//               t = (b* + 1) * float32(1 / n_bins) * v_max
//   select:     out[i] = |v[i]| > t ? v[i] : 0; count = #selected
//
// ops.dgc_sparsify runs all four in one launch; abs_histogram_fused runs
// max and histogram, abs_histogram the histogram against a v_max it is
// given, dgc_select the select against a threshold it is given.  The kernel
// writes every output itself (block 0 zeroes the histogram and the count),
// so no op launches a zero-fill or a tensor op around it.
//
// Replaces the Pallas TPU kernels `_hist_kernel`, `_hist_fused_kernel` and
// `_select_kernel` in src/repro/kernels/dgc_topk.py, and the threshold glue
// `threshold_from_histogram` the reference runs between them.
//
// - The TPU runs `_hist_fused_kernel`'s (2, blocks) grid in order, so sweep
//   0 can fold max|v| into a scalar that sweep 1 reads.  Hopper runs blocks
//   in no order; here the grid is co-resident (cudaLaunchCooperativeKernel,
//   at most the occupancy times the SM count) and crosses two grid-wide
//   barriers: (1) each block reduces the max of its tiles as the uint32 bits
//   of |x| (for non-negative floats the bits order as the values do, and a
//   NaN stays above every number) into a per-block slot; barrier; every
//   block reduces the slots to v_max and bins its tiles; barrier; (2) every
//   block reads the n_bins global counts and finds the threshold itself, so
//   no third barrier is needed, then selects its tiles and adds its count
//   with one atomicAdd.  The barrier is cooperative_groups' grid.sync(),
//   which needs no relocatable device code (-rdc) since CUDA 11.
// - A block of 512 threads takes contiguous tiles of 8192 elements (tile,
//   tile + grid, ...), reading 16 bytes a thread where v (and out) are
//   16-byte aligned, with a scalar tail.  At n = 2**20 that is 128 blocks,
//   one an SM: fewer blocks make each barrier and the histogram's global
//   atomics cheaper.  The histogram and select phases read the tiles
//   again from L2: v at n = 2**20 float32 is 4 MB, the L2 50 MB, so the
//   kernel reads HBM once and writes it once, the function's bound.
// - Counting: each warp keeps its own n_bins int32 counters in shared
//   memory (normal-like |v| piles into a few low bins, and warps sharing
//   counters would contend there), the block sums them and adds each
//   non-zero bin to the global histogram with one atomicAdd.  Integer
//   additions commute, so the histogram is the same whatever order the
//   blocks run in.  The TPU kernels' one-hot sums and zero padding have no
//   counterpart: the tail is bounded by `i < n`.
// - The bin must be the reference's bit for bit: one ulp in the quotient
//   moves an element across a bin edge and the threshold with it.  The
//   division is IEEE round-to-nearest (__fdiv_rn; never build with
//   --use_fast_math), the product __fmul_rn, and the float-to-int
//   conversion __float2int_rz, which saturates (and maps NaN to 0) as XLA's
//   conversion does when v_max lies below max|v| or is floored at 1e-30.
// - The threshold is the jitted reference's arithmetic, each step rounded
//   on its own (__fmul_rn, __fadd_rn, __int2float_rn), since nvcc's default
//   --fmad=true may contract a product and a sum into one rounding.  The
//   search counts the bins whose float32 cumulative count lies below the
//   target: the cumulative counts rise, so that count is searchsorted's
//   left index (dgc_topk.threshold_by_count is its plain mirror).
//
// Bound: bytes.  The function reads v once and writes out once (8n bytes in
// float32) against a dozen operations an element.
//
// Plain C interface, bound with ctypes: the launcher makes `device` current,
// launches on the given stream (PyTorch's current stream) and returns the
// cudaError_t of the launch (0 on success).  It never falls back to another
// route: a cooperative launch the card refuses returns its error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;     // elements a tile: 2**20 takes 128 blocks
constexpr int kMaxBins = 1024;  // counters a warp keeps in shared memory
static_assert(kTile % (kThreads * 8) == 0, "a tile is whole 16-byte vectors");

// phases, as the bits of the kernel's template argument and of `phases`
constexpr int kMax = 1;
constexpr int kHist = 2;
constexpr int kSelect = 4;

struct Args {
  const void* v;
  void* out;            // like v (select)
  long long n;
  int n_bins;
  float sparsity;       // rounded to float32 by the caller (threshold)
  const float* vmax_in; // histogram without max
  const float* t_in;    // select without histogram
  int* hist;            // n_bins (histogram)
  int* count;           // select
  float* t_out;         // threshold
  float* vmax_out;      // max
  unsigned int* slots;  // one per block (max)
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

// 16 bytes of T, the unit of a vector access
template <typename T>
struct alignas(16) Pack {
  T x[16 / sizeof(T)];
};

// Calls f(v[i]) for every element of the tile that starts at `base`.
template <typename T, typename F>
__device__ __forceinline__ void visit_tile(const T* __restrict__ v,
                                           long long base, long long n,
                                           bool vec, F&& f) {
  constexpr int kW = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int e = 0; e < kTile / (kThreads * kW); ++e) {
      const long long i = base + (long long)kW * (e * kThreads + threadIdx.x);
      if (i + kW <= n) {
        const Pack<T> p = *reinterpret_cast<const Pack<T>*>(v + i);
#pragma unroll
        for (int k = 0; k < kW; ++k) f(p.x[k]);
      } else {
        for (long long k = i; k < n; ++k) f(v[k]);  // the tail
      }
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < kTile / kThreads; ++e) {
      const long long i = base + e * kThreads + threadIdx.x;
      if (i < n) f(v[i]);
    }
  }
}

template <typename T>
__device__ __forceinline__ T keep(T x, float t, int* local) {
  const bool k = fabsf(to_f32(x)) > t;
  *local += k ? 1 : 0;
  return k ? x : zero<T>();
}

// Writes out = v where |v| > t else 0 over the tile at `base`; returns the
// count of this thread's selected elements.
template <typename T>
__device__ __forceinline__ int select_tile(const T* __restrict__ v,
                                           T* __restrict__ out,
                                           long long base, long long n,
                                           bool vec, float t) {
  constexpr int kW = 16 / sizeof(T);
  int local = 0;
  if (vec) {
#pragma unroll
    for (int e = 0; e < kTile / (kThreads * kW); ++e) {
      const long long i = base + (long long)kW * (e * kThreads + threadIdx.x);
      if (i + kW <= n) {
        const Pack<T> p = *reinterpret_cast<const Pack<T>*>(v + i);
        Pack<T> o;
#pragma unroll
        for (int k = 0; k < kW; ++k) o.x[k] = keep(p.x[k], t, &local);
        *reinterpret_cast<Pack<T>*>(out + i) = o;
      } else {
        for (long long k = i; k < n; ++k) out[k] = keep(v[k], t, &local);
      }
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < kTile / kThreads; ++e) {
      const long long i = base + e * kThreads + threadIdx.x;
      if (i < n) out[i] = keep(v[i], t, &local);
    }
  }
  return local;
}

// Max of `x` over the block; every thread gets it.
__device__ __forceinline__ unsigned int block_max(unsigned int x,
                                                  unsigned int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) x = max(x, scratch[w]);
  __syncthreads();  // scratch is reused by the next call
  return x;
}

// Adds the block's `local` counts into *count with one atomicAdd.
__device__ __forceinline__ void block_count_add(int local, int* count,
                                                int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
    if (total != 0) atomicAdd(count, total);
  }
}

// The threshold's bin from the histogram `h` (shared memory), in warp 0:
// the number of bins whose float32 cumulative count lies below
// float32(sparsity) * float32(total), clipped to n_bins - 1.  Each lane
// takes a run of adjacent bins; the runs' sums are scanned across the warp.
__device__ __forceinline__ int threshold_bin(const int* h, int n_bins,
                                             float sparsity) {
  const int lane = threadIdx.x & 31;
  const int per = (n_bins + 31) / 32;
  const int lo = min(lane * per, n_bins);
  const int hi = min(lo + per, n_bins);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += h[b];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const float target = __fmul_rn(sparsity, __int2float_rn(total));
  int cum = incl - sum;
  int below = 0;
  for (int b = lo; b < hi; ++b) {
    cum += h[b];
    below += __int2float_rn(cum) < target ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    below += __shfl_xor_sync(0xffffffffu, below, off);
  return below < n_bins - 1 ? below : n_bins - 1;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
dgc_topk_kernel(const Args a) {
  extern __shared__ int warp_hist[];  // kWarps x n_bins counters (kHist)
  __shared__ unsigned int red_u[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float s_t;
  cg::grid_group grid = cg::this_grid();
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ out = static_cast<T*>(a.out);
  const long long tiles = (a.n + kTile - 1) / kTile;
  const bool vec = ((reinterpret_cast<unsigned long long>(a.v) |
                     ((P & kSelect) ? reinterpret_cast<unsigned long long>(
                                          a.out) : 0ull)) & 15) == 0;

  // 1. each block's max|v|; block 0 zeroes the global accumulators
  if constexpr ((P & kMax) != 0) {
    unsigned int m = 0u;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      visit_tile(v, tile * kTile, a.n, vec, [&](T x) {
        m = max(m, __float_as_uint(fabsf(to_f32(x))));
      });
    m = block_max(m, red_u);
    if (threadIdx.x == 0) a.slots[blockIdx.x] = m;
  }
  if (blockIdx.x == 0) {
    if constexpr ((P & kHist) != 0)
      for (int b = threadIdx.x; b < a.n_bins; b += kThreads) a.hist[b] = 0;
    if constexpr ((P & kSelect) != 0)
      if (threadIdx.x == 0) *a.count = 0;
  }
  if constexpr ((P & kHist) != 0)
    for (int i = threadIdx.x; i < kWarps * a.n_bins; i += kThreads)
      warp_hist[i] = 0;
  grid.sync();

  // 2. v_max from the slots; the block's tiles binned into its warps'
  // counters, then added to the global histogram
  float v_max = 0.0f;  // max|v|, not floored
  if constexpr ((P & kMax) != 0) {
    unsigned int m = 0u;
    for (int s = threadIdx.x; s < (int)gridDim.x; s += kThreads)
      m = max(m, __ldcg(a.slots + s));
    v_max = __uint_as_float(block_max(m, red_u));
  } else if constexpr ((P & kHist) != 0) {
    v_max = *a.vmax_in;
  }
  if constexpr ((P & kHist) != 0) {
    float vm = v_max;
    if (!(isnan(vm) || vm > 1e-30f)) vm = 1e-30f;  // jnp.maximum(vmax, 1e-30)
    const float bins = (float)a.n_bins;
    const int last = a.n_bins - 1;
    int* mine = warp_hist + (threadIdx.x >> 5) * a.n_bins;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      visit_tile(v, tile * kTile, a.n, vec, [&](T x) {
        const float q = __fmul_rn(__fdiv_rn(fabsf(to_f32(x)), vm), bins);
        int b = __float2int_rz(q);
        b = b < 0 ? 0 : (b > last ? last : b);
        atomicAdd(mine + b, 1);
      });
    __syncthreads();
    for (int b = threadIdx.x; b < a.n_bins; b += kThreads) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_hist[w * a.n_bins + b];
      if (s != 0) atomicAdd(a.hist + b, s);
    }
  }

  // 3. the threshold, found by every block from the global histogram
  float t = 0.0f;
  if constexpr ((P & kSelect) != 0 && (P & kHist) != 0) {
    grid.sync();
    for (int b = threadIdx.x; b < a.n_bins; b += kThreads)
      warp_hist[b] = __ldcg(a.hist + b);
    __syncthreads();
    if (threadIdx.x < 32) {
      const int b = threshold_bin(warp_hist, a.n_bins, a.sparsity);
      if (threadIdx.x == 0) {
        const float inv = __fdiv_rn(1.0f, (float)a.n_bins);
        s_t = __fmul_rn(__fmul_rn(__fadd_rn((float)b, 1.0f), inv), v_max);
      }
    }
    __syncthreads();
    t = s_t;
  } else if constexpr ((P & kSelect) != 0) {
    t = *a.t_in;
  }

  // 4. the select, one atomicAdd of the count a block
  if constexpr ((P & kSelect) != 0) {
    int local = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      local += select_tile(v, out, tile * kTile, a.n, vec, t);
    block_count_add(local, a.count, red_i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if constexpr ((P & kMax) != 0) *a.vmax_out = v_max;
    if constexpr ((P & kSelect) != 0 && (P & kHist) != 0) *a.t_out = t;
  }
}

template <typename T, int P>
int launch(const Args& a, int slots_cap, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const void* fn = reinterpret_cast<const void*>(&dgc_topk_kernel<T, P>);
  const size_t smem = (P & kHist) ? sizeof(int) * kWarps * a.n_bins : 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {  // up to 64 KB at 1024 bins
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dgc_topk_kernel<T, P>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = (a.n + kTile - 1) / kTile;
  const long long resident = (long long)per_sm * sms;
  if (grid > resident) grid = resident;
  if (grid > slots_cap) grid = slots_cap;
  if (grid < 1) grid = 1;  // an empty v still writes its outputs
  if (grid > resident)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)),
                                    dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// work (int32): hist[n_bins], count, t (float32 bits), v_max (float32
// bits), then `slots_cap` per-block slots
template <typename T>
int dgc_topk(int phases, const void* v, void* out, long long n, int n_bins,
             float sparsity, const void* vmax_in, const void* t_in,
             void* work, int slots_cap, int device, void* stream) {
  if (n < 0 || n_bins < 1 || n_bins > kMaxBins || slots_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int* w = static_cast<int*>(work);
  Args a;
  a.v = v;
  a.out = out;
  a.n = n;
  a.n_bins = n_bins;
  a.sparsity = sparsity;
  a.vmax_in = static_cast<const float*>(vmax_in);
  a.t_in = static_cast<const float*>(t_in);
  a.hist = w;
  a.count = w + n_bins;
  a.t_out = reinterpret_cast<float*>(w + n_bins + 1);
  a.vmax_out = reinterpret_cast<float*>(w + n_bins + 2);
  a.slots = reinterpret_cast<unsigned int*>(w + n_bins + 3);
  switch (phases) {
    case kMax | kHist | kSelect:
      return launch<T, kMax | kHist | kSelect>(a, slots_cap, device, stream);
    case kMax | kHist:
      return launch<T, kMax | kHist>(a, slots_cap, device, stream);
    case kHist:
      return launch<T, kHist>(a, slots_cap, device, stream);
    case kSelect:
      return launch<T, kSelect>(a, slots_cap, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int dgc_topk_f32(int phases, const void* v, void* out,
                            long long n, int n_bins, float sparsity,
                            const void* vmax_in, const void* t_in, void* work,
                            int slots_cap, int device, void* stream) {
  return dgc_topk<float>(phases, v, out, n, n_bins, sparsity, vmax_in, t_in,
                         work, slots_cap, device, stream);
}

extern "C" int dgc_topk_bf16(int phases, const void* v, void* out,
                             long long n, int n_bins, float sparsity,
                             const void* vmax_in, const void* t_in,
                             void* work, int slots_cap, int device,
                             void* stream) {
  return dgc_topk<__nv_bfloat16>(phases, v, out, n, n_bins, sparsity,
                                 vmax_in, t_in, work, slots_cap, device,
                                 stream);
}
