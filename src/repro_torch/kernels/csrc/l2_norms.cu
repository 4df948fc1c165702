// K3: segmented row L2 norms (the DBench probe), for Hopper (sm_90a).
//
// Replaces the TPU kernel l2_norms of src/repro/kernels/stats.py.  That
// kernel walks a sequential grid and carries the running sum in SMEM
// scratch from one grid step to the next; blocks on a GPU run in parallel
// and in no order, so nothing carries over between them.  Instead:
//
//   pass 1: block (t, r) reduces tile t of row r (a fixed range of columns
//           inside one segment) to one float32 partial sum of squares,
//           through a fixed shuffle tree;
//   pass 2: block (s, r) adds the partials of segment s through the same
//           fixed tree and writes sqrt(sum) to out[r, s].
//
// Both passes run in a fixed order, so the result is deterministic and no
// float atomics are used.  Segments are column ranges of an (R, P) matrix
// given by an offsets table, so the port's flat (G, P) parameter buffer
// yields the per-leaf norms (G, n_leaves) directly, with no padded (R, Pmax)
// copy; a plain (R, P) matrix is the one-segment case.
//
// Bound: memory.  The kernel reads every input element once (2 bytes in
// bfloat16) for 2 float operations; tiles of 32768 columns keep tens of
// thousands of blocks in flight, and each thread reads 16 bytes at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float sumsq16(const T* __restrict__ p) {
  float s = 0.0f;
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    s = a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      s += f.x * f.x + f.y * f.y;
    }
  }
  return s;
}

// Sum over the block in a fixed order (warp shuffles, then the first warp
// over the warp sums); the total is valid in thread 0.
__device__ __forceinline__ float block_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  s = 0.0f;
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

// VEC: every tile boundary and P are multiples of the 16-byte vector width.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ x, long long P, const long long* __restrict__ tile_start,
               const long long* __restrict__ tile_end, int n_tiles,
               float* __restrict__ partial) {
  constexpr int V = 16 / sizeof(T);
  const int t = blockIdx.x;
  const int r = blockIdx.y;
  const T* row = x + (size_t)r * (size_t)P;
  const long long a = tile_start[t];
  const long long b = tile_end[t];
  float s = 0.0f;
  if (VEC) {
    for (long long p = a + (long long)threadIdx.x * V; p < b; p += (long long)kThreads * V)
      s += sumsq16(row + p);
  } else {
    for (long long p = a + threadIdx.x; p < b; p += kThreads) {
      const float v = to_f32(row[p]);
      s += v * v;
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[(size_t)r * n_tiles + t] = s;
}

// grid: (n_seg, R); block (s, r) adds the partials of segment s of row r.
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ partial, int n_tiles,
              const long long* __restrict__ seg_first_tile, int n_seg,
              float* __restrict__ out) {
  const int s = blockIdx.x;
  const int r = blockIdx.y;
  const float* row = partial + (size_t)r * n_tiles;
  float acc = 0.0f;
  for (long long t = seg_first_tile[s] + threadIdx.x; t < seg_first_tile[s + 1]; t += kThreads)
    acc += row[t];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[(size_t)r * n_seg + s] = sqrtf(acc);
}

template <typename T>
void launch_partial(bool vec, const void* x, long long R, long long P, const void* ts,
                    const void* te, int n_tiles, void* partial, cudaStream_t st) {
  const dim3 grid((unsigned)n_tiles, (unsigned)R);
  const T* xp = static_cast<const T*>(x);
  const long long* a = static_cast<const long long*>(ts);
  const long long* b = static_cast<const long long*>(te);
  float* out = static_cast<float*>(partial);
  if (vec) partial_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, P, a, b, n_tiles, out);
  else partial_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, P, a, b, n_tiles, out);
}

}  // namespace

// x: (R, P) row-major, dtype 0 = float32, 1 = bfloat16.  Tiles are column
// ranges [tile_start[t], tile_end[t]) in segment order; segment s owns tiles
// seg_first_tile[s] .. seg_first_tile[s + 1] - 1 (an empty segment owns none
// and gets norm 0).  partial: (R, n_tiles) float32 scratch; out: (R, n_seg).
// vec_ok: the caller checked that P and every tile boundary are multiples
// of the 16-byte vector width.  Returns cudaGetLastError() (0 = launched).
extern "C" int repro_segment_l2_norms(int dtype, const void* x, long long R, long long P,
                                      const void* tile_start, const void* tile_end,
                                      int n_tiles, const void* seg_first_tile, int n_seg,
                                      void* partial, void* out, int vec_ok, void* stream) {
  if (R <= 0 || n_seg <= 0) return 0;
  if (R > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok != 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  if (n_tiles > 0) {
    if (dtype == 0) launch_partial<float>(vec, x, R, P, tile_start, tile_end, n_tiles, partial, st);
    else if (dtype == 1) launch_partial<__nv_bfloat16>(vec, x, R, P, tile_start, tile_end, n_tiles, partial, st);
    else return (int)cudaErrorInvalidValue;
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  finish_kernel<<<dim3((unsigned)n_seg, (unsigned)R), kThreads, 0, st>>>(
      static_cast<const float*>(partial), n_tiles,
      static_cast<const long long*>(seg_first_tile), n_seg, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
