// K1 and K2: fused momentum-SGD + gossip mix, for Hopper (sm_90a).
//
// K1 (repro_gossip_program_update) replaces the TPU kernel
// gossip_program_update of src/repro/kernels/gossip_update.py
// (_program_kernel via _mix_block) and runs over G stacked nodes; K2
// (repro_gossip_update) replaces gossip_update of the same file (_kernel)
// and runs over one node, whose neighbours are the (deg, P) landing buffer
// of the collective-permutes.  Both call one per-chunk device function,
// update_chunk, so the math lives once.  For node i and element p, with
// u = fault[i, 0], f_k = fault[i, k+1], w = weights[i, :] and n_k the
// neighbour row (K1: wire[srcs[i, k]]; K2: nbrs[k]):
//
//   m'  = u (beta m + g) + (1 - u) m
//   w0' = w0 + sum_k (1 - f_k) w_k
//   post: theta' = w0' (theta - lr u m') + sum_k f_k w_k n_k[p]
//   pre:  theta' = w0' theta + sum_k f_k w_k n_k[p] - lr u m'
//
// Accumulation is float32; theta' keeps theta's dtype (float32 or bfloat16),
// m' is float32.  The update is IN PLACE: theta and mom are overwritten.
// That is safe because every element is read and then written by the same
// thread, and the caller guarantees that the wire (the neighbours' rows)
// is a separate buffer.
//
// Bound: memory.  Per element the kernel moves theta, g, m in, theta', m'
// out and deg neighbour values: (14 + 2 deg) bytes in bfloat16, for about
// 3 deg + 10 float operations, far below the card's operations-per-byte
// balance.  The design therefore only keeps the bytes at that floor: one
// thread handles 8 consecutive elements with 16-byte loads and stores,
// K1 reads neighbour rows straight from the wire through the srcs table
// (no gathered (G, deg, P) copy), K2 straight from the landing buffer,
// and the ragged tail is masked in-kernel (no zero-padded copy).  The weight, fault and srcs rows, lr and beta are
// runtime operands, so a new schedule or fault never rebuilds anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kElems = 8;      // elements per thread
constexpr int kThreads = 256;  // threads per block
constexpr long long kMaxBlocksPerRow = 4096;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive elements, 16-byte aligned, as float32.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float (&out)[kElems]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, const float (&in)[kElems]) {
  if constexpr (std::is_same<T, float>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
  } else {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < kElems; ++j) h[j] = __float2bfloat16_rn(in[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// n (< 8 on the ragged tail) elements with scalar loads; the rest are 0.
template <typename T>
__device__ __forceinline__ void load_n(const T* __restrict__ p, int n, float (&out)[kElems]) {
#pragma unroll
  for (int j = 0; j < kElems; ++j) out[j] = j < n ? to_f32(p[j]) : 0.0f;
}

template <typename T>
__device__ __forceinline__ void store_n(T* __restrict__ p, int n, const float (&in)[kElems]) {
#pragma unroll
  for (int j = 0; j < kElems; ++j)
    if (j < n) p[j] = from_f32<T>(in[j]);
}

// This node's row constants: w0' = w0 + sum_k (1 - f_k) w_k, u and lr u.
struct RowCoeffs {
  float self_w, u, lru;
};

__device__ __forceinline__ RowCoeffs row_coeffs(const float* __restrict__ wrow,
                                                const float* __restrict__ frow, int deg,
                                                float lr) {
  RowCoeffs c;
  c.u = frow[0];
  c.self_w = wrow[0];
  for (int k = 0; k < deg; ++k) c.self_w = c.self_w + (1.0f - frow[k + 1]) * wrow[k + 1];
  c.lru = lr * c.u;
  return c;
}

// The arithmetic of one chunk of 8 consecutive elements (n < 8 on the
// ragged tail), shared by K1 and K2: theta, grad and mom point at the
// chunk's first element, nbr(k) at neighbour k's row at the same column.
// theta' and m' are written in place.
template <typename T, bool PRE, bool VEC, typename Nbr>
__device__ __forceinline__ void update_chunk(T* __restrict__ theta, const T* __restrict__ grad,
                                             float* __restrict__ mom, int n,
                                             const RowCoeffs& c, const float* __restrict__ wrow,
                                             const float* __restrict__ frow, int deg, float beta,
                                             Nbr nbr) {
  float th[kElems], g[kElems], m[kElems], acc[kElems];
  if (VEC) {
    load8(theta, th);
    load8(grad, g);
    load8(mom, m);
  } else {
    load_n(theta, n, th);
    load_n(grad, n, g);
    load_n(mom, n, m);
  }
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    m[j] = c.u * (beta * m[j] + g[j]) + (1.0f - c.u) * m[j];
    acc[j] = PRE ? c.self_w * th[j] : c.self_w * (th[j] - c.lru * m[j]);
  }
  for (int k = 0; k < deg; ++k) {
    const float fw = frow[k + 1] * wrow[k + 1];
    const T* nb = nbr(k);
    float nv[kElems];
    if (VEC) load8(nb, nv); else load_n(nb, n, nv);
#pragma unroll
    for (int j = 0; j < kElems; ++j) acc[j] = acc[j] + fw * nv[j];
  }
  if (PRE) {
#pragma unroll
    for (int j = 0; j < kElems; ++j) acc[j] = acc[j] - c.lru * m[j];
  }
  if (VEC) {
    store8(theta, acc);
    store8(mom, m);
  } else {
    store_n(theta, n, acc);
    store_n(mom, n, m);
  }
}

// K1 — grid: (blocks per row, G); each thread walks chunks of 8 elements
// of row i and reads neighbour k from wire row srcs[i, k].
// VEC: P % 8 == 0 and every pointer 16-byte aligned, so each chunk is one
// (bfloat16) or two (float32) 16-byte transactions per operand.
template <typename T, bool PRE, bool VEC>
__global__ void __launch_bounds__(kThreads)
program_update_kernel(T* __restrict__ theta, const T* __restrict__ wire,
                      const T* __restrict__ grad, float* __restrict__ mom,
                      const float* __restrict__ weights, const float* __restrict__ fault,
                      const int* __restrict__ srcs, long long P, int deg, float lr,
                      float beta) {
  const int i = blockIdx.y;
  const float* wrow = weights + (size_t)i * (deg + 1);
  const float* frow = fault + (size_t)i * (deg + 1);
  const int* srow = srcs + (size_t)i * deg;
  const RowCoeffs c = row_coeffs(wrow, frow, deg, lr);
  const size_t row = (size_t)i * (size_t)P;
  const long long nchunks = (P + kElems - 1) / kElems;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < nchunks;
       ch += (long long)gridDim.x * blockDim.x) {
    const size_t p0 = (size_t)ch * kElems;
    const int n = VEC ? kElems : (int)min((long long)kElems, P - (long long)p0);
    update_chunk<T, PRE, VEC>(
        theta + row + p0, grad + row + p0, mom + row + p0, n, c, wrow, frow, deg, beta,
        [&](int k) { return wire + (size_t)srow[k] * (size_t)P + p0; });
  }
}

// K2 — one node: grid (blocks, 1); neighbour k is row k of the (deg, P)
// landing buffer the collective-permutes filled.
template <typename T, bool PRE, bool VEC>
__global__ void __launch_bounds__(kThreads)
node_update_kernel(T* __restrict__ theta, const T* __restrict__ nbrs,
                   const T* __restrict__ grad, float* __restrict__ mom,
                   const float* __restrict__ wrow, const float* __restrict__ frow,
                   long long P, int deg, float lr, float beta) {
  const RowCoeffs c = row_coeffs(wrow, frow, deg, lr);
  const long long nchunks = (P + kElems - 1) / kElems;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < nchunks;
       ch += (long long)gridDim.x * blockDim.x) {
    const size_t p0 = (size_t)ch * kElems;
    const int n = VEC ? kElems : (int)min((long long)kElems, P - (long long)p0);
    update_chunk<T, PRE, VEC>(
        theta + p0, grad + p0, mom + p0, n, c, wrow, frow, deg, beta,
        [&](int k) { return nbrs + (size_t)k * (size_t)P + p0; });
  }
}

// Calls f(T{}, PRE, VEC) with the element type and the two flags as
// compile-time constants; returns cudaGetLastError() after the launch.
template <typename F>
int dispatch(int dtype, bool pre, bool vec, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  auto flags = [&](auto t) {
    if (pre) {
      if (vec) f(t, Y{}, Y{}); else f(t, Y{}, N{});
    } else {
      if (vec) f(t, N{}, Y{}); else f(t, N{}, N{});
    }
  };
  if (dtype == 0) {
    flags(float{});
  } else if (dtype == 1) {
    flags(__nv_bfloat16{});
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

unsigned blocks_per_row(long long P) {
  const long long nchunks = (P + kElems - 1) / kElems;
  long long bx = (nchunks + kThreads - 1) / kThreads;
  return (unsigned)(bx > kMaxBlocksPerRow ? kMaxBlocksPerRow : bx);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// K1.  dtype: 0 = float32, 1 = bfloat16 (theta, wire and grad share it).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_gossip_program_update(int dtype, int pre, void* theta,
                                           const void* wire, const void* grad, void* mom,
                                           const void* weights, const void* fault,
                                           const void* srcs, long long G, long long P,
                                           int deg, float lr, float beta, void* stream) {
  if (G <= 0 || P <= 0) return 0;
  if (G > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool vec = (P % kElems == 0) && aligned16(theta) && aligned16(wire) &&
                   aligned16(grad) && aligned16(mom);
  const dim3 grid(blocks_per_row(P), (unsigned)G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, pre != 0, vec, [&](auto t, auto pre_c, auto vec_c) {
    using T = decltype(t);
    program_update_kernel<T, decltype(pre_c)::value, decltype(vec_c)::value>
        <<<grid, kThreads, 0, s>>>(
            static_cast<T*>(theta), static_cast<const T*>(wire), static_cast<const T*>(grad),
            static_cast<float*>(mom), static_cast<const float*>(weights),
            static_cast<const float*>(fault), static_cast<const int*>(srcs), P, deg, lr, beta);
  });
}

// K2: one node's theta, grad (P,) and mom (P,) float32, updated in place,
// from the (deg, P) landing buffer nbrs and this node's (deg+1,) weight
// and fault rows.  dtype as for K1.
extern "C" int repro_gossip_update(int dtype, int pre, void* theta, const void* nbrs,
                                   const void* grad, void* mom, const void* weights,
                                   const void* fault, long long P, int deg, float lr,
                                   float beta, void* stream) {
  if (P <= 0) return 0;
  const bool vec = (P % kElems == 0) && aligned16(theta) && aligned16(nbrs) &&
                   aligned16(grad) && aligned16(mom);
  const dim3 grid(blocks_per_row(P), 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, pre != 0, vec, [&](auto t, auto pre_c, auto vec_c) {
    using T = decltype(t);
    node_update_kernel<T, decltype(pre_c)::value, decltype(vec_c)::value>
        <<<grid, kThreads, 0, s>>>(
            static_cast<T*>(theta), static_cast<const T*>(nbrs), static_cast<const T*>(grad),
            static_cast<float*>(mom), static_cast<const float*>(weights),
            static_cast<const float*>(fault), P, deg, lr, beta);
  });
}
