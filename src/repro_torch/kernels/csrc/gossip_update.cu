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
// and the ragged tail is masked in-kernel (no zero-padded copy).  K1 takes
// row strides, so the bucketed step launches it in place on a bucket, a
// column slice of the flat (G, P) state, with no copy either.  The weight, fault and srcs rows, lr and beta are
// runtime operands, so a new schedule or fault never rebuilds anything.
//
// K1 has a second, one-pass route (repro_gossip_program_update with a null
// wire) for the stacked step, where the wire is every sender's own row:
// mixing is column-wise, so one thread that owns 8 columns of all G rows
// computes each sender's row (theta* = theta - lr u (beta m + g) in the
// plain wire's float32 operations and order, rounded to theta's dtype; or
// theta itself for pre) into its own slot of shared memory, then mixes the
// rows from there.  No (G, P) wire is written or read back: the round moves
// theta, g, m in and theta', m' out, (14 B a bfloat16 element), and its
// theta' and m' are those of the wire plus the two-operand route, bit for
// bit.  The slots take G (16 + 32) B a thread in bfloat16, G (32 + 32) in
// float32, so G is bounded by a block's 48 KiB (one_pass_max_rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kElems = 8;      // elements per thread
constexpr int kThreads = 256;  // threads per block
constexpr long long kMaxBlocksPerRow = 4096;
constexpr long long kMaxOnePassBlocks = 2147483647;

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
// of row i and reads neighbour k from wire row srcs[i, k].  Rows are P
// elements wide and start every ld_state elements in theta, grad and mom,
// every ld_wire elements in the wire: the whole flat state has
// ld_state == P, a bucket (a column slice of it) ld_state > P.
// VEC: P, ld_state and ld_wire % 8 == 0 and every pointer 16-byte aligned,
// so each chunk is one (bfloat16) or two (float32) 16-byte transactions
// per operand.
template <typename T, bool PRE, bool VEC>
__global__ void __launch_bounds__(kThreads)
program_update_kernel(T* __restrict__ theta, const T* __restrict__ wire,
                      const T* __restrict__ grad, float* __restrict__ mom,
                      const float* __restrict__ weights, const float* __restrict__ fault,
                      const int* __restrict__ srcs, long long P, long long ld_state,
                      long long ld_wire, int deg, float lr, float beta) {
  const int i = blockIdx.y;
  const float* wrow = weights + (size_t)i * (deg + 1);
  const float* frow = fault + (size_t)i * (deg + 1);
  const int* srow = srcs + (size_t)i * deg;
  const RowCoeffs c = row_coeffs(wrow, frow, deg, lr);
  const size_t row = (size_t)i * (size_t)ld_state;
  const long long nchunks = (P + kElems - 1) / kElems;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < nchunks;
       ch += (long long)gridDim.x * blockDim.x) {
    const size_t p0 = (size_t)ch * kElems;
    const int n = VEC ? kElems : (int)min((long long)kElems, P - (long long)p0);
    update_chunk<T, PRE, VEC>(
        theta + row + p0, grad + row + p0, mom + row + p0, n, c, wrow, frow, deg, beta,
        [&](int k) { return wire + (size_t)srow[k] * (size_t)ld_wire + p0; });
  }
}

// The one-pass route's staging: a thread's slot of row j holds the sender's
// row in T (kStageWords<T> 16-byte words) and 8 float32 (2 words: the post
// self term, or m' for pre).  Word w of row j of thread t sits at
// ((j * kSlotWords<T> + w) * blockDim.x + t), so a warp's 16-byte accesses to
// one word are contiguous (no bank conflicts); each thread touches only its
// own slot, so no __syncthreads is needed.
template <typename T>
constexpr int kStageWords = (int)sizeof(T) * kElems / 16;
template <typename T>
constexpr int kSlotWords = kStageWords<T> + 2;
constexpr int kOnePassThreads = 128;
constexpr int kOnePassSmemBytes = 48 * 1024;   // a block's shared memory without the opt-in

template <typename T>
__device__ __forceinline__ void put_row(uint4* s, int ld, const float (&v)[kElems]) {
  if constexpr (std::is_same<T, float>::value) {
    reinterpret_cast<float4*>(s)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(s + ld)[0] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < kElems; ++j) h[j] = __float2bfloat16_rn(v[j]);
    s[0] = raw;
  }
}

template <typename T>
__device__ __forceinline__ void get_row(const uint4* s, int ld, float (&v)[kElems]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = reinterpret_cast<const float4*>(s)[0];
    const float4 b = reinterpret_cast<const float4*>(s + ld)[0];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    load8(reinterpret_cast<const __nv_bfloat16*>(s), v);
  }
}

// K1, one pass — grid (blocks, 1); each thread walks chunks of 8 columns of
// all G rows.  Pass 1, row by row: load theta, g, m; m' (written at once);
// the sender's row (rounded to T) and the post self term w0' (theta - lr u
// m') or, for pre, m' into the slot.  Pass 2, row by row: update_chunk's
// sums from the slots, neighbour k being the slot of row srcs[i, k]; theta'
// written.  VEC as for the two-operand route, without a wire.
template <typename T, bool PRE, bool VEC>
__global__ void __launch_bounds__(kOnePassThreads)
program_update_kernel_one_pass(T* __restrict__ theta, const T* __restrict__ grad,
                               float* __restrict__ mom, const float* __restrict__ weights,
                               const float* __restrict__ fault, const int* __restrict__ srcs,
                               int G, long long P, long long ld_state, int deg, float lr,
                               float beta) {
  extern __shared__ uint4 stage[];
  const int ld = blockDim.x;
  uint4* mine = stage + threadIdx.x;
  const long long nchunks = (P + kElems - 1) / kElems;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < nchunks;
       ch += (long long)gridDim.x * blockDim.x) {
    const size_t p0 = (size_t)ch * kElems;
    const int n = VEC ? kElems : (int)min((long long)kElems, P - (long long)p0);
    for (int j = 0; j < G; ++j) {
      const float* wrow = weights + (size_t)j * (deg + 1);
      const float* frow = fault + (size_t)j * (deg + 1);
      const RowCoeffs c = row_coeffs(wrow, frow, deg, lr);
      const size_t at = (size_t)j * (size_t)ld_state + p0;
      float th[kElems], g[kElems], m[kElems], send[kElems], keep[kElems];
      if (VEC) {
        load8(theta + at, th);
        load8(grad + at, g);
        load8(mom + at, m);
      } else {
        load_n(theta + at, n, th);
        load_n(grad + at, n, g);
        load_n(mom + at, n, m);
      }
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const float s = beta * m[e] + g[e];
        // the plain wire's order: ((beta m + g) u) (-lr) + theta
        send[e] = PRE ? th[e] : s * c.u * -lr + th[e];
        m[e] = c.u * s + (1.0f - c.u) * m[e];
        keep[e] = PRE ? m[e] : c.self_w * (th[e] - c.lru * m[e]);
      }
      if (VEC) store8(mom + at, m); else store_n(mom + at, n, m);
      uint4* slot = mine + (size_t)j * kSlotWords<T> * ld;
      put_row<T>(slot, ld, send);
      put_row<float>(slot + kStageWords<T> * ld, ld, keep);
    }
    for (int i = 0; i < G; ++i) {
      const float* wrow = weights + (size_t)i * (deg + 1);
      const float* frow = fault + (size_t)i * (deg + 1);
      const int* srow = srcs + (size_t)i * deg;
      const RowCoeffs c = row_coeffs(wrow, frow, deg, lr);
      const uint4* slot = mine + (size_t)i * kSlotWords<T> * ld;
      float acc[kElems], keep[kElems];
      get_row<float>(slot + kStageWords<T> * ld, ld, keep);
      if (PRE) {
        get_row<T>(slot, ld, acc);
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[e] = c.self_w * acc[e];
      } else {
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[e] = keep[e];
      }
      for (int k = 0; k < deg; ++k) {
        const float fw = frow[k + 1] * wrow[k + 1];
        float nv[kElems];
        get_row<T>(mine + (size_t)srow[k] * kSlotWords<T> * ld, ld, nv);
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[e] = acc[e] + fw * nv[e];
      }
      if (PRE) {
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[e] = acc[e] - c.lru * keep[e];
      }
      const size_t at = (size_t)i * (size_t)ld_state + p0;
      if (VEC) store8(theta + at, acc); else store_n(theta + at, n, acc);
    }
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

// The one-pass route's dynamic shared memory for G rows, and the most rows
// that fit a block's 48 KiB (8 in bfloat16, 6 in float32).
size_t one_pass_smem_bytes(int dtype, int G) {
  const int words = dtype == 0 ? kSlotWords<float> : kSlotWords<__nv_bfloat16>;
  return (size_t)G * words * kOnePassThreads * 16;
}

long long one_pass_max_rows(int dtype) {
  return kOnePassSmemBytes / (long long)one_pass_smem_bytes(dtype, 1);
}

// One chunk of 8 columns a thread: ceil(ceil(P/8) / 128) blocks, within the grid's x.
unsigned one_pass_blocks(long long P) {
  const long long nchunks = (P + kElems - 1) / kElems;
  const long long bx = (nchunks + kOnePassThreads - 1) / kOnePassThreads;
  return (unsigned)(bx > kMaxOnePassBlocks ? kMaxOnePassBlocks : bx);
}

}  // namespace

// K1.  dtype: 0 = float32, 1 = bfloat16 (theta, wire and grad share it).
// theta, grad and mom are G rows of P elements with row stride ld_state,
// the wire G rows with row stride ld_wire (both >= P).  A null wire takes
// the one-pass route: the senders' rows are computed in the kernel (ld_wire
// is not read), for G up to one_pass_max_rows(dtype).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_gossip_program_update(int dtype, int pre, void* theta,
                                           const void* wire, const void* grad, void* mom,
                                           const void* weights, const void* fault,
                                           const void* srcs, long long G, long long P,
                                           long long ld_state, long long ld_wire, int deg,
                                           float lr, float beta, void* stream) {
  if (G <= 0 || P <= 0) return 0;
  if (G > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wire == nullptr) {
    if (ld_state < P || G > one_pass_max_rows(dtype)) return (int)cudaErrorInvalidValue;
    const bool vec = (P % kElems == 0) && (ld_state % kElems == 0) && aligned16(theta) &&
                     aligned16(grad) && aligned16(mom);
    const size_t smem = one_pass_smem_bytes(dtype, (int)G);
    const unsigned blocks = one_pass_blocks(P);
    return dispatch(dtype, pre != 0, vec, [&](auto t, auto pre_c, auto vec_c) {
      using T = decltype(t);
      program_update_kernel_one_pass<T, decltype(pre_c)::value, decltype(vec_c)::value>
          <<<blocks, kOnePassThreads, smem, s>>>(
              static_cast<T*>(theta), static_cast<const T*>(grad), static_cast<float*>(mom),
              static_cast<const float*>(weights), static_cast<const float*>(fault),
              static_cast<const int*>(srcs), (int)G, P, ld_state, deg, lr, beta);
    });
  }
  if (ld_state < P || ld_wire < P) return (int)cudaErrorInvalidValue;
  const bool vec = (P % kElems == 0) && (ld_state % kElems == 0) &&
                   (ld_wire % kElems == 0) && aligned16(theta) && aligned16(wire) &&
                   aligned16(grad) && aligned16(mom);
  const dim3 grid(blocks_per_row(P), (unsigned)G);
  return dispatch(dtype, pre != 0, vec, [&](auto t, auto pre_c, auto vec_c) {
    using T = decltype(t);
    program_update_kernel<T, decltype(pre_c)::value, decltype(vec_c)::value>
        <<<grid, kThreads, 0, s>>>(
            static_cast<T*>(theta), static_cast<const T*>(wire), static_cast<const T*>(grad),
            static_cast<float*>(mom), static_cast<const float*>(weights),
            static_cast<const float*>(fault), static_cast<const int*>(srcs), P, ld_state,
            ld_wire, deg, lr, beta);
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

namespace {

// cudaFuncGetAttributes of one kernel into out[6]: registers a thread,
// static shared bytes a block, the dynamic shared bytes its launch asks
// for, the most threads a block of it can take, the threads it launches
// with, local (spill) bytes a thread.
template <typename K>
int attributes_of(K kern, int threads, int dynamic_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = dynamic_smem;
  out[3] = a.maxThreadsPerBlock;
  out[4] = threads;
  out[5] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// The built K1 (which 0), K2 (which 1) or K1's one-pass route at its most
// rows (which 2), post order on the vector path, dtype 0 = float32,
// 1 = bfloat16: attributes_of's six numbers.  Returns a CUDA error code
// (0 = read).
extern "C" int repro_gossip_update_attributes(int which, int dtype, int* out) {
  if (which == 0) {
    if (dtype == 0) return attributes_of(program_update_kernel<float, false, true>, kThreads, 0, out);
    return attributes_of(program_update_kernel<__nv_bfloat16, false, true>, kThreads, 0, out);
  }
  if (which == 2) {
    const int smem = (int)one_pass_smem_bytes(dtype, (int)one_pass_max_rows(dtype));
    if (dtype == 0)
      return attributes_of(program_update_kernel_one_pass<float, false, true>, kOnePassThreads,
                           smem, out);
    return attributes_of(program_update_kernel_one_pass<__nv_bfloat16, false, true>,
                         kOnePassThreads, smem, out);
  }
  if (dtype == 0) return attributes_of(node_update_kernel<float, false, true>, kThreads, 0, out);
  return attributes_of(node_update_kernel<__nv_bfloat16, false, true>, kThreads, 0, out);
}

// The current card's launch limits: out[7] = {grid x, grid y, grid z,
// shared bytes a block with the opt-in, shared bytes a block without it,
// threads a block, registers a block}.  Returns a CUDA error code.
extern "C" int repro_device_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const cudaDeviceAttr attrs[7] = {
      cudaDevAttrMaxGridDimX, cudaDevAttrMaxGridDimY, cudaDevAttrMaxGridDimZ,
      cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMaxSharedMemoryPerBlock,
      cudaDevAttrMaxThreadsPerBlock, cudaDevAttrMaxRegistersPerBlock};
  for (int i = 0; i < 7; ++i) {
    e = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
