// K5: Mamba2's grouped SSD chunk scan, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's scan (src/repro/models/recurrence.py)
// is plain jnp, and so was the port's models/recurrence.py::_ssd_groups, which stays
// as the plain route for CPU and float64 inputs.  That route writes every chunk's
// (B, chunks, G, Q, c, c) float32 pair decays, their product with C Bᵀ and the
// backward's gradients of both to device memory; this kernel pair keeps the pairs on
// chip and saves only the states that enter each 64-row sub-chunk for the backward.
//
// Algorithm: the chunked SSD at a 64-row chunk (sub-chunk).  One block owns one
// (sequence b, head h) and walks the sub-chunks in order (the backward in reverse),
// carrying the head's 64 x 64 float32 state (its gradient) in registers and shared
// memory.  In a sub-chunk every product is one 64 x 64 x 64 tile product in shared
// memory, with the relative decays exp(la_t - la_s) (la the sub-chunk's cumulative
// dt a, s <= t) computed as each tile is formed and never stored:
//   forward   M = (C Bᵀ) o decay o dt_s;  y = e^{la} o (C hᵀ) + M X;
//             h' = e^{la_end} h + Xᵀ (w o B),  w_s = e^{la_end - la_s} dt_s
//   backward  the products of the plain twin in tests/test_torch_ssd_kernel.py
//             (twin_backward), one for one:
//             C Bᵀ, dY Xᵀ, B dHᵀ, Sᵀ dY, dY h, dCB B, X dH, dCBᵀ C, dYᵀ (e^{la} o C)
// Products whose left operand is zero above the diagonal stop at (or start from) the
// warp's own rows.  dB and dC are written per head ((B, L, H, N)) and summed over the
// group's heads by the wrapper; da per (b, h).
//
// Why a block owns one head and not a tile of a group's heads (which would form C Bᵀ
// once for them all): the grid is B x H blocks, 448 at zamba2-7b's shapes, against
// 132 multiprocessors holding two forward blocks each; a tile of t heads divides the
// grid by t (t = 4: 112 blocks, under one a multiprocessor) and multiplies the state
// and X tiles a block holds by t.  C Bᵀ is recomputed by every head (1 of the 3.5
// products a head does forward, and 1 of 7.5 backward, with dY Xᵀ formed whole).
//
// Bound: float32 operations, of the work the function needs (ssd_scan.py::scan_cost):
// per head and sub-chunk 2.5 products of 2 x 64^3 FLOPs forward and 6 backward
// (triangular operands counted half), C Bᵀ's lower triangle once per group and
// sub-chunk.  At zamba2-7b's shapes (B 4, L 1,024, H 112, G 2, P = N = 64) 32.0 GFLOP
// a scan, 0.48 ms at 67 TFLOP/s, against 0.88 GB of inputs, outputs and states read or
// written once (0.26 ms at 3.35 TB/s).  Design for the CUDA cores: 256 threads, each
// owning a 4 x 4 block of every 64 x 64 product (rows 4 ty.., columns 4 tx..), its
// operands read as float4 from tiles whose 16-byte chunks are XOR-swizzled by the row,
// so row-wise and column-wise reads of either operand are free of bank conflicts, and
// explicit fmaf (the build has -fmad=false).  The forward (5 tiles, two blocks a
// multiprocessor) copies a sub-chunk's tiles and waits; the backward (one block) copies the
// next sub-chunk's tiles while this one's products run.  Float32 throughout, but for the
// 64 prefix sums la of a sub-chunk, kept in double (cumsum_la); sums in another order
// than the eager route's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // rows of a sub-chunk; P = N = 64
constexpr int kThreads = 256;    // ty = tid / 16 owns rows 4 ty .. 4 ty + 3, tx = tid % 16 columns 4 tx ..
constexpr int kTile = 64 * 64;   // floats in a tile
constexpr int kFwdTiles = 5;     // C, B, X, M, h: two blocks a multiprocessor
constexpr int kBwdIn = 5;        // C, B, X, dY, h: read by a sub-chunk, in two sets (the next
                                 // one's copies land during this one's products)
constexpr int kBwdTiles = 2 * kBwdIn + 3;   // and S, dCB, dH
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (size_t)(kFwdTiles * kTile + kRows) + sizeof(double) * kRows;
}
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (size_t)(kBwdTiles * kTile + 7 * kRows + 8) + sizeof(double) * kRows;
}

// Offset of element (r, c) of a 64 x 64 tile: 16-byte chunk c / 4 of row r lands at
// chunk (c / 4) ^ ((r / 4) % 8).
__device__ __forceinline__ int sw(int r, int c) {
  return r * 64 + ((((c >> 2) ^ ((r >> 2) & 7))) << 2) + (c & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 f4(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ void unpack(float4 t, float (&v)[4]) {
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// An asynchronous copy of `bytes` (4 or 16) from global to shared memory, zero-filled
// where `valid` is false (nothing is read then).
template <int bytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [0, rows) of a 64-wide block with row stride ld (floats) into tile t;
// the rest zero.
__device__ __forceinline__ void load_tile(float* __restrict__ t, const float* __restrict__ g,
                                          size_t ld, int rows) {
  for (int i = threadIdx.x; i < 64 * 16; i += kThreads) {
    const int r = i >> 4, c = (i & 15) << 2;
    cp_async<16>(t + sw(r, c), g + (r < rows ? r * ld + c : 0), r < rows);
  }
}

// Start copying a sub-chunk's dt (64 rows of stride `ld`, zero past `rows`).
__device__ __forceinline__ void load_dt(float* __restrict__ t, const float* __restrict__ g,
                                        size_t ld, int rows) {
  if (threadIdx.x < kRows)
    cp_async<4>(t + threadIdx.x, g + (threadIdx.x < rows ? threadIdx.x * ld : 0), threadIdx.x < rows);
}

// acc[i][j] += sum over k in [k0, k1) of A(4 ty + i, k) B(k, 4 tx + j), with A read as
// a[r][k] (A_T false) or a[k][r] (A_T true) and B as b[c][k] (B_T false) or b[k][c]
// (B_T true); k0 and k1 multiples of 4.
template <bool A_T, bool B_T>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* __restrict__ a,
                                   const float* __restrict__ b, int k0, int k1) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float av[4][4], bv[4][4];   // av[i][u] = A(4 ty + i, k + u), bv[u][j] = B(k + u, 4 tx + j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float t[4];
      if (A_T) {
        unpack(ld4(a + sw(k + u, 4 * ty)), t);
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i][u] = t[i];
      } else {
        unpack(ld4(a + sw(4 * ty + u, k)), av[u]);
      }
      if (B_T) {
        unpack(ld4(b + sw(k + u, 4 * tx)), bv[u]);
      } else {
        unpack(ld4(b + sw(4 * tx + u, k)), t);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j][u] = t[j];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i][u], bv[u][j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Sum over the 16 threads of a row (the tx of one ty: lanes of one half-warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// la[t] = sum over r <= t of dt[r] a (warp 0; two rows a lane): float32 products summed
// in double, so that a relative exponent la_t - la_s, taken in double, keeps float32's
// precision however large |la| grows (dt a down to -60 a step reaches thousands).
__device__ __forceinline__ void cumsum_la(const float* __restrict__ dt, float a,
                                          double* __restrict__ la) {
  const int lane = threadIdx.x & 31;
  const double v0 = (double)(dt[2 * lane] * a);
  const double v1 = v0 + (double)(dt[2 * lane + 1] * a);
  double s = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += t;
  }
  double before = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) before = 0.;
  la[2 * lane] = before + v0;
  la[2 * lane + 1] = before + v1;
}

// exp(u - v) of two of those sums, the difference taken in double.
__device__ __forceinline__ float exp_diff(double u, double v) { return expf((float)(u - v)); }

__global__ void __launch_bounds__(kThreads, 2)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ av, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ states, int L, int H, int G) {
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);
  float* sB = sC + kTile;
  float* sX = sB + kTile;
  float* sM = sX + kTile;
  float* sH = sM + kTile;        // the state entering the sub-chunk, [p][n]
  float* sDt = sH + kTile;
  double* sLa = reinterpret_cast<double*>(sDt + kRows);

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, warp = threadIdx.x >> 5;
  const float a = av[h];
  const int nsub = (L + kRows - 1) / kRows;
  const size_t hd = (size_t)b * H + h;
  float* st_out = states + hd * (size_t)(nsub + 1) * kTile;

  float st[4][4];   // state rows p = 4 ty + i, columns n = 4 tx + j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = (4 * ty + i) * 64 + 4 * tx;
    const float4 v = __ldg(reinterpret_cast<const float4*>(h0 + hd * kTile + o));
    unpack(v, st[i]);
    st4(sH + sw(4 * ty + i, 4 * tx), v);
    st4(st_out + o, v);
  }

  for (int z = 0; z < nsub; ++z) {
    const int l0 = z * kRows, rows = min(kRows, L - l0);
    __syncthreads();   // the previous sub-chunk's reads are done
    const size_t grow = ((size_t)b * L + l0) * G + g;
    load_tile(sC, cm + grow * 64, (size_t)G * 64, rows);
    load_tile(sB, bm + grow * 64, (size_t)G * 64, rows);
    load_tile(sX, x + (((size_t)b * L + l0) * H + h) * 64, (size_t)H * 64, rows);
    load_dt(sDt, dt + ((size_t)b * L + l0) * H + h, (size_t)H, rows);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (warp == 0) cumsum_la(sDt, a, sLa);
    __syncthreads();

    // M[t][s] = (C Bᵀ)[t][s] exp(la_t - la_s) dt_s for s <= t, else 0
    float acc[4][4];
    zero(acc);
    mm<false, false>(acc, sC, sB, 0, 64);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      float m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * tx + j;
        m[j] = s <= t ? acc[i][j] * exp_diff(sLa[t], sLa[s]) * sDt[s] : 0.f;
      }
      st4(sM + sw(t, 4 * tx), f4(m));
    }
    // y = exp(la_t) (C hᵀ)[t][p] + (M X)[t][p]
    float ya[4][4];
    zero(ya);
    mm<false, false>(ya, sC, sH, 0, 64);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float el = expf((float)sLa[4 * ty + i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) ya[i][j] *= el;
    }
    __syncthreads();   // M written; C Bᵀ and C hᵀ read: B and h may change
    const double e = sLa[kRows - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // B's rows times w_s = exp(e - la_s) dt_s
      const int s = 4 * ty + i;
      const float w = exp_diff(e, sLa[s]) * sDt[s];
      float v[4];
      unpack(ld4(sB + sw(s, 4 * tx)), v);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] *= w;
      st4(sB + sw(s, 4 * tx), f4(v));
    }
    mm<false, true>(ya, sM, sX, 0, 8 * warp + 8);   // M[t][s] = 0 for s past the warp's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      if (t < rows)
        *reinterpret_cast<float4*>(y + (((size_t)b * L + l0 + t) * H + h) * 64 + 4 * tx) = f4(ya[i]);
    }
    __syncthreads();   // B scaled
    // h' = exp(e) h + (Xᵀ (w o B))[p][n]
    const float ee = expf((float)e);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] *= ee;
    mm<true, true>(st, sX, sB, 0, 64);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st4(sH + sw(4 * ty + i, 4 * tx), f4(st[i]));
      st4(st_out + (size_t)(z + 1) * kTile + (4 * ty + i) * 64 + 4 * tx, f4(st[i]));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ av, const float* __restrict__ states,
               const float* __restrict__ dy, const float* __restrict__ dh_final,
               float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ db_heads,
               float* __restrict__ dc_heads, float* __restrict__ dh0,
               float* __restrict__ da_rows, int L, int H, int G) {
  extern __shared__ float4 smem4[];
  float* sIn = reinterpret_cast<float*>(smem4);   // set k: C, B, X, dY, h at sIn + (5 k + i) kTile
  float* sS = sIn + 2 * kBwdIn * kTile;   // S = (C Bᵀ) o decay, s < t (the diagonal apart)
  float* sD = sS + kTile;     // dCB = (dY Xᵀ) o decay o dt_s
  float* sG = sD + kTile;     // dH, the gradient of the state leaving it, [p][n]
  float* sDts = sG + kTile;   // two sets of dt
  double* sLa = reinterpret_cast<double*>(sDts + 2 * kRows);
  float* sDla = reinterpret_cast<float*>(sLa + kRows);   // the pairs' row sums and C's term of dla
  float* sR1 = sDla + kRows;  // x_s . (Sᵀ dY)_s
  float* sR2 = sR1 + kRows;   // x_s . (w' o B dHᵀ)_s
  float* sSd = sR2 + kRows;   // the diagonal S_ss
  float* sDg = sSd + kRows;   // S_ss (dY Xᵀ)_ss
  float* sRed = sDg + kRows;  // 8 warps' <dH, h>

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float a = av[h];
  const int nsub = (L + kRows - 1) / kRows;
  const size_t hd = (size_t)b * H + h;
  const float* st_in = states + hd * (size_t)(nsub + 1) * kTile;

  float dh[4][4];   // dH rows p = 4 ty + i, columns n = 4 tx + j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (dh_final != nullptr)
      v = __ldg(reinterpret_cast<const float4*>(dh_final + hd * kTile + (4 * ty + i) * 64 + 4 * tx));
    unpack(v, dh[i]);
    st4(sG + sw(4 * ty + i, 4 * tx), v);
  }
  float da_acc = 0.f;

  // start copying sub-chunk z's C, B, X, dY, entering state and dt into set z % 2
  auto fetch = [&](int z) {
    const int l0 = z * kRows, rows = min(kRows, L - l0);
    float* set = sIn + (z & 1) * kBwdIn * kTile;
    const size_t grow = ((size_t)b * L + l0) * G + g;
    const size_t hrow = ((size_t)b * L + l0) * H + h;
    load_tile(set, cm + grow * 64, (size_t)G * 64, rows);
    load_tile(set + kTile, bm + grow * 64, (size_t)G * 64, rows);
    load_tile(set + 2 * kTile, x + hrow * 64, (size_t)H * 64, rows);
    load_tile(set + 3 * kTile, dy + hrow * 64, (size_t)H * 64, rows);
    load_tile(set + 4 * kTile, st_in + (size_t)z * kTile, 64, kRows);
    load_dt(sDts + (z & 1) * kRows, dt + hrow, (size_t)H, rows);
    cp_async_commit();
  };
  if (nsub > 0) fetch(nsub - 1);

  for (int z = nsub - 1; z >= 0; --z) {
    const int l0 = z * kRows, rows = min(kRows, L - l0);
    const size_t hrow = ((size_t)b * L + l0) * H + h;
    float* sC = sIn + (z & 1) * kBwdIn * kTile;
    float* sB = sC + kTile;
    float* sX = sB + kTile;
    float* sY = sX + kTile;   // dy
    float* sH = sY + kTile;   // the state entering the sub-chunk, [p][n]
    const float* sDt = sDts + (z & 1) * kRows;
    cp_async_wait_all();
    __syncthreads();   // this sub-chunk's copies have landed; the previous one's reads are done
    if (z > 0) fetch(z - 1);
    if (warp == 0) cumsum_la(sDt, a, sLa);
    __syncthreads();

    // S = (C Bᵀ) o decay for s < t, dCB = (dY Xᵀ) o decay o dt_s for s <= t; row sums of
    // (dY Xᵀ) o S o dt_s.  The diagonal (decay 1) is kept apart, so that no row and column
    // sum of dla cancel it.
    {
      float cb[4][4], gg[4][4];
      zero(cb);
      zero(gg);
      mm<false, false>(cb, sC, sB, 0, 64);
      mm<false, false>(gg, sY, sX, 0, 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        float sv[4], dv[4], rz = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * tx + j;
          const float dec = s <= t ? exp_diff(sLa[t], sLa[s]) : 0.f;
          sv[j] = s < t ? cb[i][j] * dec : 0.f;
          dv[j] = gg[i][j] * dec * sDt[s];
          rz += gg[i][j] * sv[j] * sDt[s];
          if (s == t) {
            sSd[t] = cb[i][j];
            sDg[t] = cb[i][j] * gg[i][j];
          }
        }
        st4(sS + sw(t, 4 * tx), f4(sv));
        st4(sD + sw(t, 4 * tx), f4(dv));
        rz = row_sum(rz);
        if (tx == 0) sDla[t] = rz;
      }
    }
    __syncthreads();   // S and dCB written
    const double e = sLa[kRows - 1];

    // dXD[s][p] = exp(e - la_s) (B dHᵀ)[s][p] + (Sᵀ dY)[s][p] + S_ss dY[s][p]; dx = dt_s dXD
    {
      float t1[4][4], t2[4][4];
      zero(t1);
      zero(t2);
      mm<false, false>(t2, sB, sG, 0, 64);
      mm<true, true>(t1, sS, sY, 8 * warp, 64);   // S[t][s] = 0 for t before the warp's rows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * ty + i;
        const float wp = exp_diff(e, sLa[s]);
        float xv[4], yv[4], o[4], r1 = 0.f, r2 = 0.f;
        unpack(ld4(sX + sw(s, 4 * tx)), xv);
        unpack(ld4(sY + sw(s, 4 * tx)), yv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t2[i][j] *= wp;
          r1 += xv[j] * t1[i][j];
          r2 += xv[j] * t2[i][j];
          o[j] = sDt[s] * (t1[i][j] + sSd[s] * yv[j] + t2[i][j]);
        }
        if (s < rows) *reinterpret_cast<float4*>(dx + (hrow + (size_t)s * H) * 64 + 4 * tx) = f4(o);
        r1 = row_sum(r1);
        r2 = row_sum(r2);
        if (tx == 0) {
          sR1[s] = r1;
          sR2[s] = r2;
        }
      }
    }

    // dC[t][n] = exp(la_t) (dY h)[t][n] + (dCB B)[t][n]; dla_t += that first term . C_t
    {
      float c3[4][4];
      zero(c3);
      mm<false, true>(c3, sY, sH, 0, 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        const float el = expf((float)sLa[t]);
        float cv[4], rc = 0.f;
        unpack(ld4(sC + sw(t, 4 * tx)), cv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c3[i][j] *= el;
          rc += c3[i][j] * cv[j];
        }
        rc = row_sum(rc);
        if (tx == 0) sDla[t] += rc;
      }
      mm<false, true>(c3, sD, sB, 0, 8 * warp + 8);   // dCB[t][s] = 0 for s past the warp's rows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        if (t < rows)
          *reinterpret_cast<float4*>(dc_heads + (hrow + (size_t)t * H) * 64 + 4 * tx) = f4(c3[i]);
      }
    }

    // dB[s][n] = exp(e - la_s) dt_s (X dH)[s][n] + (dCBᵀ C)[s][n]
    {
      float b7[4][4];
      zero(b7);
      mm<false, true>(b7, sX, sG, 0, 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * ty + i;
        const float f = exp_diff(e, sLa[s]) * sDt[s];
#pragma unroll
        for (int j = 0; j < 4; ++j) b7[i][j] *= f;
      }
      mm<true, true>(b7, sD, sC, 8 * warp, 64);   // dCB[t][s] = 0 for t before the warp's rows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * ty + i;
        if (s < rows)
          *reinterpret_cast<float4*>(db_heads + (hrow + (size_t)s * H) * 64 + 4 * tx) = f4(b7[i]);
      }
    }

    // <dH, h>
    {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float hv[4];
        unpack(ld4(sH + sw(4 * ty + i, 4 * tx)), hv);
#pragma unroll
        for (int j = 0; j < 4; ++j) part += dh[i][j] * hv[j];
      }
      part = warp_sum(part);
      if (lane == 0) sRed[warp] = part;
    }
    __syncthreads();   // dH, h, dCB and C read; sR1, sR2, sDla, sSd, sDg, sRed written

    // C's rows times exp(la_t), for dH
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      const float el = expf((float)sLa[t]);
      float v[4];
      unpack(ld4(sC + sw(t, 4 * tx)), v);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] *= el;
      st4(sC + sw(t, 4 * tx), f4(v));
    }
    // The gradient of each step's log decay dt_r a (warp 0): the pairs' and C's terms of the
    // rows from r to the end, the state entering (every r), the state's terms of the rows
    // before r; then ddt and da.
    if (warp == 0) {
      float hdot = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) hdot += sRed[w];
      const float entering = expf((float)e) * hdot;
      const int t0 = 2 * lane, t1 = 2 * lane + 1;
      const float d0 = sDla[t0] - sDt[t0] * sR1[t0];
      const float d1 = sDla[t1] - sDt[t1] * sR1[t1];
      const float q0 = sDt[t0] * sR2[t0], q1 = sDt[t1] * sR2[t1];
      float suf = d0 + d1, pre = q0 + q1;   // sums over lanes >= and <= this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(kFull, suf, o);
        const float v = __shfl_up_sync(kFull, pre, o);
        if (lane + o < 32) suf += u;
        if (lane >= o) pre += v;
      }
      float after = __shfl_down_sync(kFull, suf, 1);
      float before = __shfl_up_sync(kFull, pre, 1);
      if (lane == 31) after = 0.f;
      if (lane == 0) before = 0.f;
      const float g1 = (after + d1) + entering + (before + q0);
      const float g0 = (after + d1 + d0) + entering + before;
      if (t0 < rows) ddt[hrow + (size_t)t0 * H] = sR1[t0] + sDg[t0] + sR2[t0] + a * g0;
      if (t1 < rows) ddt[hrow + (size_t)t1 * H] = sR1[t1] + sDg[t1] + sR2[t1] + a * g1;
      da_acc += sDt[t0] * g0 + sDt[t1] * g1;
    }
    __syncthreads();   // C scaled

    // dH' = exp(e) dH + (dYᵀ (exp(la) o C))[p][n]
    const float ee = expf((float)e);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[i][j] *= ee;
    mm<true, true>(dh, sY, sC, 0, 64);
#pragma unroll
    for (int i = 0; i < 4; ++i) st4(sG + sw(4 * ty + i, 4 * tx), f4(dh[i]));
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dh0 + hd * kTile + (4 * ty + i) * 64 + 4 * tx) = f4(dh[i]);
  if (warp == 0) {
    da_acc = warp_sum(da_acc);
    if (lane == 0) da_rows[hd] = da_acc;
  }
}

int check_dims(int B, int L, int H, int G) {
  if (B < 0 || L < 0 || H < 0 || G <= 0 || H % G || B > 65535) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename K>
int attributes_of(K kern, size_t dynamic_smem, int* out) {
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)dynamic_smem;
  out[3] = at.maxThreadsPerBlock;
  out[4] = kThreads;
  out[5] = (int)at.localSizeBytes;
  return 0;
}

}  // namespace

// x (B, L, H, 64), dt (B, L, H), b and c (B, L, G, 64), a (H,), h0 (B, H, 64, 64), all
// float32 and contiguous -> y (B, L, H, 64) and the states (B, H, ceil(L / 64) + 1, 64,
// 64) entering each sub-chunk (the last the final state).  Returns a CUDA error.
extern "C" int repro_ssd_scan_forward(const void* x, const void* dt, const void* b, const void* c,
                                      const void* a, const void* h0, void* y, void* states,
                                      int B, int L, int H, int G, void* stream) {
  if (int e = check_dims(B, L, H, G)) return e;
  if (B == 0 || H == 0) return 0;
  const size_t bytes = fwd_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<<<dim3((unsigned)H, (unsigned)B), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(states), L, H, G);
  return (int)cudaGetLastError();
}

// The gradients from the forward's states, dy (B, L, H, 64) and dh (B, H, 64, 64, or
// null for zero): dx, ddt, each head's dB and dC (B, L, H, 64), dh0, and da per (b, h).
extern "C" int repro_ssd_scan_backward(const void* x, const void* dt, const void* b, const void* c,
                                       const void* a, const void* states, const void* dy,
                                       const void* dh, void* dx, void* ddt, void* db_heads,
                                       void* dc_heads, void* dh0, void* da_rows, int B, int L,
                                       int H, int G, void* stream) {
  if (int e = check_dims(B, L, H, G)) return e;
  if (B == 0 || H == 0) return 0;
  const size_t bytes = bwd_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<<<dim3((unsigned)H, (unsigned)B), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a), static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<const float*>(dh), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(db_heads), static_cast<float*>(dc_heads),
      static_cast<float*>(dh0), static_cast<float*>(da_rows), L, H, G);
  return (int)cudaGetLastError();
}

// The built kernel of `which` (0 forward, 1 backward): registers a thread, static shared
// bytes a block, the dynamic shared bytes its launch asks for, the most threads a block
// can take, the threads it launches with, spill bytes a thread.  Returns a CUDA error.
extern "C" int repro_ssd_scan_attributes(int which, int* out) {
  if (which == 0) return attributes_of(ssd_fwd_kernel, fwd_smem_bytes(), out);
  if (which == 1) return attributes_of(ssd_bwd_kernel, bwd_smem_bytes(), out);
  return (int)cudaErrorInvalidValue;
}
