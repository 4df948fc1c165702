// K4: forward flash attention (causal, GQA, sliding window), for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention of src/repro/kernels/flash_attention.py
// (body _flash_kernel).  That kernel walks a sequential k grid axis and carries
// the running max m, the running sum l and the (bq, D) accumulator in VMEM
// scratch from one grid step to the next.  Blocks on a GPU run in parallel and
// in no order, so here one thread block owns one (b, h, q tile) and loops over
// the k tiles itself.  Both routes keep the TPU kernel's guards exactly:
// m_safe = 0 where the row max is still -1e30, corr = 0 where the previous max
// was -1e30, l == 0 -> 1, so a fully masked row writes 0 and never NaN.  With
// causal they skip the k tiles strictly above the diagonal, and with a window
// the k tiles wholly before it (a fully masked tile leaves m, l and acc
// unchanged, so skipping it is exact).  Each masks its own ragged q and k
// edges, so any Sq and Sk run.
//
// Bound: operations.  4 D FLOPs per allowed (q, k) pair against 2 D (bf16) or
// 4 D (f32) bytes per q or k row; at granite-8b's prefill shape the
// tensor-core floor is ~5x the memory floor.
//
// bfloat16 (flash_fwd_bf16_kernel): built around the tensor cores.
//   - Tiles: a block owns 128 q rows of one (b, h) and walks 128-key tiles.
//     Shared memory at D = 128: Q 32 KB and a 2-stage ring of K and V tiles
//     (32 KB each), 160 KB.  Blocks are launched longest causal q tile first,
//     and within one q tile index the H / KV query heads that share a KV head
//     are neighbours, so their K/V tiles are read from L2.
//   - Copies: Q, K and V tiles arrive by TMA (cp.async.bulk.tensor) through
//     3-D tensor maps (D, S, B * heads), so rows past Sq or Sk inside a head
//     are zero-filled by the hardware, with 128-byte swizzle (64-byte at
//     D = 32).  Each ring stage has a full barrier for K, one for V and one
//     empty barrier (mbarrier).  The maps are encoded on the host per call
//     through cuTensorMapEncodeTiled, fetched from the driver at run time.
//   - Warp specialisation: warpgroup 0 is the producer (one thread issues
//     every TMA load; setmaxnreg.dec to 24 registers); warpgroups 1 and 2
//     are consumers of 64 q rows each (setmaxnreg.inc to 240), so one
//     consumer's softmax overlaps the other's tensor-core work.
//   - S = Q K^T is wgmma m64n128k16 (bf16 x bf16 -> f32, exact products),
//     Q and K K-major from shared memory.  O += P V is wgmma with P from
//     registers (the f32 accumulator of S packs pairwise to bf16x2 in the
//     A-operand layout, no shuffles) and V from shared memory through the
//     B-transpose bit (V's tile is (keys, D), MN-major for B).
//   - P is split: P_hi = bf16(P), P_lo = bf16(P - P_hi), two PV wgmmas into
//     the same accumulator, so P keeps ~16 bits: a single bf16 rounding of P
//     misses the 2e-2 bar at large scores and outputs (q x8, v x8; see
//     tests/test_torch_flash_attention.py).  l is the f32 sum of the
//     unrounded P.  This costs 1.5x the tensor-core work of the least
//     4 D FLOPs per pair.
//   - Softmax in registers: exp2 with scale * log2(e) folded into one
//     explicit fmaf (the build has -fmad=false); row max and row sum across
//     the 4 threads that share a row of the wgmma accumulator; the mask is
//     applied only on tiles that need it (diagonal, window edge, ragged).
//   - Epilogue: O / l to bf16, stores masked by Sq; no atomics, so two calls
//     on the same inputs give the same bits.
//
// float32 (flash_fwd_kernel): both products as explicit float32 FMAs on the
// CUDA cores (TF32 would keep ~3 digits, short of the reference's 2e-5 bar):
// one 256-thread block per (b, h, 64-row q tile), 64-key tiles; Q (scaled by
// 1/sqrt(D)), K and V staged in shared memory as float32; S = Q K^T on a
// 16 x 16 grid of threads, each with a 4 x 4 register tile; online softmax
// with m, l per row in registers (row max and row sum across the 16 threads
// of a row by warp shuffles); P through shared memory; acc = acc * corr + P V
// with each thread's 4 rows x D/16 columns in registers; at the end acc / l.
// 16-byte shared-memory loads laid out to be free of bank conflicts and 16 or
// 32 independent FMA chains per thread; it cannot pass the CUDA-core rate
// (67 TFLOP/s).
#include <cuda.h>           // CUtensorMap and its enums (types only: no -lcuda)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32 route

constexpr int kBQ = 64;         // q rows per block
constexpr int kBK = 64;         // keys per k tile
constexpr int kThreads = 256;   // 16 x 16: ty owns 4 q rows, tx 4 keys and D/16 columns
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 4; }   // floats; 16-byte rows, spread banks

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)((kBQ + 2 * kBK) * row_stride<D>() + kBQ * kPStride);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// Rows row0 .. row0 + 63 of an (n_rows, D) matrix into a float32 tile with
// row stride D + 4, times `scale`; rows at or past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0, int n_rows,
                                          float scale, float* __restrict__ dst) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < 64 * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      f = load4(src + (size_t)(row0 + r) * D + c);
      f.x *= scale;
      f.y *= scale;
      f.z *= scale;
      f.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * row_stride<D>() + c) = f;
  }
}

// Output column c (0 <= c < D / 16) of thread tx: 4-wide groups at tx * 4 + 64 g
// when D >= 64 (16 threads read 256 contiguous bytes), else tx * 2 + c.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D >= 64) return (c >> 2) * 64 + tx * 4 + (c & 3);
  else return tx * (D / 16) + c;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int H, int KV, int Sq, int Sk, int causal,
                 int has_window, int window, float scale) {
  constexpr int S = row_stride<D>();
  constexpr int NC = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * S;
  float* Vs = Ks + kBK * S;
  float* Ps = Vs + kBK * S;

  // the longest causal q tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_off = ((size_t)b * H + h) * (size_t)Sq * D;
  const size_t kv_off = ((size_t)b * KV + kvh) * (size_t)Sk * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D>(q + q_off, q0, Sq, scale, Qs);

  // k tiles [kt_begin, kt_end): none strictly above the diagonal (causal),
  // none wholly before the window of the tile's first row
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (has_window) {
    const long long lo = (long long)q0 - window + 1;   // least key row q0 allows
    if (lo > 0) kt_begin = (int)min(lo / kBK, (long long)kt_end);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's reads of Ks, Vs, Ps are done
    load_tile<T, D>(k + kv_off, k0, Sk, 1.f, Ks);
    load_tile<T, D>(v + kv_off, k0, Sk, 1.f, Vs);
    __syncthreads();

    // s[i][j] = q[ty*4+i] . k[tx+16j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * S + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * S + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
    }

    // mask and online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Sk && (!causal || kpos <= qpos) && (!has_window || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        Ps[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float corr = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc[i][c] += sum_k P[ty*4+i][k] * V[k][out_col(c)]
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPStride + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vs + (kk + u) * S;
        float vv[NC];
        if constexpr (D >= 64) {
#pragma unroll
          for (int g = 0; g < NC / 4; ++g) {
            const float4 t = *reinterpret_cast<const float4*>(vr + g * 64 + tx * 4);
            vv[4 * g] = t.x;
            vv[4 * g + 1] = t.y;
            vv[4 * g + 2] = t.z;
            vv[4 * g + 3] = t.w;
          }
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vr + tx * 2);
          vv[0] = t.x;
          vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* o = out + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) store1(o + (size_t)r * D + out_col<D>(tx, c), acc[i][c] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
           int Sq, int Sk, int causal, int has_window, int window, cudaStream_t st) {
  const size_t bytes = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq,
                                      Sk, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
               int KV, int Sq, int Sk, int causal, int has_window, int window, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, H, KV, Sq, Sk, causal, has_window, window, st);
    case 64: return launch<T, 64>(q, k, v, out, B, H, KV, Sq, Sk, causal, has_window, window, st);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KV, Sq, Sk, causal, has_window, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 route

constexpr int kRows = 128;                        // q rows per block, keys per k tile
constexpr int kStages = 2;                        // depth of the K/V ring
constexpr int kConsumers = 2;                     // consumer warpgroups, 64 q rows each
constexpr int kThreadsTc = 128 * (1 + kConsumers);

// bytes of one swizzled shared-memory row (one TMA box row): 64 bf16 columns
// (128-byte swizzle) for D >= 64, 32 columns (64-byte swizzle) at D = 32
template <int D>
__host__ __device__ constexpr int swizzle_bytes() { return D >= 64 ? 128 : 64; }

template <int D>
__host__ __device__ constexpr int tile_bytes() { return kRows * D * 2; }

template <int D>
__host__ __device__ constexpr size_t smem_bytes_tc() {
  // Q, the K and V rings, the barriers, and slack to align the base to 1024
  return (size_t)(1 + 2 * kStages) * tile_bytes<D>() + 64 + 1024;
}

struct Barriers {
  uint64_t q, k[kStages], v[kStages], empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a 3-D map (column, row, head) into shared memory; completion
// is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma operands across the
// fence / wait instructions around them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (in 16-byte units) and the swizzle mode of the TMA map that
// filled it (1 = 128-byte, 2 = 64-byte)
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t mode = swizzle_bytes<D>() == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a, uint64_t b) {
  if constexpr (D == 128) wgmma_rs_n128(o, a, b);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, b);
  else wgmma_rs_n32(o, a, b);
}

// Shared-memory tiles: a 128-row tile is D / CB column blocks of 128 rows of
// SW bytes each (the TMA boxes), swizzled within 8-row atoms of 8 * SW bytes.
// Block index: the q tile index is the slowest, longest causal tile first;
// then b, then h, so query heads that share a KV head run side by side.
template <int D>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                      int H, int KV, int Sq, int Sk, int causal, int has_window, int window,
                      float scale_log2, int bh_total) {
  constexpr int SW = swizzle_bytes<D>();
  constexpr int CB = SW / 2;     // bf16 columns per box
  constexpr int NCB = D / CB;    // boxes per tile row
  constexpr int KPB = SW / 32;   // 16-column wgmma k-steps per box
  constexpr int TB = tile_bytes<D>();
  constexpr int NO = D / 2;      // O accumulator floats per consumer thread

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + TB;                     // stage s at k_s + s * TB
  uint8_t* v_s = smem + (1 + kStages) * TB;
  Barriers* bars = reinterpret_cast<Barriers*>(smem + (1 + 2 * kStages) * TB);

  const int t_idx = blockIdx.x / bh_total;
  const int bh = blockIdx.x - t_idx * bh_total;
  const int q0 = ((Sq + kRows - 1) / kRows - 1 - t_idx) * kRows;
  const int h = bh % H;
  const int bkv = (bh / H) * KV + h / (H / KV);

  // k tiles [kt_begin, kt_end): none strictly above the diagonal (causal),
  // none wholly before the window of the tile's first row; walked from the
  // last, so the masked diagonal tile comes first
  const int q_last = min(q0 + kRows, Sq) - 1;
  int kt_end = (Sk + kRows - 1) / kRows;
  if (causal) kt_end = min(kt_end, q_last / kRows + 1);
  int kt_begin = 0;
  if (has_window) {
    const long long lo = (long long)q0 - window + 1;   // least key row q0 allows
    if (lo > 0) kt_begin = (int)min(lo / kRows, (long long)kt_end);
  }
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(&bars->q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars->k[s], 1);
      mbar_init(&bars->v[s], 1);
      mbar_init(&bars->empty[s], 4 * kConsumers);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(&bars->q, TB);
#pragma unroll
      for (int c = 0; c < NCB; ++c) tma_load_3d(q_s + c * kRows * SW, &tm_q, &bars->q, c * CB, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        const int k0 = (kt_end - 1 - i) * kRows;
        mbar_wait(&bars->empty[s], phase ^ 1);
        mbar_expect_tx(&bars->k[s], TB);
#pragma unroll
        for (int c = 0; c < NCB; ++c)
          tma_load_3d(k_s + s * TB + c * kRows * SW, &tm_k, &bars->k[s], c * CB, k0, bkv);
        mbar_expect_tx(&bars->v[s], TB);
#pragma unroll
        for (int c = 0; c < NCB; ++c)
          tma_load_3d(v_s + s * TB + c * kRows * SW, &tm_v, &bars->v[s], c * CB, k0, bkv);
      }
    }
  } else {
    // consumers: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31;
    // this thread's rows in the wgmma accumulator layout: r and r + 8 of its
    // warp's 16; its columns 8 j + col, 8 j + col + 1
    const int qrow0 = q0 + cw * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const int qrow1 = qrow0 + 8;
    const int col = 2 * (lane & 3);

    float o[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;
    float l0 = 0.f, l1 = 0.f;   // this thread's share of the row sums
    const uint32_t q_addr = smem_u32(q_s) + cw * 64 * SW;
    if (n_tiles > 0) mbar_wait(&bars->q, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const int k0 = (kt_end - 1 - i) * kRows;
      const uint32_t k_addr = smem_u32(k_s + s * TB);
      const uint32_t v_addr = smem_u32(v_s + s * TB);

      // S = Q K^T (raw scores; the scale enters with the exponent)
      float sc[64];
      mbar_wait(&bars->k[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / KPB) * kRows * SW + (kk % KPB) * 32;
        wgmma_ss_n128(sc, smem_desc<D>(q_addr + off, 16, 8 * SW),
                      smem_desc<D>(k_addr + off, 16, 8 * SW), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the mask, only on tiles that need it
      const bool ragged = k0 + kRows > Sk;
      const bool diagonal = causal && k0 + kRows - 1 > q0;
      const bool edge = has_window && (long long)k0 <= (long long)q_last - window;
      if (ragged || diagonal || edge) {
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          const int kpos = k0 + 8 * (j >> 2) + col + (j & 1);
          const int qpos = (j & 2) ? qrow1 : qrow0;
          const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                          (!has_window || kpos > qpos - window);
          if (!ok) sc[j] = kNegInf;
        }
      }

      // online softmax: row max across the 4 threads that share a row
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        if (j & 2) mx1 = fmaxf(mx1, sc[j]);
        else mx0 = fmaxf(mx0, sc[j]);
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ms0 = mn0 <= kNegInf / 2 ? 0.f : mn0;
      const float ms1 = mn1 <= kNegInf / 2 ? 0.f : mn1;
      const float corr0 = m0 <= kNegInf / 2 ? 0.f : exp2_approx((m0 - ms0) * scale_log2);
      const float corr1 = m1 <= kNegInf / 2 ? 0.f : exp2_approx((m1 - ms1) * scale_log2);
      const float sub0 = ms0 * scale_log2, sub1 = ms1 * scale_log2;
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        // p = exp(scale * (s - m_safe)); a masked score (-1e30) gives exactly 0
        const float p = exp2_approx(fmaf(sc[j], scale_log2, (j & 2) ? -sub1 : -sub0));
        sc[j] = p;
        if (j & 2) rs1 += p;
        else rs0 += p;
      }
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] *= (j & 2) ? corr1 : corr0;

      // P as the A operand of 8 k-steps of 16 keys: accumulator elements
      // 8 t .. 8 t + 7 are exactly k-step t's A registers, pairwise; P is
      // split into a bf16 high part and the bf16 of the rest
      uint32_t p_hi[32], p_lo[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * j], sc[2 * j + 1]);
        const float2 back = __bfloat1622float2(hi);
        p_hi[j] = bf16x2_bits(hi);
        p_lo[j] = bf16x2_bits(__floats2bfloat162_rn(sc[2 * j] - back.x, sc[2 * j + 1] - back.y));
      }

      // O += P_hi V + P_lo V
      mbar_wait(&bars->v[s], phase);
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kRows / 16; ++t) {
        const uint64_t vd = smem_desc<D>(v_addr + t * 16 * SW, kRows * SW, 8 * SW);
        wgmma_pv<D>(o, &p_hi[4 * t], vd);
        wgmma_pv<D>(o, &p_lo[4 * t], vd);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars->empty[s]);
    }

#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    if (l0 == 0.f) l0 = 1.f;
    if (l1 == 0.f) l1 = 1.f;
    __nv_bfloat16* o0 = out + ((size_t)bh * Sq + qrow0) * D + col;
    __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (qrow0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
      if (qrow1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver at run time (so no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a 3-D map (D, rows, heads) over a contiguous (heads, rows, D) bf16 tensor;
// boxes of (box_cols, 128, 1), swizzled; rows past `rows` read as zeros
int encode_map(CUtensorMap* map, const void* base, int D, int rows, int heads, int box_cols,
               CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)kRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
                int Sq, int Sk, int causal, int has_window, int window, cudaStream_t st) {
  if (Sk == 0) return (int)cudaMemsetAsync(out, 0, (size_t)B * H * Sq * D * 2, st);
  constexpr int SW = swizzle_bytes<D>();
  const CUtensorMapSwizzle swizzle = SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v;
  int e = encode_map(&tm_q, q, D, Sq, B * H, SW / 2, swizzle);
  if (e == 0) e = encode_map(&tm_k, k, D, Sk, B * KV, SW / 2, swizzle);
  if (e == 0) e = encode_map(&tm_v, v, D, Sk, B * KV, SW / 2, swizzle);
  if (e != 0) return e;
  const long long blocks = (long long)((Sq + kRows - 1) / kRows) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes_tc<D>();
  auto kern = flash_fwd_bf16_kernel<D>;
  const cudaError_t ce =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (ce != cudaSuccess) return (int)ce;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  kern<<<(unsigned)blocks, kThreadsTc, bytes, st>>>(tm_q, tm_k, tm_v,
                                                    static_cast<__nv_bfloat16*>(out), H, KV, Sq,
                                                    Sk, causal, has_window, window, scale_log2,
                                                    B * H);
  return (int)cudaGetLastError();
}

int dispatch_bf16(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
                  int KV, int Sq, int Sk, int causal, int has_window, int window,
                  cudaStream_t st) {
  switch (D) {
    case 32: return launch_bf16<32>(q, k, v, out, B, H, KV, Sq, Sk, causal, has_window, window, st);
    case 64: return launch_bf16<64>(q, k, v, out, B, H, KV, Sq, Sk, causal, has_window, window, st);
    case 128: return launch_bf16<128>(q, k, v, out, B, H, KV, Sq, Sk, causal, has_window, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Sq, D), k/v: (B, KV, Sk, D), out: (B, H, Sq, D), all contiguous
// and 16-byte aligned; dtype 0 = float32, 1 = bfloat16; D in {32, 64, 128};
// H % KV == 0.  Query head h reads KV head h / (H / KV).  has_window = 0
// means no window; else keys k > q - window are allowed.  Returns
// cudaGetLastError() after the launch (0 = launched), or an error code for
// arguments the kernel does not take.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int H, int KV, int Sq, int Sk, int D,
                                     int causal, int has_window, int window, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV || Sk < 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, B, H, KV, Sq, Sk, causal, has_window, window, st);
  if (dtype == 1)
    return dispatch_bf16(D, q, k, v, out, B, H, KV, Sq, Sk, causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}

namespace {

// cudaFuncGetAttributes of one kernel into out[6], as in gossip_update.cu.
template <typename K>
int attributes_of(K kern, int threads, size_t dynamic_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)dynamic_smem;
  out[3] = a.maxThreadsPerBlock;
  out[4] = threads;
  out[5] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// The built route of dtype (0 = float32 on the CUDA cores, 1 = bfloat16 on
// the tensor cores) at head dim D (32, 64, 128): registers a thread, static
// shared bytes a block, the dynamic shared bytes its launch asks for
// (smem_bytes / smem_bytes_tc), the most threads a block can take, the
// threads it launches with, spill bytes a thread.  Returns a CUDA error.
extern "C" int repro_flash_attention_attributes(int dtype, int D, int* out) {
  if (dtype == 0) {
    switch (D) {
      case 32: return attributes_of(flash_fwd_kernel<float, 32>, kThreads, smem_bytes<32>(), out);
      case 64: return attributes_of(flash_fwd_kernel<float, 64>, kThreads, smem_bytes<64>(), out);
      case 128: return attributes_of(flash_fwd_kernel<float, 128>, kThreads, smem_bytes<128>(), out);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 32: return attributes_of(flash_fwd_bf16_kernel<32>, kThreadsTc, smem_bytes_tc<32>(), out);
    case 64: return attributes_of(flash_fwd_bf16_kernel<64>, kThreadsTc, smem_bytes_tc<64>(), out);
    case 128: return attributes_of(flash_fwd_bf16_kernel<128>, kThreadsTc, smem_bytes_tc<128>(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
