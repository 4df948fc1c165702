// K4: forward flash attention (causal, GQA, sliding window), for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention of src/repro/kernels/flash_attention.py
// (body _flash_kernel).  That kernel walks a sequential k grid axis and carries
// the running max m, the running sum l and the (bq, D) accumulator in VMEM
// scratch from one grid step to the next.  Blocks on a GPU run in parallel and
// in no order, so here one thread block owns one (b, h, 64-row q tile) and
// loops over the 64-key k tiles itself:
//
//   Q tile (scaled by 1/sqrt(D)), K tile and V tile staged in shared memory as
//   float32; S = Q K^T on a 16 x 16 grid of threads, each with a 4 x 4 register
//   tile; masks; online softmax with m, l per row in registers (row max and row
//   sum across the 16 threads of a row by warp shuffles); P through shared
//   memory; acc = acc * corr + P V with each thread's 4 rows x D/16 columns in
//   registers; at the end acc / l, with l == 0 -> 1.
//
// It keeps the TPU kernel's guards exactly: m_safe = 0 where the row max is
// still -1e30, corr = 0 where the previous max was -1e30, so a fully masked row
// writes 0 and never NaN.  With causal it skips the k tiles strictly above the
// diagonal, and with a window the k tiles wholly before it (a fully masked tile
// leaves m, l and acc unchanged, so skipping it is exact).  The kernel masks
// its own ragged q and k edges, so any Sq and Sk run.
//
// Bound: operations.  4 D FLOPs per allowed (q, k) pair against 2 D (bf16) or
// 4 D (f32) bytes per q or k row; at granite-8b's prefill shape the
// tensor-core floor is ~5x the memory floor.  This first kernel does its
// products as explicit float32 FMAs on the CUDA cores (both dtypes; fmaf, so
// the build's -fmad=false changes nothing here), with 16-byte shared-memory
// loads laid out to be free of bank conflicts and 16 or 32 independent FMA
// chains per thread; it cannot pass the CUDA-core rate (67 TFLOP/s).
// Tensor cores (mma.sync / wgmma) and TMA pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, H, KV, Sq, Sk, causal, has_window,
                                     window, st);
  return (int)cudaErrorInvalidValue;
}
