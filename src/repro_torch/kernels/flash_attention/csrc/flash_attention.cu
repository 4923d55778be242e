// Flash attention kernel for Hopper (sm_90a).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Bound to PyTorch through the plain C entry at the bottom (ctypes, see
// ../kernel.py and ../../build.py).  The entry takes device pointers, sizes,
// element strides and the caller's CUDA stream, launches on that stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// flash_attention  (replaces src/repro/kernels/flash_attention/kernel.py::
//                   flash_attention, body _fa_kernel: one grid cell per
//                   (batch-head, q block), KV blocks streamed along the
//                   sequential grid axis, running max / normalizer /
//                   accumulator in VMEM scratch)
//   q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D), all f32
//   or all bf16, addressed through (batch, head, seq) element strides with
//   the D axis contiguous: the model passes its (B, S, H, D) tensors and KV
//   caches as transposed views, so no layout copy is made per call.  Query
//   head h reads KV head h / (Hq / Hkv) (GQA, MQA).  For query row i the key
//   j is valid when j < kv_valid and, if causal, j <= i + kv_offset;
//   kv_valid and kv_offset are runtime arguments (a decode step moves them
//   every token without a rebuild).  Per row, over the valid keys:
//     out = softmax(scale * q k^T) v
//   as a streaming softmax in f32 whatever the input type: running max m,
//   normalizer l, accumulator acc; per KV tile alpha = exp(m_prev - m_cur)
//   rescales l and acc; the output is acc / max(l, 1e-30) in the input type.
//   Takes D % 32 == 0, D <= 256.
//
//   Bound: operations at prefill, bytes at decode.  gemma_2b's prefill of
//   4096 tokens (Hq 8, Hkv 1, D 256, causal) is 68.7 GFLOP of products,
//   half q k^T on bf16 operands (exact in f32, so 0.035 ms at the 989
//   TFLOP/s of bf16 tensor cores) and half p v with p in f32 (0.51 ms at
//   67 TFLOP/s f32): 0.55 ms, against 38 MB moved.  A decode step over
//   1,600 cached rows moves 1.6 MB (0.5 us at 3.35 TB/s) for 13 MFLOP.
//
//   Design: a CTA owns BM query rows of one (batch, KV head): the rows are
//   the (position, head) pairs of the KV head's query group, position-major,
//   so K and V are read once per group (the TPU kernel's index map) and a
//   decode step of 8 heads fills 8 rows.  BM is 64, or 16 when the call has
//   at most 16 rows (decode).  The CTA keeps its Q tile (pre-scaled) in
//   shared memory and walks 64-key tiles of K and V up to the last key its
//   rows may see (kv_valid, and the diagonal of its last row when causal),
//   so tiles above the diagonal and past kv_valid are never loaded.  Per
//   tile:
//   - S = Q K^T: 256 threads as 16 x 16, each RI x 4 scores (RI = BM / 16)
//     from float4 reads of Q and K held transposed in shared memory;
//   - the mask is selected before the exponential (masked scores become
//     -1e30, never -inf), the row max and sum are shuffle-reduced over the
//     16 threads of a row, and p goes to shared memory;
//   - O += P V into RI x (D / 16) accumulators in registers, V row-major in
//     shared memory (the K buffer, reused).
//   Keys at or past kv_valid are loaded as zeros, so whatever a cache holds
//   there (even NaN) never meets a p of zero.  The shared-memory rows are
//   padded by 4 floats against bank conflicts.  Arithmetic is f32 FMA on
//   the CUDA cores, with expf; no tensor cores, no TF32.  D = 256 needs
//   157 KB of shared memory at BM 64 (one CTA per SM), 95 KB at BM 16.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;           // keys per KV tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int PAD = 4;           // floats of padding per shared-memory row
constexpr float NEG = -1e30f;    // a masked score

struct Strides {                 // element strides; the D axis is contiguous
  long long b, h, s;
};

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// four bf16 (8 bytes) to f32, exactly: a bf16 is the top half of an f32
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int NJ, int BM>
constexpr int smem_floats() {
  constexpr int D = 32 * NJ;
  constexpr int kt = D * (BN + PAD), vs = BN * (D + PAD);
  return D * (BM + PAD)                 // Qt [D][BM + PAD]
         + BM * (BN + PAD)              // P  [BM][BN + PAD]
         + (kt > vs ? kt : vs);         // Kt [D][BN + PAD] / V [BN][D + PAD]
}

template <typename T, int NJ, int BM>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides sq_, Strides sk, Strides sv, Strides so,
                       int sq, int group, int kv_valid, int kv_offset,
                       int causal, float scale) {
  constexpr int D = 32 * NJ;
  constexpr int RI = BM / 16;           // query rows per thread
  constexpr int QS = BM + PAD, PS = BN + PAD, KS = BN + PAD, VS = D + PAD;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* P = Qt + D * QS;
  float* KV = P + BM * PS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = blockIdx.x * BM, n_rows = sq * group;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  // the Q tile, scaled, transposed: Qt[d][r]; rows past the end are zero
  for (int i = tid; i < BM * (D / 4); i += THREADS) {
    const int r = i % BM, d4 = (i / BM) * 4, row = row0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < n_rows) {
      const int pos = row / group, h = kvh * group + row % group;
      load4(q + b * sq_.b + h * sq_.h + pos * sq_.s + d4, x);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) Qt[(d4 + e) * QS + r] = x[e] * scale;
  }

  float m[RI], l[RI], acc[RI][2 * NJ];
  int qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    qpos[i] = (row0 + ty * RI + i) / group;
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) acc[i][j] = 0.f;
  }
  int kv_end = kv_valid;
  if (causal) {
    const int last = min(row0 + BM, n_rows) - 1;
    kv_end = min(kv_end, last / group + kv_offset + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();                    // Q stored / last tile's V read
    // K tile transposed: Kt[d][c], consecutive threads on consecutive keys
    for (int i = tid; i < BN * (D / 4); i += THREADS) {
      const int c = i % BN, d4 = (i / BN) * 4, key = k0 + c;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (key < kv_valid) load4(kb + key * sk.s + d4, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) KV[(d4 + e) * KS + c] = x[e];
    }
    __syncthreads();

    float sc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI];
      if constexpr (RI == 4) {
        const float4 t = *reinterpret_cast<const float4*>(Qt + d * QS + ty * 4);
        qv[0] = t.x; qv[1] = t.y; qv[2] = t.z; qv[3] = t.w;
      } else {
#pragma unroll
        for (int i = 0; i < RI; ++i) qv[i] = Qt[d * QS + ty * RI + i];
      }
      const float4 kk = *reinterpret_cast<const float4*>(KV + d * KS + tx * 4);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        sc[i][0] = fmaf(qv[i], kk.x, sc[i][0]);
        sc[i][1] = fmaf(qv[i], kk.y, sc[i][1]);
        sc[i][2] = fmaf(qv[i], kk.z, sc[i][2]);
        sc[i][3] = fmaf(qv[i], kk.w, sc[i][3]);
      }
    }

    // mask, online softmax; the 16 threads of a row group share its stats
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const bool ok = key < kv_valid && (!causal || key <= qpos[i] + kv_offset);
        sc[i][j] = ok ? sc[i][j] : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - mx);
        ps += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(P + (ty * RI + i) * PS + tx * 4) =
          make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
    }
    __syncthreads();                    // Kt read, P written

    // V tile row-major: V[c][d], coalesced along d
    for (int i = tid; i < BN * (D / 4); i += THREADS) {
      const int c = i / (D / 4), d4 = (i % (D / 4)) * 4, key = k0 + c;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (key < kv_valid) load4(vb + key * sv.s + d4, x);
      *reinterpret_cast<float4*>(KV + c * VS + d4) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BN; ++c) {
      float p[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = P[(ty * RI + i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 vv =
            *reinterpret_cast<const float2*>(KV + c * VS + j * 32 + tx * 2);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          acc[i][2 * j] = fmaf(p[i], vv.x, acc[i][2 * j]);
          acc[i][2 * j + 1] = fmaf(p[i], vv.y, acc[i][2 * j + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty * RI + i;
    if (row >= n_rows) continue;
    const int pos = row / group, h = kvh * group + row % group;
    T* dst = o + b * so.b + h * so.h + pos * so.s;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store2(dst + j * 32 + tx * 2, acc[i][2 * j] / den,
             acc[i][2 * j + 1] / den);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides sq_, sk, sv, so;
  int b, hkv, sq, group, kv_valid, kv_offset, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int NJ, int BM>
int launch(const Args& a) {
  const auto kernel = flash_attention_kernel<T, NJ, BM>;
  const int bytes = (int)sizeof(float) * smem_floats<NJ, BM>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_rows = (long long)a.sq * a.group;
  const dim3 grid((unsigned)((n_rows + BM - 1) / BM), a.hkv, a.b);
  kernel<<<grid, THREADS, bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.sq_, a.sk, a.sv,
      a.so, a.sq, a.group, a.kv_valid, a.kv_offset, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int BM>
int launch_d(const Args& a, int d) {
  switch (d / 32) {
    case 1: return launch<T, 1, BM>(a);
    case 2: return launch<T, 2, BM>(a);
    case 3: return launch<T, 3, BM>(a);
    case 4: return launch<T, 4, BM>(a);
    case 5: return launch<T, 5, BM>(a);
    case 6: return launch<T, 6, BM>(a);
    case 7: return launch<T, 7, BM>(a);
    case 8: return launch<T, 8, BM>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_t(const Args& a, int d) {
  return (long long)a.sq * a.group <= 16 ? launch_d<T, 16>(a, d)
                                         : launch_d<T, 64>(a, d);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Strides in elements, (batch, head, seq) of
// each tensor; the D axis of each is contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int hq, int hkv, int sq, int d, int kv_valid, int kv_offset, int causal,
    float scale, long long q_b, long long q_h, long long q_s, long long k_b,
    long long k_h, long long k_s, long long v_b, long long v_h, long long v_s,
    long long o_b, long long o_h, long long o_s, void* stream) {
  if (b <= 0 || b > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv != 0 ||
      sq <= 0 || d <= 0 || d > 256 || d % 32 != 0 || kv_valid <= 0 ||
      (long long)sq * (hq / hkv) > (1LL << 31) - 64)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, {q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s},
               {o_b, o_h, o_s}, b, hkv, sq, hq / hkv, kv_valid, kv_offset,
               causal, scale, (cudaStream_t)stream};
  if (dtype == 0) return launch_t<float>(a, d);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, d);
  return (int)cudaErrorInvalidValue;
}
