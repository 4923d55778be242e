// Flash attention kernels for Hopper (sm_90a).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Bound to PyTorch through the plain C entries at the bottom (ctypes, see
// ../kernel.py and ../../build.py).  The launch entry takes device
// pointers, sizes, element strides, the decode scratch and the caller's
// CUDA stream, launches on that stream, never synchronises, allocates
// nothing, and returns cudaGetLastError().  Two more report the decode
// body's limits (rows per KV head, splits), which the wrapper reads once,
// and launch the prefill's p split alone, for the checks.
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
//   as a streaming softmax in f32 whatever the input type, with p kept in
//   f32: running max m, normalizer l, accumulator acc; per KV tile alpha =
//   exp(m_prev - m_cur) rescales l and acc; the output is acc / max(l,
//   1e-30) in the input type.  Takes D % 32 == 0, D <= 256.
//
//   Rows.  A CTA's rows are the (position, head) pairs of one KV head's
//   query group, position-major, so K and V are read once per group (the
//   TPU kernel's index map) and a decode step of 8 heads fills 8 rows.
//   Keys at or past kv_valid land in shared memory as zeros (cp.async's
//   zero-fill, or TMA's out-of-bounds fill), so whatever a cache holds
//   there (even NaN) never meets a p of zero.  Masks are
//   selected before the exponential (-1e30, never -inf).  Three bodies:
//
//   1. Decode: at most 16 rows per (batch, KV head), both dtypes.  The KV
//      walk [0, kv_end) is cut into `splits` contiguous ranges of 64-key
//      tiles, one CTA each (the wrapper picks splits from the tile count
//      and the SM count: a tile a CTA, 25 CTAs for gemma at 1,600 rows; a
//      CTA's walk is latency-bound, not bandwidth-bound).  A CTA streams
//      its keys through a 2-stage cp.async ring (zero-fill past kv_valid),
//      does q k^T and p v as f32 FMAs on the CUDA cores (13 MFLOP per
//      call), and writes its partial (m, l, acc) in f32 to the wrapper's
//      scratch.  The
//      last CTA of the row group, elected by a ticket counter that it resets,
//      combines the partials in split order (never arrival order, so the
//      output is the same from run to run): M = max m_s, l = sum e^(m_s-M)
//      l_s, acc likewise.  Masked keys get p = 0, so a split that sees no
//      valid key (m = -1e30, l = 0) weighs nothing.  One launch per call.
//      On request the combining CTA also writes each row's log-sum-exp,
//      M + log l (-inf for a row that sees no key: then out = 0), and then
//      the output in f32 whatever the input type: a rank's partial over
//      its segment of a cache cut by sequence, which the caller combines
//      across ranks and rounds once.  kv_valid may then be 0 (a segment
//      that holds no valid key yet).
//   2. Prefill (more than 16 rows), bf16: tensor cores (wgmma).  A CTA of
//      2 warpgroups owns 128 rows, a warpgroup 64; the CTAs with the
//      longest KV walks launch first (the causal triangle).  Q and a
//      2-stage ring of 64-key K and V tiles stay bf16 in shared memory, in
//      wgmma's interleaved core-matrix layout (192 KB at D 256).  Q comes by
//      cp.async; K and V by TMA, one warp issuing a box per 16-byte column
//      chunk, completing on a per-stage mbarrier, so tile j+1 loads while
//      tile j is multiplied.  The tensor maps are encoded per call with
//      kv_valid as their row extent, so keys past it land as zeros (the
//      cache may hold anything there, even NaN, which must never meet a p
//      of zero).  S = Q K^T (m64n64k16, both operands from shared
//      memory) on bf16 operands is exact per product, summed in f32, then
//      scaled (gemma's 1/16 is exact).  p stays f32: it is split into three
//      bf16 parts, hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
//      mid); each subtraction is exact and the three 8-bit significands
//      cover p's 24 bits, so hi + mid + lo == p, and each part times a bf16
//      value of V is exact in f32.  p v = hi v + mid v + lo v: the parts
//      are wgmma's A operand in registers (the accumulator's layout), V the
//      B operand through the transposed-B descriptor, m64n64k16 (m64n32k16
//      for the last 32 columns when D % 64 == 32), summed in f32: the TPU
//      kernel's function up to the order of its sums, not SDPA's p rounded
//      to bf16.  The 64 x D f32 accumulator of a warpgroup is 128
//      registers a thread at D 256 (233 in all, no spills).
//   3. Prefill, f32 (the f32 checks only): f32 FMAs on the CUDA cores, a
//      CTA of 64 rows, Q scaled and K transposed in padded f32 shared
//      memory, V row-major in the K buffer.
//
//   Bound: operations at prefill, bytes at decode.  gemma_2b's prefill of
//   4,096 tokens (Hq 8, Hkv 1, D 256, causal; 8,390,656 valid pairs) is
//   34.4 GFLOP of q k^T plus 3 x 34.4 GFLOP of three-part p v, all on bf16
//   tensor cores: 0.139 ms at 989 TFLOP/s (38 MB moved is 0.011 ms).  A
//   decode step over 1,600 cached rows moves 1.65 MB: 0.49 us at 3.35 TB/s.
// ---------------------------------------------------------------------------

#include <cuda.h>                // CUtensorMap (header only: the encoder is
#include <cudaTypedefs.h>        // fetched through cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

constexpr int BN = 64;           // keys per KV tile
constexpr int THREADS = 256;
constexpr int PAD = 4;           // floats of padding per f32 shared row
constexpr int DEC_ROWS = 16;     // rows of a decode call per (batch, KV head)
constexpr int MAX_SPLITS = 128;  // CTAs per row group of a decode call
constexpr float NEG = -1e30f;    // a masked score

using bf16 = __nv_bfloat16;

struct Strides {                 // element strides; the D axis is contiguous
  long long b, h, s;
};

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// four bf16 (8 bytes) to f32, exactly: a bf16 is the top half of an f32
__device__ __forceinline__ void load4(const bf16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

// 16 bytes to f32: four f32, or eight bf16
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  load4(p, x);
}

__device__ __forceinline__ void load16(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (the source
// is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ===========================================================================
// 1. decode: the KV walk split across CTAs, combined in split order
// ===========================================================================

template <typename T, int NJ>
struct Dec {
  static constexpr int D = 32 * NJ;
  static constexpr int E = 16 / (int)sizeof(T);    // elements per 16 bytes
  static constexpr int SUB = sizeof(T) == 2 ? 64 : 32;  // keys per stage
  static constexpr int LD = D + E;                 // padded ring row
  static constexpr int RS = THREADS / SUB;         // row slots, q k^T
  static constexpr int RPT = DEC_ROWS / RS;        // rows a thread, q k^T
  static constexpr int CG = D / 4;                 // column groups, p v
  static constexpr int RV = THREADS / CG;          // row slots, p v
  static constexpr int RPV = (DEC_ROWS + RV - 1) / RV;
  static constexpr int SMEM_FLOATS = DEC_ROWS * D + DEC_ROWS * SUB + DEC_ROWS;
  static constexpr int BYTES =
      4 * SMEM_FLOATS + 2 * 2 * SUB * LD * (int)sizeof(T);
};

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, void* __restrict__ o,
                    Strides sq_, Strides sk, Strides sv, Strides so, int sq,
                    int group, int kv_valid, int kv_offset, int causal,
                    float scale, float* __restrict__ part,
                    int* __restrict__ tickets, float* __restrict__ lse) {
  using C = Dec<T, NJ>;
  constexpr int D = C::D, E = C::E, SUB = C::SUB, LD = C::LD, R = DEC_ROWS;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);    // [R][D], scaled
  float* Ps = Qs + R * D;                         // [R][SUB] scores, then p
  float* al = Ps + R * SUB;                       // [R] alpha of the stage
  T* ring = reinterpret_cast<T*>(al + R);         // [2][K, V][SUB][LD]
  __shared__ int last_cta;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, splits = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int grp = b * gridDim.y + kvh, n_rows = sq * group;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  // this split's keys: tiles [split * tps, (split + 1) * tps) of [0, kv_end)
  const int kv_end = causal ? min(kv_valid, sq + kv_offset) : kv_valid;
  const int tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;
  const int tps = (tiles + splits - 1) / splits;
  const int lo = min(split * tps * BN, max(kv_end, 0));
  const int hi = min((split + 1) * tps * BN, max(kv_end, 0));
  const int n_sub = (hi - lo + SUB - 1) / SUB;

  auto load_kv = [&](int k0, int stage) {
    T* ks = ring + stage * 2 * SUB * LD;
    T* vs = ks + SUB * LD;
    for (int i = tid; i < SUB * (D / E); i += THREADS) {
      const int r = i / (D / E), c = (i % (D / E)) * E, key = k0 + r;
      const bool ok = key < kv_valid;
      const long long row = ok ? key : 0;
      cp_async16(ks + r * LD + c, kb + row * sk.s + c, ok);
      cp_async16(vs + r * LD + c, vb + row * sv.s + c, ok);
    }
  };
  if (n_sub > 0) load_kv(lo, 0);
  cp_async_commit();
  // the Q rows, scaled, while the first stage lands
  for (int i = tid; i < R * (D / 4); i += THREADS) {
    const int r = i / (D / 4), d4 = (i % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_rows) {
      const int pos = r / group, h = kvh * group + r % group;
      load4(q + b * sq_.b + h * sq_.h + pos * sq_.s + d4, x);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) Qs[r * D + d4 + e] = x[e] * scale;
  }

  // warp w keeps the statistics of rows 2w and 2w + 1
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[C::RPV][4];
#pragma unroll
  for (int i = 0; i < C::RPV; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int c_s = tid % SUB, rs = tid / SUB;        // q k^T: key, row slot
  const int cg = tid % C::CG, rv = tid / C::CG;     // p v: columns, row slot

  for (int j = 0; j < n_sub; ++j) {
    const int k0 = lo + j * SUB, stage = j & 1;
    if (j + 1 < n_sub) load_kv(k0 + SUB, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = ring + stage * 2 * SUB * LD;
    const T* vs = ks + SUB * LD;

    // scores: a thread takes one key and RPT rows
    {
      float sc[C::RPT];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) sc[i] = 0.f;
      const T* kr = ks + c_s * LD;
#pragma unroll 2
      for (int d = 0; d < D; d += E) {
        float kk[E];
        load16(kr + d, kk);
#pragma unroll
        for (int i = 0; i < C::RPT; ++i)
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(
                Qs + (rs * C::RPT + i) * D + d + e);
            sc[i] = fmaf(qq.x, kk[e], sc[i]);
            sc[i] = fmaf(qq.y, kk[e + 1], sc[i]);
            sc[i] = fmaf(qq.z, kk[e + 2], sc[i]);
            sc[i] = fmaf(qq.w, kk[e + 3], sc[i]);
          }
      }
      const int key = k0 + c_s;
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        const int r = rs * C::RPT + i;
        const bool ok = key < hi &&
                        (!causal || key <= r / group + kv_offset);
        Ps[r * SUB + c_s] = ok ? sc[i] : NEG;
      }
    }
    __syncthreads();

    // online softmax of rows 2w, 2w + 1 across the warp; masked keys get 0
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * warp + rr;
      float x[SUB / 32];
      float mx = m[rr];
#pragma unroll
      for (int u = 0; u < SUB / 32; ++u) {
        x[u] = Ps[r * SUB + lane + 32 * u];
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[rr] - mx);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < SUB / 32; ++u) {
        const float p = x[u] == NEG ? 0.f : expf(x[u] - mx);
        Ps[r * SUB + lane + 32 * u] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[rr] = l[rr] * alpha + ps;
      m[rr] = mx;
      if (lane == 0) al[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p v: a thread takes 4 columns of RPV rows
    if (rv < C::RV) {
#pragma unroll
      for (int i = 0; i < C::RPV; ++i) {
        const int r = rv + i * C::RV;
        if (r >= R) break;
        const float a = al[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= a;
#pragma unroll 4
        for (int c = 0; c < SUB; ++c) {
          const float p = Ps[r * SUB + c];
          float vv[4];
          load4(vs + c * LD + cg * 4, vv);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();                  // the stage is free for reloading
  }

  // the partial: acc [groups][splits][R][D], then (m, l) [groups][splits][R]
  const long long slot = (long long)grp * splits + split;
  const long long n_slots = (long long)gridDim.z * gridDim.y * splits;
  float* pacc = part + slot * R * D;
  float2* pml = reinterpret_cast<float2*>(part + n_slots * R * D);
  if (rv < C::RV) {
#pragma unroll
    for (int i = 0; i < C::RPV; ++i) {
      const int r = rv + i * C::RV;
      if (r >= R) break;
      *reinterpret_cast<float4*>(pacc + r * D + cg * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  if (lane < 2) pml[slot * R + 2 * warp + lane] =
      make_float2(m[lane], l[lane]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last_cta = atomicAdd(tickets + grp, 1) == splits - 1;
  __syncthreads();
  if (!last_cta) return;
  __threadfence();

  // the last CTA of the group combines the splits in split order: (m, l)
  // of every split into shared memory (the ring, now idle) in one pass,
  // each row's weights e^(m_s - M) and normalizer there, then each
  // thread's columns over the splits with several loads in flight
  cp_async_wait<0>();
  const float* gacc = part + (long long)grp * splits * R * D;
  const float2* gml = pml + (long long)grp * splits * R;
  float* wts = reinterpret_cast<float*>(ring);     // [splits][R]: m, then w
  float* ls = wts + splits * R;                    // [splits][R]: l
  for (int i = tid; i < splits * R; i += THREADS) {
    const float2 ml = __ldcg(gml + i);
    wts[i] = ml.x;
    ls[i] = ml.y;
  }
  __syncthreads();
  if (tid < R) {
    float mx = NEG, den = 0.f;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, wts[s * R + tid]);
    for (int s = 0; s < splits; ++s) {
      const float w = expf(wts[s * R + tid] - mx);
      wts[s * R + tid] = w;
      den = fmaf(w, ls[s * R + tid], den);
    }
    al[tid] = fmaxf(den, 1e-30f);
    if (lse && tid < n_rows) {        // (B, Hq, Sq), contiguous
      const int pos = tid / group, h = kvh * group + tid % group;
      lse[((long long)b * gridDim.y * group + h) * sq + pos] =
          den > 0.f ? mx + logf(den) : __int_as_float(0xff800000);
    }
  }
  __syncthreads();
  if (rv < C::RV) {
#pragma unroll
    for (int i = 0; i < C::RPV; ++i) {
      const int r = rv + i * C::RV;
      if (r >= R || r >= n_rows) break;
      float out[4] = {0.f, 0.f, 0.f, 0.f};
      const float* src = gacc + r * D + cg * 4;
#pragma unroll 8
      for (int s = 0; s < splits; ++s) {
        const float w = wts[s * R + r];
        const float4 a = __ldcg(reinterpret_cast<const float4*>(
            src + (long long)s * R * D));
        out[0] = fmaf(w, a.x, out[0]);
        out[1] = fmaf(w, a.y, out[1]);
        out[2] = fmaf(w, a.z, out[2]);
        out[3] = fmaf(w, a.w, out[3]);
      }
      const float den = al[r];
      const int pos = r / group, h = kvh * group + r % group;
      const long long at = b * so.b + h * so.h + pos * so.s + cg * 4;
      if (lse) {                      // a partial: the output in f32
        float* dst = static_cast<float*>(o) + at;
        store2(dst, out[0] / den, out[1] / den);
        store2(dst + 2, out[2] / den, out[3] / den);
      } else {
        T* dst = static_cast<T*>(o) + at;
        store2(dst, out[0] / den, out[1] / den);
        store2(dst + 2, out[2] / den, out[3] / den);
      }
    }
  }
  if (tid == 0) tickets[grp] = 0;     // ready for the next call
}

// ===========================================================================
// 2. prefill, bf16: both products on tensor cores (wgmma)
// ===========================================================================

constexpr int TC_BM = 128;       // rows per CTA: 2 warpgroups of 64

// Q, K and V tiles in shared memory in the canonical interleaved layout of
// wgmma (no swizzle): 8 x 8 "core matrices" of 8 rows x 16 bytes, stored
// as 128 contiguous bytes.  Q (cp.async) is row-group-major: the 16-byte
// chunk c of row r is at ((r / 8) * CH + c) * 128 + (r % 8) * 16 bytes, so
// chunk i of the copy lands at i * 16 and a warp's reads cover whole
// 64-byte row pieces.  K and V (TMA) are chunk-major: chunk c of key r at
// (c * BN + r) * 16 bytes, one TMA box of 8 columns x 64 keys per chunk.
template <int NJ>
struct Tc {
  static constexpr int D = 32 * NJ;
  static constexpr int CH = D / 8;                 // 16-byte chunks per row
  // Q, the ring, two mbarriers, and slack to align the start to 128 bytes
  // (TMA's destinations must be)
  static constexpr int BYTES = 2 * D * (TC_BM + 2 * 2 * BN) + 16 + 128;
};

// a wgmma shared-memory descriptor, no swizzle: start address, then the
// byte strides between core matrices along K (lbo) and along M or N (sbo)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A B^T, m64n64k16: A (64 x 16) and B (64 x 16) K-major in shared
// memory, through their descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// d[O ...] += A B, m64n64k16: A (64 x 16) in registers, B (16 x 64) MN-major
// in shared memory (the transposed-B descriptor)
template <int N, int O>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[N],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d[O ...] += A B, m64n32k16: A (64 x 16) in registers, B (16 x 32) MN-major
// in shared memory (the transposed-B descriptor)
template <int N, int O>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[N],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// two f32 values as three bf16 pairs that sum back to them exactly
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}

// split3 over an f32 array, for the checks that hold it against the
// wrapper's `bf16_parts` bit for bit (the prefill never launches this):
// thread i splits p[2i], p[2i + 1] (0 past n) into pairs i of hi, mid, lo
__global__ void split3_kernel(const float* __restrict__ p,
                              uint32_t* __restrict__ hi,
                              uint32_t* __restrict__ mid,
                              uint32_t* __restrict__ lo, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (2 * i >= n) return;
  split3(p[2 * i], 2 * i + 1 < n ? p[2 * i + 1] : 0.f, hi[i], mid[i], lo[i]);
}

// acc (64 x D, this thread's D / 2) += P V for one 16-key slice of V: 64
// columns (8 chunks) per wgmma, and 32 for the last when D % 64 == 32
template <int NJ, size_t... I>
__device__ __forceinline__ void pv_slice(float (&acc)[16 * NJ],
                                         const uint32_t (&a)[4],
                                         const bf16* vs,
                                         std::index_sequence<I...>) {
  constexpr int LBO = 128, SBO = BN * 16;         // keys; columns
  (wgmma_rs_n64<16 * NJ, 32 * (int)I>(
       acc, a, gmma_desc(vs + 8 * BN * 8 * I, LBO, SBO)),
   ...);
  if constexpr (NJ % 2)
    wgmma_rs_n32<16 * NJ, 16 * (NJ - 1)>(
        acc, a, gmma_desc(vs + 8 * BN * 8 * (NJ / 2), LBO, SBO));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

template <int NJ>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const bf16* __restrict__ q, bf16* __restrict__ o,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, Strides sq_,
                Strides so, int sq, int group, int kv_valid, int kv_offset,
                int causal, float scale, int hkv, int n_blocks) {
  constexpr int D = Tc<NJ>::D, CH = Tc<NJ>::CH;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(             // [TC_BM / 8][CH][8][8]
      (reinterpret_cast<uintptr_t>(smem4) + 127) & ~uintptr_t(127));
  bf16* ring = Qs + TC_BM * D;                    // [2][K, V][CH][BN][8]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + 2 * 2 * BN * D);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  // the longest KV walks first: every (batch, KV head)'s last row block,
  // then the one before it, ...
  const int groups = gridDim.x / n_blocks;
  const int blk = n_blocks - 1 - (int)(blockIdx.x / groups);
  const int gi = blockIdx.x % groups, b = gi / hkv, kvh = gi % hkv;
  const int row0 = blk * TC_BM, n_rows = sq * group;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // chunk i of the Q tile: row (i / (8 CH)) * 8 + i % 8, chunk (i / 8) % CH
  for (int i = tid; i < TC_BM * CH; i += THREADS) {
    const int r = (i / (8 * CH)) * 8 + (i & 7), c = ((i >> 3) % CH) * 8;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    const bf16* src = q;
    if (ok) {
      const int pos = row / group, h = kvh * group + row % group;
      src = q + b * sq_.b + h * sq_.h + pos * sq_.s + c;
    }
    cp_async16(Qs + i * 8, src, ok);
  }
  int kv_end = kv_valid;
  if (causal)
    kv_end = min(kv_end, (min(row0 + TC_BM, n_rows) - 1) / group +
                             kv_offset + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  cp_async_commit();
  // K and V tiles by TMA, issued by warp 0, a chunk a lane; the maps end at
  // kv_valid, so keys past it land as zeros
  auto load_kv = [&](int k0, int stage) {
    if (warp != 0) return;
    if (lane == 0) mbar_expect_tx(kv_full + stage, 2 * BN * D * 2);
    __syncwarp();
    bf16* ks = ring + stage * 2 * BN * D;
    bf16* vs = ks + BN * D;
    for (int c = lane; c < CH; c += 32) {
      tma_load(ks + c * BN * 8, &tmk, c * 8, k0, kvh, b, kv_full + stage);
      tma_load(vs + c * BN * 8, &tmv, c * 8, k0, kvh, b, kv_full + stage);
    }
  };
  __syncthreads();                    // the barriers are initialised
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_wait<0>();                 // Q has landed ...
  fence_async_smem();                 // ... and is visible to wgmma
  __syncthreads();

  // a warp's 16 rows of its warpgroup's 64; this thread's are g and g + 8
  const int wr = warp * 16;
  const int qpos[2] = {(row0 + wr + g) / group, (row0 + wr + g + 8) / group};
  const int first_pos = row0 / group;
  const bf16* qw = Qs + wg * 8 * CH * 64;         // the warpgroup's rows
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // l: this thread's part
  float acc[16 * NJ];                 // [D / 8 n-tiles][4]
#pragma unroll
  for (int i = 0; i < 16 * NJ; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN, stage = j & 1;
    if (j + 1 < n_tiles) load_kv(k0 + BN, stage ^ 1);
    mbar_wait(kv_full + stage, (j >> 1) & 1);    // tile j has landed
    const bf16* ks = ring + stage * 2 * BN * D;
    const bf16* vs = ks + BN * D;

    // S = Q K^T: the warpgroup's 64 rows x 64 keys, D / 16 steps of 16
    float s[32];                      // [8 n-tiles of 8 keys][4]
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, gmma_desc(qw + kk * 2 * 64, 128, CH * 128),
                   gmma_desc(ks + kk * 2 * BN * 8, BN * 16, 128));
    wgmma_commit();
    wgmma_wait0();

    // scale, mask (only tiles that cross kv_valid or a diagonal), online
    // softmax; the 4 threads of a quad share a row
    const bool unmasked = k0 + BN <= kv_valid &&
                          (!causal || k0 + BN - 1 <= first_pos + kv_offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1, key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      float x = s[i] * scale;
      if (!unmasked && !(key < kv_valid &&
                     (!causal || key <= qpos[rr] + kv_offset)))
        x = NEG;
      s[i] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      alpha[rr] = expf(m[rr] - mx[rr]);
      m[rr] = mx[rr];
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      const float p = s[i] == NEG ? 0.f : expf(s[i] - m[rr]);
      s[i] = p;
      l[rr] += p;
    }
#pragma unroll
    for (int i = 0; i < 16 * NJ; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V with P in f32 as three bf16 parts (the A operand, in
    // registers, in the accumulator's layout), 16 keys a slice: all parts
    // first (s dies as they are made), then every product, then one wait
    uint32_t ph[BN / 16][4], pm[BN / 16][4], pl[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split3(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e],
               pm[kk][e], pl[kk][e]);
    constexpr auto cols = std::make_index_sequence<NJ / 2>{};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const bf16* vk = vs + kk * 2 * 64;          // keys 16 kk ...
      pv_slice<NJ>(acc, ph[kk], vk, cols);
      pv_slice<NJ>(acc, pm[kk], vk, cols);
      pv_slice<NJ>(acc, pl[kk], vk, cols);
    }
    wgmma_commit();
    wgmma_wait0();
    __syncthreads();                  // the stage is free for reloading
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float den = l[rr];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = row0 + wr + g + 8 * rr;
    if (row >= n_rows) continue;
    const int pos = row / group, h = kvh * group + row % group;
    bf16* dst = o + b * so.b + h * so.h + pos * so.s + 2 * t;
#pragma unroll
    for (int n = 0; n < 2 * NJ * 2; ++n)
      store2(dst + n * 8, acc[4 * n + 2 * rr] / den,
             acc[4 * n + 2 * rr + 1] / den);
  }
}

// ===========================================================================
// 3. prefill, f32: f32 FMAs on the CUDA cores
// ===========================================================================

constexpr int FMA_BM = 64;       // rows per CTA, 4 a thread

template <int NJ>
constexpr int fma_smem_floats() {
  constexpr int D = 32 * NJ;
  constexpr int kt = D * (BN + PAD), vs = BN * (D + PAD);
  return D * (FMA_BM + PAD)             // Qt [D][BM + PAD]
         + FMA_BM * (BN + PAD)          // P  [BM][BN + PAD]
         + (kt > vs ? kt : vs);         // Kt [D][BN + PAD] / V [BN][D + PAD]
}

template <int NJ>
__global__ void __launch_bounds__(THREADS)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides sq_, Strides sk, Strides sv, Strides so, int sq,
                 int group, int kv_valid, int kv_offset, int causal,
                 float scale) {
  constexpr int D = 32 * NJ, BM = FMA_BM;
  constexpr int RI = BM / 16;           // query rows per thread
  constexpr int QS = BM + PAD, PS = BN + PAD, KS = BN + PAD, VS = D + PAD;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* P = Qt + D * QS;
  float* KV = P + BM * PS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = blockIdx.x * BM, n_rows = sq * group;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

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
      const float4 t = *reinterpret_cast<const float4*>(Qt + d * QS + ty * 4);
      const float qv[RI] = {t.x, t.y, t.z, t.w};
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
    float* dst = o + b * so.b + h * so.h + pos * so.s;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store2(dst + j * 32 + tx * 2, acc[i][2 * j] / den,
             acc[i][2 * j + 1] / den);
  }
}

// ===========================================================================
// launch
// ===========================================================================

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides sq_, sk, sv, so;
  int b, hkv, sq, group, kv_valid, kv_offset, causal;
  float scale;
  int splits;
  float* part;
  int* tickets;
  float* lse;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared-memory limit once per device (not per
// launch: the call costs host time, and a CUDA graph's capture need not see
// it).  `done` is per kernel instance.
template <typename K>
int set_smem(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done[dev] = err == 0;
  return err;
}

template <typename T, int NJ>
int launch_decode(const Args& a) {
  const auto kernel = flash_decode_kernel<T, NJ>;
  const int bytes = Dec<T, NJ>::BYTES;
  static bool done[64];
  if (int err = set_smem(kernel, bytes, done)) return err;
  kernel<<<dim3(a.splits, a.hkv, a.b), THREADS, bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.o, a.sq_, a.sk, a.sv,
      a.so, a.sq, a.group, a.kv_valid, a.kv_offset, a.causal, a.scale, a.part,
      a.tickets, a.lse);
  return (int)cudaGetLastError();
}

using Encode = PFN_cuTensorMapEncodeTiled_v12000;

// the driver's tensor-map encoder, fetched once through the runtime, so the
// library links no libcuda of its own
Encode encoder() {
  static const Encode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(p)
               : nullptr;
  }();
  return fn;
}

// one call's K or V cache as a 4-d tensor map (D, kv_valid, Hkv, B), boxes
// of 8 columns x 64 keys: keys at or past kv_valid read as zeros.  The
// stride of a dimension of extent 1 is never stepped; 16 bytes will do.
int kv_map(CUtensorMap* map, const void* base, const Strides& st, int d,
           int kv_valid, int hkv, int b) {
  const Encode encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t s1 = 2 * st.s, s2 = hkv > 1 ? 2 * st.h : 16,
                   s3 = b > 1 ? 2 * st.b : 16;
  if (s1 % 16 || s2 % 16 || s3 % 16) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)kv_valid,
                              (cuuint64_t)hkv, (cuuint64_t)b};
  const cuuint64_t strides[3] = {s1, s2, s3};
  const cuuint32_t box[4] = {8, BN, 1, 1}, step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NJ>
int launch_tc(const Args& a) {
  const auto kernel = flash_tc_kernel<NJ>;
  const int bytes = Tc<NJ>::BYTES;
  static bool done[64];
  if (int err = set_smem(kernel, bytes, done)) return err;
  CUtensorMap tmk, tmv;
  if (int err = kv_map(&tmk, a.k, a.sk, 32 * NJ, a.kv_valid, a.hkv, a.b))
    return err;
  if (int err = kv_map(&tmv, a.v, a.sv, 32 * NJ, a.kv_valid, a.hkv, a.b))
    return err;
  const long long n_blocks = ((long long)a.sq * a.group + TC_BM - 1) / TC_BM;
  kernel<<<(unsigned)(n_blocks * a.hkv * a.b), THREADS, bytes, a.stream>>>(
      (const bf16*)a.q, (bf16*)a.o, tmk, tmv, a.sq_, a.so, a.sq, a.group,
      a.kv_valid, a.kv_offset, a.causal, a.scale, a.hkv, (int)n_blocks);
  return (int)cudaGetLastError();
}

template <int NJ>
int launch_fma(const Args& a) {
  const auto kernel = flash_fma_kernel<NJ>;
  const int bytes = (int)sizeof(float) * fma_smem_floats<NJ>();
  static bool done[64];
  if (int err = set_smem(kernel, bytes, done)) return err;
  const long long n_rows = (long long)a.sq * a.group;
  const dim3 grid((unsigned)((n_rows + FMA_BM - 1) / FMA_BM), a.hkv, a.b);
  kernel<<<grid, THREADS, bytes, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.sq_, a.sk, a.sv, a.so, a.sq, a.group, a.kv_valid, a.kv_offset,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, D / 32>) for D in 32, 64, ..., 256
template <typename F>
int with_nj(int d, F f) {
  switch (d / 32) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The decode body's limits, which the wrapper reads once: the most rows per
// (batch, KV head) of a call that it takes, and the most CTAs (splits) per
// row group.
extern "C" int flash_attention_decode_limits(int* rows, int* max_splits) {
  *rows = DEC_ROWS;
  *max_splits = MAX_SPLITS;
  return 0;
}

// dtype: 0 = f32, 1 = bf16.  Strides in elements, (batch, head, seq) of
// each tensor; the D axis of each is contiguous.  A call with at most `rows`
// rows per (batch, KV head) (Sq * Hq / Hkv <= rows, the decode limits above)
// is a decode call: it needs 1 <= `splits` <= `max_splits`, `scratch` of
// B * Hkv * splits * rows * (D + 2) floats and `tickets`, B * Hkv ints that
// are zero (each call leaves them zero).  Other calls ignore the three.
// Only a decode call takes `lse` (B * Hq * Sq floats, (B, Hq, Sq)
// contiguous: each row's log-sum-exp; the output `o` is then f32, its
// strides in f32 elements) or kv_valid = 0; other calls need null and
// kv_valid >= 1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int hq, int hkv, int sq, int d, int kv_valid, int kv_offset, int causal,
    float scale, long long q_b, long long q_h, long long q_s, long long k_b,
    long long k_h, long long k_s, long long v_b, long long v_h, long long v_s,
    long long o_b, long long o_h, long long o_s, int splits, void* scratch,
    void* tickets, void* lse, void* stream) {
  if (b <= 0 || b > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv != 0 ||
      sq <= 0 || d <= 0 || d > 256 || d % 32 != 0 || kv_valid < 0 ||
      (long long)sq * (hq / hkv) > (1LL << 31) - 256 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, {q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s},
               {o_b, o_h, o_s}, b, hkv, sq, hq / hkv, kv_valid, kv_offset,
               causal, scale, splits, (float*)scratch, (int*)tickets,
               (float*)lse, (cudaStream_t)stream};
  if ((long long)sq * a.group > DEC_ROWS && (lse || kv_valid == 0))
    return (int)cudaErrorInvalidValue;
  if ((long long)sq * a.group <= DEC_ROWS) {
    if (splits < 1 || splits > MAX_SPLITS || !scratch || !tickets)
      return (int)cudaErrorInvalidValue;
    return with_nj(d, [&](auto nj) {
      return dtype == 0 ? launch_decode<float, decltype(nj)::value>(a)
                        : launch_decode<bf16, decltype(nj)::value>(a);
    });
  }
  if ((long long)sq * a.group / TC_BM * b * hkv > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  return with_nj(d, [&](auto nj) {
    return dtype == 0 ? launch_fma<decltype(nj)::value>(a)
                      : launch_tc<decltype(nj)::value>(a);
  });
}

// p (n f32) into hi, mid and lo (n bf16 each, rounded up to an even count)
// with the prefill's split3; a check entry, no path of the wrapper's
// launches it.
extern "C" int flash_split3_launch(const void* p, void* hi, void* mid,
                                   void* lo, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long pairs = (n + 1) / 2;
  split3_kernel<<<(unsigned)((pairs + THREADS - 1) / THREADS), THREADS, 0,
                  (cudaStream_t)stream>>>((const float*)p, (uint32_t*)hi,
                                          (uint32_t*)mid, (uint32_t*)lo, n);
  return (int)cudaGetLastError();
}
