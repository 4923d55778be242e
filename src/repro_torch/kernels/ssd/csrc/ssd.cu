// Mamba-2 SSD chunk kernel for Hopper (sm_90a).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libssd.so ssd.cu
// Bound to PyTorch through the plain C entry at the bottom (ctypes, see
// ../kernel.py and ../../build.py).  The entry takes device pointers, sizes
// and the caller's CUDA stream, launches on that stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// ssd_chunk  (replaces src/repro/kernels/ssd/kernel.py::ssd_chunk, body
//             _ssd_kernel: one grid cell per (batch-head, chunk) holding the
//             whole Q x Q decay-masked score block in VMEM)
//   Inputs, all f32 and contiguous: xdt (BH, S, P) = x * dt, adt (BH, S) =
//   A * dt, B and C (BH, S, N); S % Q == 0.  Per chunk of Q steps, with
//   l = inclusive cumsum(adt) over the chunk:
//     y_intra[t]   = sum_{s <= t} (C_t . B_s) exp(l_t - l_s) xdt_s   (Q, P)
//     state[n, p]  = sum_s B_s[n] exp(l_{Q-1} - l_s) xdt_s[p]        (N, P)
//   Outputs: y_intra (BH, S, P) and states (BH, S/Q, N, P), f32.
//   Takes P == 64, N % 32 == 0, Q % 64 == 0 (Mamba-2: P 64, N 128, Q 256).
//
//   Bound: operations.  At the serving shape (BH 48, S 4096, P 64, N 128,
//   Q 256) the causal products are about 12.9 GFLOP, 0.19 ms at 67 TFLOP/s
//   f32, against 328 MB moved, 0.10 ms at 3.35 TB/s.
//
//   Design: the TPU kernel's Q x Q f32 block is 256 KB at Q = 256, more than
//   the 227 KB a CTA may hold, so the t and s axes are tiled by 64.  The grid
//   is (Q/64 + N/32, S/Q, BH):
//   - a "y" CTA owns 64 rows t of one chunk.  It keeps C's rows in shared
//     memory (transposed) and its 64 x 64 y tile in registers (4 x 4 per
//     thread), and walks the s-tiles up to the diagonal only: per s-tile it
//     forms the 64 x 64 scores C B^T, applies the mask by selecting before
//     the exponential (s > t never reaches expf, so no inf meets a zero),
//     and accumulates scores . xdt.  Tiles above the diagonal are skipped.
//   - a "state" CTA owns 32 rows n of the chunk's state and walks every
//     s-tile, with exp(l_{Q-1} - l_s) folded into its B tile.
//   Every CTA recomputes the chunk's cumsum of adt (one warp: a serial run
//   per lane, then a shuffle scan), so its order of summation differs from
//   torch.cumsum: the plain version is matched to a tolerance, not bitwise.
//   Arithmetic is f32 FMA on the CUDA cores; no tensor cores, no TF32.
//   B and C repeat across the heads of a group; this kernel reads them once
//   per head, as the TPU kernel's interface gives them.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

constexpr int P = 64;            // head_dim: the one width the kernel takes
constexpr int TT = 64;           // t rows per y CTA; s rows per tile
constexpr int NS = 32;           // state rows per state CTA
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int SROW = TT + 4;     // padded row of the score tile

// l[0..Q) = inclusive cumsum of adt[0..Q).  Warp 0 scans; all threads wait.
__device__ void chunk_cumsum(const float* __restrict__ adt, float* l, int Q) {
  for (int i = threadIdx.x; i < Q; i += THREADS) l[i] = adt[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = Q / 32;
    float run = 0.f;
    for (int k = 0; k < per; ++k) {
      run += l[lane * per + k];
      l[lane * per + k] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    for (int k = 0; k < per; ++k) l[lane * per + k] += excl;
  }
  __syncthreads();
}

// dst[n][r] = src[r][n] for 64 rows r of width N (rows N floats apart).
// Consecutive threads take consecutive r, so the shared stores never clash.
__device__ void load_transposed(const float* __restrict__ src, float* dst,
                                int N) {
  const int n4s = N / 4;
  for (int f = threadIdx.x; f < TT * n4s; f += THREADS) {
    const int r = f % TT, n4 = f / TT;
    const float4 v = reinterpret_cast<const float4*>(src + (long long)r * N)[n4];
    dst[(n4 * 4 + 0) * TT + r] = v.x;
    dst[(n4 * 4 + 1) * TT + r] = v.y;
    dst[(n4 * 4 + 2) * TT + r] = v.z;
    dst[(n4 * 4 + 3) * TT + r] = v.w;
  }
}

// X[s][p] = xdt rows s0..s0+63 (P floats each).
__device__ void load_x(const float* __restrict__ src, float* X) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(X);
  for (int f = threadIdx.x; f < TT * P / 4; f += THREADS) d4[f] = s4[f];
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// One y CTA: rows t0..t0+63 of y_intra for this chunk.
__device__ void y_tile(const float* __restrict__ xdt,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       const float* l, float* smem, long long row0, int t0,
                       int N) {
  float* Ct = smem;               // [N][TT]   C^T of the t rows
  float* Bt = Ct + N * TT;        // [N][TT]   B^T of the s rows
  float* X = Bt + N * TT;         // [TT][P]   xdt of the s rows
  float* Sc = X + TT * P;         // [TT][SROW] masked, decayed scores
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_transposed(Cm + (row0 + t0) * N, Ct, N);
  float lt[4];
  for (int i = 0; i < 4; ++i) lt[i] = l[t0 + ty * 4 + i];
  float acc[4][4] = {};

  for (int s0 = 0; s0 <= t0; s0 += TT) {
    load_transposed(Bm + (row0 + s0) * N, Bt, N);
    load_x(xdt + (row0 + s0) * P, X);
    __syncthreads();

    float sc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(Ct + n * TT + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bt + n * TT + tx * 4);
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cr[i], br[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx * 4 + j;
        v[j] = (s <= t) ? sc[i][j] * expf(lt[i] - l[s]) : 0.f;
      }
      *reinterpret_cast<float4*>(Sc + (ty * 4 + i) * SROW + tx * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

    for (int s = 0; s < TT; s += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(Sc + (ty * 4 + i) * SROW + s);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 xv =
            *reinterpret_cast<const float4*>(X + (s + q) * P + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = lane4(sv[i], q);
          acc[i][0] = fmaf(a, xv.x, acc[i][0]);
          acc[i][1] = fmaf(a, xv.y, acc[i][1]);
          acc[i][2] = fmaf(a, xv.z, acc[i][2]);
          acc[i][3] = fmaf(a, xv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(y + (row0 + t0 + ty * 4 + i) * P + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// One state CTA: rows n0..n0+31 of this chunk's (N, P) state.
__device__ void state_tile(const float* __restrict__ xdt,
                           const float* __restrict__ Bm,
                           float* __restrict__ state, const float* l,
                           float* smem, long long row0, int n0, int Q,
                           int N) {
  float* Bd = smem;               // [TT][NS]  B[s][n0 + m] * exp(l_last - l_s)
  float* X = Bd + TT * NS;        // [TT][P]
  const int tid = threadIdx.x, tn = tid / 16, tp = tid % 16;
  const float llast = l[Q - 1];
  float acc[2][4] = {};

  for (int s0 = 0; s0 < Q; s0 += TT) {
    for (int f = tid; f < TT * NS / 4; f += THREADS) {
      const int r = f / (NS / 4), c4 = f % (NS / 4);
      float4 v = *reinterpret_cast<const float4*>(
          Bm + (row0 + s0 + r) * N + n0 + c4 * 4);
      const float d = expf(llast - l[s0 + r]);
      v.x *= d; v.y *= d; v.z *= d; v.w *= d;
      *reinterpret_cast<float4*>(Bd + r * NS + c4 * 4) = v;
    }
    load_x(xdt + (row0 + s0) * P, X);
    __syncthreads();
    for (int s = 0; s < TT; ++s) {
      const float2 b = *reinterpret_cast<const float2*>(Bd + s * NS + tn * 2);
      const float4 xv = *reinterpret_cast<const float4*>(X + s * P + tp * 4);
      acc[0][0] = fmaf(b.x, xv.x, acc[0][0]);
      acc[0][1] = fmaf(b.x, xv.y, acc[0][1]);
      acc[0][2] = fmaf(b.x, xv.z, acc[0][2]);
      acc[0][3] = fmaf(b.x, xv.w, acc[0][3]);
      acc[1][0] = fmaf(b.y, xv.x, acc[1][0]);
      acc[1][1] = fmaf(b.y, xv.y, acc[1][1]);
      acc[1][2] = fmaf(b.y, xv.z, acc[1][2]);
      acc[1][3] = fmaf(b.y, xv.w, acc[1][3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float4*>(state + (long long)(n0 + tn * 2 + i) * P +
                               tp * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ adt,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ states, int S,
                 int Q, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.y, bh = blockIdx.z, nc = S / Q, nt = Q / TT;
  const long long row0 = (long long)bh * S + (long long)c * Q;
  float* l = smem;                            // [Q], Q % 4 == 0: aligned
  chunk_cumsum(adt + row0, l, Q);
  if ((int)blockIdx.x < nt) {
    y_tile(xdt, Bm, Cm, y, l, smem + Q, row0, blockIdx.x * TT, N);
  } else {
    float* state = states + ((long long)bh * nc + c) * N * P;
    state_tile(xdt, Bm, state, l, smem + Q, row0,
               (blockIdx.x - nt) * NS, Q, N);
  }
}

size_t smem_bytes(int Q, int N) {
  const size_t y_cta = 2 * (size_t)N * TT + TT * P + TT * SROW;
  const size_t s_cta = (size_t)TT * NS + TT * P;
  return sizeof(float) * (Q + (y_cta > s_cta ? y_cta : s_cta));
}

}  // namespace

extern "C" int ssd_chunk_launch(const void* xdt, const void* adt,
                                const void* B, const void* C, void* y,
                                void* states, int bh, int s, int q, int p,
                                int n, void* stream) {
  if (p != P || q <= 0 || q % TT != 0 || s % q != 0 || n <= 0 ||
      n % NS != 0 || bh <= 0 || bh > 65535 || s / q > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(q, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(q / TT + n / NS, s / q, bh);
  ssd_chunk_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)xdt, (const float*)adt, (const float*)B, (const float*)C,
      (float*)y, (float*)states, s, q, n);
  return (int)cudaGetLastError();
}
