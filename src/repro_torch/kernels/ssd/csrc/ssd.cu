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
//   A * dt, and B and C (BH / hpg, S, N) per group of hpg heads: head i
//   reads group i / hpg (hpg = 1 is the reference's per-head interface).
//   S % Q == 0.  Per head and chunk of Q steps, with l = inclusive cumsum
//   of adt over the chunk:
//     y_intra[t]   = sum_{s <= t} (C_t . B_s) exp(l_t - l_s) xdt_s   (Q, P)
//     state[n, p]  = sum_s B_s[n] exp(l_{Q-1} - l_s) xdt_s[p]        (N, P)
//   Outputs: y_intra (BH, S, P) and states (BH, S/Q, N, P), f32.
//   Takes P == 64, N % 32 == 0 with N <= 128, Q % 64 == 0 with Q <= 256
//   (Mamba-2: P 64, N 128, Q 256).
//
//   Bound: bytes and tensor-core products about equally.  At mamba2_780m's
//   serving shape (BH 48 in one group, S 4096) the kernel moves 131 MB,
//   0.039 ms at 3.35 TB/s, and its products are 6.6 GFLOP, 0.040 ms as
//   three TF32 products each at 494.7 TFLOP/s.
//
//   Design.  The score block C B^T of a chunk depends on the group only;
//   a head adds just its decay mask exp(l_t - l_s) (adt = A dt is per
//   head).  So the kernel forms each 64 x 64 score tile once per CTA and
//   applies it to several heads of the group.  Every product runs on the
//   tensor cores as mma.sync.m16n8k8 TF32 with f32 accumulators, each f32
//   operand split as a = hi + lo (hi = tf32(a), lo = tf32(a - hi), both
//   rounded to nearest) and a.b formed as lo.hi + hi.lo + hi.hi ("3xTF32"):
//   within a few f32 roundings of the f32 product, where one TF32 pass
//   (11-bit operands, about 2.4e-4 relative) breaks the 3e-4 tolerance.
//   mma.sync takes its operands from registers, so both s-contractions read
//   their tiles from shared memory in whatever order they need, with no
//   transposed copy.  (A variant with the masked and the state products on
//   wgmma, its B operands split once a stage into K-major TF32 planes in
//   shared memory, was only slightly faster: the stage loop, not the
//   tensor pipe, bounds that one.)  Every tile arrives by cp.async (16
//   bytes a thread, rows padded so each fragment read is free of bank
//   conflicts).
//   One launch, 256 threads (8 warps) a CTA, one CTA an SM, each warp
//   owning 32 rows (two m16 tiles, so each split B operand serves two
//   products, and the two tiles' products interleave), in two roles:
//   - a "y" CTA owns 64 rows t of one chunk of one group and hpc heads of
//     it.  Phase 1 computes the score tiles C_t B_s^T for every s-tile up to
//     the diagonal (a ring of B tiles, C resident) into shared memory in
//     the accumulators' fragment order.  Phase 2 walks the heads four at a
//     time, one per pair of warps (fewer heads split the 64 columns p): a
//     warp reads its 32 rows of each score tile straight back as the A
//     operand of (scores o M_h) . xdt_h, the mask applied in registers
//     (exp2 of the head's log2-scaled cumsum; s > t selected away on the
//     diagonal tile), while a ring brings those heads' xdt tiles.  The
//     accumulator order of an m16n8 tile holds columns (2c, 2c + 1) where
//     the A operand wants (c, c + 4); the k index of a product is free, so
//     B is read with the same permutation of its 8 rows instead of moving
//     any register.
//     hpc is the largest multiple of 4 dividing hpg (at most 16) that still
//     gives two CTAs of either role per SM: at the serving shape hpc = 16,
//     so each chunk's scores are formed hpg / hpc = 3 times, not 48 (per
//     head, as the reference's interface would): 2 N / (P hpc) = 12.5% more
//     products than the y CTAs' masked products alone, about 6% of the
//     kernel's (hpc = 4 measured 16% slower there, 8 2% slower).  Every y
//     CTA forms its own scores, so no CTA waits on another.
//   - a "state" CTA owns one chunk of the group and two heads (one if hpg
//     is odd): its warps split the N rows of state, a ring brings the
//     group's B tile once with both heads' xdt tiles, and each B^T operand
//     serves both heads' warps; the decay exp(l_{Q-1} - l_s) scales xdt on
//     the way into the product.  (Splitting the decayed xdt once a stage
//     into shared memory, for all four row warps of a head, was tried and
//     was not faster: the products bound these CTAs, not the splits.)
//   CTAs go out heaviest first: the y CTAs of the lower t-tiles (more
//   s-tiles under the diagonal), then the state CTAs, then the rest.
//   Each CTA computes its heads' cumsum of adt itself (a warp each: a
//   serial run per lane, then a shuffle scan), so its order of summation
//   differs from torch.cumsum: the plain version is matched to a
//   tolerance, not bitwise.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;            // head_dim: the one width the kernel takes
constexpr int TT = 64;           // t rows per y CTA; s rows per tile
constexpr int N_MAX = 128;       // state width the shared memory plan takes
constexpr int Q_MAX = 256;       // chunk the shared memory plan takes
constexpr int HPC_MAX = 16;      // heads per y CTA
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LDX = P + 4;       // y: xdt rows; (2c rows) x 68 = 8c banks
constexpr int LDXS = P + 8;      // state: xdt rows; c rows x 72 = 8c banks
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// rows x (width floats) from global (rows `gstride` floats apart) into
// shared memory (rows `ld` floats apart), 16 bytes a thread and step
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* __restrict__ src,
                                           long long gstride, int rows,
                                           int width) {
  const int w4 = width / 4;
  for (int f = threadIdx.x; f < rows * w4; f += THREADS) {
    const int r = f / w4, c = (f % w4) * 4;
    cp_async16(dst + r * ld + c, src + r * gstride + c);
  }
}

// --- 3xTF32 on mma.sync -----------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[m] += a[m] . b for two m16 tiles a[0], a[1] (each ah + al) and one
// k8 x n8 tile b = (b0, b1), split here; the small terms first, and the
// two tiles' products interleaved so no mma waits on the one before it
__device__ __forceinline__ void mma3x2(float (*d)[4], const uint32_t (*ah)[4],
                                       const uint32_t (*al)[4], float b0,
                                       float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split(b0, b0h, b0l);
  split(b1, b1h, b1l);
  mma_tf32(d[0], al[0], b0h, b1h);
  mma_tf32(d[1], al[1], b0h, b1h);
  mma_tf32(d[0], ah[0], b0l, b1l);
  mma_tf32(d[1], ah[1], b0l, b1l);
  mma_tf32(d[0], ah[0], b0h, b1h);
  mma_tf32(d[1], ah[1], b0h, b1h);
}

__device__ __forceinline__ void split4(const float* a, uint32_t* ah,
                                       uint32_t* al) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
}

// l2[0..len) = log2(e) * inclusive cumsum of adt[0..len), by one warp: a
// serial run of len / 32 values per lane, then a shuffle scan of the runs
__device__ void warp_cumsum_log2(const float* __restrict__ adt, float* l2,
                                 int len) {
  const int lane = threadIdx.x & 31, per = len / 32, base = lane * per;
  float run = 0.f;
  for (int k = 0; k < per; ++k) {
    run += adt[base + k];
    l2[base + k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int k = 0; k < per; ++k) l2[base + k] = (l2[base + k] + excl) * LOG2E;
  __syncwarp();
}

struct Args {
  const float* xdt;
  const float* adt;
  const float* B;
  const float* C;
  float* y;
  float* states;
  int S, Q, N, hpg;
  int hpc, hps;          // heads per y CTA, per state CTA
  int ycols;             // y CTAs per t-tile: groups x chunks x hpg / hpc
  int heavy;             // t-tiles whose y CTAs go before the state CTAs
  int nstate;            // state CTAs: groups x chunks x hpg / hps
};

// --- the y role -----------------------------------------------------------
//
// Shared memory: l2 [hpc][Q] | scores [T][4][8][32] float4 | region R, which
// phase 1 uses as C [64][N + 4] + a 2-stage ring of B [64][N + 4], and
// phase 2 as a 2-stage ring of HPP xdt tiles [64][68].
// A warp owns 32 rows t (two m16 tiles, rh) in both phases.  Phase 1: 16
// columns s (cq) of each score tile.  Phase 2: NT8 n8 tiles (8 columns p
// each) of one head: 8 (four heads at a time, all 64 columns), 4 (two
// heads, half the columns each) or 2 (one head, a quarter each).

template <int NT8>
__device__ void y_role(const Args& a, float* smem, int g, int c, int hb,
                       int ti) {
  constexpr int HPP = NT8 / 2;            // heads a pass
  constexpr int PSL = 4 / HPP;            // column slices per head
  const int Q = a.Q, N = a.N, T = Q / TT, hpc = a.hpc;
  const int ld = N + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rh = warp & 1, wq = warp >> 1;
  const int t0 = ti * TT;
  const int ns = ti + 1;                  // s-tiles up to the diagonal
  const long long grow = (long long)g * a.S + (long long)c * Q;  // B, C row
  const int bh0 = g * a.hpg + hb * hpc;   // first head of this CTA

  float* l2s = smem;                                  // [hpc][Q]
  float4* sc = reinterpret_cast<float4*>(l2s + hpc * Q);  // [T][4][8][32]
  float* R = reinterpret_cast<float*>(sc + T * 4 * 8 * 32);
  float* Cs = R;                                      // [64][ld]
  float* Bs = R + TT * ld;                            // [2][64][ld]

  // phase 1: C resident, B tiles in a ring; the cumsums meanwhile
  stage_rows(Cs, ld, a.C + (grow + t0) * N, N, TT, N);
  stage_rows(Bs, ld, a.B + grow * N, N, TT, N);
  cp_async_commit();
  for (int h = warp; h < hpc; h += WARPS)
    warp_cumsum_log2(a.adt + (long long)(bh0 + h) * a.S + (long long)c * Q,
                     l2s + h * Q, ns * TT);

  for (int j = 0; j < ns; ++j) {
    if (j + 1 < ns) {
      stage_rows(Bs + ((j + 1) & 1) * TT * ld, ld,
                 a.B + (grow + (j + 1) * TT) * N, N, TT, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Bt = Bs + (j & 1) * TT * ld;
    float acc[2][2][4] = {};                // [n8 tile][m16 tile]
    const float* crow = Cs + (rh * 32 + gid) * ld + tig;
    const float* brow = Bt + (wq * 16 + gid) * ld + tig;
    for (int k0 = 0; k0 < N; k0 += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* cr = crow + mt * 16 * ld + k0;
        const float av[4] = {cr[0], cr[8 * ld], cr[4], cr[8 * ld + 4]};
        split4(av, ah[mt], al[mt]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* br = brow + i * 8 * ld + k0;
        mma3x2(acc[i], ah, al, br[0], br[4]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        sc[((j * 4 + rh * 2 + mt) * 8 + wq * 2 + i) * 32 + lane] =
            make_float4(acc[i][mt][0], acc[i][mt][1], acc[i][mt][2],
                        acc[i][mt][3]);
    __syncthreads();
  }

  // phase 2: per pass, HPP heads; per head, the s-tiles up to the diagonal
  const int hp = wq / PSL, ps = wq % PSL;
  const int npass = hpc / HPP, nstage = npass * ns;
  float* Xs = R;                                      // [2][HPP][64][LDX]
  auto issue = [&](int it) {
    const int pi = it / ns, j = it % ns;
    float* dst = Xs + (it & 1) * HPP * TT * LDX;
    for (int h = 0; h < HPP; ++h) {
      const long long row =
          (long long)(bh0 + pi * HPP + h) * a.S + (long long)c * Q + j * TT;
      stage_rows(dst + h * TT * LDX, LDX, a.xdt + row * P, P, TT, P);
    }
    cp_async_commit();
  };
  issue(0);
  float acc[NT8][2][4] = {};              // [n8 tile][m16 tile]
  const int tl0 = rh * 32 + gid;          // this thread's first row, in tile
  for (int it = 0; it < nstage; ++it) {
    if (it + 1 < nstage) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int pi = it / ns, j = it % ns;
    const int hh = pi * HPP + hp;
    const float* l2 = l2s + hh * Q;
    float lt[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      lt[mt][0] = l2[t0 + tl0 + mt * 16];
      lt[mt][1] = l2[t0 + tl0 + mt * 16 + 8];
    }
    const float* X =
        Xs + ((it & 1) * HPP + hp) * TT * LDX + ps * NT8 * 8 + gid;
    const float4* srow = sc + (j * 4 + rh * 2) * 8 * 32 + lane;
    for (int q = 0; q < 8; ++q) {
      const int sl = q * 8 + 2 * tig;     // this thread's two columns s
      const float la = l2[j * TT + sl], lb = l2[j * TT + sl + 1];
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float4 s4 = srow[(mt * 8 + q) * 32];
        const int r0 = tl0 + mt * 16;     // rows r0, r0 + 8 of the tile
        // A fragment with k permuted: (a0, a2) = columns (2c, 2c + 1)
        float pv[4] = {s4.x * exp2f(lt[mt][0] - la),
                       s4.z * exp2f(lt[mt][1] - la),
                       s4.y * exp2f(lt[mt][0] - lb),
                       s4.w * exp2f(lt[mt][1] - lb)};
        if (j == ti) {
          if (sl > r0) pv[0] = 0.f;
          if (sl > r0 + 8) pv[1] = 0.f;
          if (sl + 1 > r0) pv[2] = 0.f;
          if (sl + 1 > r0 + 8) pv[3] = 0.f;
        }
        split4(pv, ah[mt], al[mt]);
      }
      const float* xr = X + sl * LDX;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
        mma3x2(acc[nt], ah, al, xr[nt * 8], xr[LDX + nt * 8]);
    }
    if (j == ti) {                        // this head's rows are done
      float* yo = a.y + ((long long)(bh0 + hh) * a.S + (long long)c * Q +
                         t0 + tl0) * P + ps * NT8 * 8 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* o = yo + mt * 16 * P + nt * 8;
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[nt][mt][0], acc[nt][mt][1]);
          *reinterpret_cast<float2*>(o + 8 * P) =
              make_float2(acc[nt][mt][2], acc[nt][mt][3]);
          acc[nt][mt][0] = acc[nt][mt][1] = acc[nt][mt][2] =
              acc[nt][mt][3] = 0.f;
        }
    }
    __syncthreads();
  }
}

size_t y_smem_bytes(int Q, int N, int hpc, int nt8) {
  const size_t phase1 = 3 * (size_t)TT * (N + 4);
  const size_t phase2 = 2 * (size_t)(nt8 / 2) * TT * LDX;
  return sizeof(float) * ((size_t)hpc * Q + (size_t)(Q / TT) * 4 * 8 * 32 * 4 +
                          (phase1 > phase2 ? phase1 : phase2));
}

// --- the state role ---------------------------------------------------------
//
// Shared memory: d [hps][Q] (the decay to the chunk's end) | a 2-stage ring
// of B [64][N + 8] and hps xdt tiles [64][72].  A warp owns 32 rows n (two
// m16 tiles); with two heads, warps 0-3 take one and 4-7 the other (NTS =
// 8 column tiles), with one head they split its 64 columns (NTS = 4).

template <int NTS>
__device__ void state_role(const Args& a, float* smem, int g, int c,
                           int sb) {
  const int Q = a.Q, N = a.N, T = Q / TT, hps = a.hps;
  const int ldb = N + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nw = warp & 3, cs = warp >> 2;
  const int head = NTS == 8 ? cs : 0;
  const int p0 = NTS == 8 ? 0 : cs * 32;
  const bool active = nw * 32 < N;
  const long long grow = (long long)g * a.S + (long long)c * Q;
  const int bh0 = g * a.hpg + sb * hps;

  float* ds = smem;                                   // [hps][Q]
  float* ring = ds + hps * Q;
  const int stage_floats = TT * ldb + hps * TT * LDXS;

  auto issue = [&](int j) {
    float* dst = ring + (j & 1) * stage_floats;
    stage_rows(dst, ldb, a.B + (grow + j * TT) * N, N, TT, N);
    for (int h = 0; h < hps; ++h) {
      const long long row =
          (long long)(bh0 + h) * a.S + (long long)c * Q + j * TT;
      stage_rows(dst + TT * ldb + h * TT * LDXS, LDXS, a.xdt + row * P, P,
                 TT, P);
    }
    cp_async_commit();
  };
  issue(0);
  for (int h = warp; h < hps; h += WARPS) {
    float* d = ds + h * Q;
    warp_cumsum_log2(a.adt + (long long)(bh0 + h) * a.S + (long long)c * Q,
                     d, Q);
    const float last = d[Q - 1];
    __syncwarp();
    for (int s = lane; s < Q; s += 32) d[s] = exp2f(last - d[s]);
  }

  float acc[NTS][2][4] = {};              // [n8 tile][m16 tile]
  const float* d = ds + head * Q;
  for (int j = 0; j < T; ++j) {
    if (j + 1 < T) {
      issue(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* Bt = ring + (j & 1) * stage_floats;
      const float* X = Bt + TT * ldb + head * TT * LDXS + p0 + gid;
      const float* bn = Bt + nw * 32 + gid;       // column n of B
      for (int q = 0; q < 8; ++q) {
        const int s = q * 8 + tig;
        // A = B^T: rows n (gid, gid + 8 of each m16 tile), k = s (tig,
        // tig + 4)
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* b = bn + mt * 16;
          const float av[4] = {b[s * ldb], b[s * ldb + 8], b[(s + 4) * ldb],
                               b[(s + 4) * ldb + 8]};
          split4(av, ah[mt], al[mt]);
        }
        const float da = d[j * TT + s], db = d[j * TT + s + 4];
        const float* xr = X + s * LDXS;
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt)
          mma3x2(acc[nt], ah, al, xr[nt * 8] * da, xr[4 * LDXS + nt * 8] * db);
      }
    }
    __syncthreads();
  }
  if (active) {
    const int nc = a.S / Q;
    float* so = a.states +
                (((long long)(bh0 + head) * nc + c) * N + nw * 32 + gid) * P +
                p0 + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float* o = so + mt * 16 * P + nt * 8;
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[nt][mt][0], acc[nt][mt][1]);
        *reinterpret_cast<float2*>(o + 8 * P) =
            make_float2(acc[nt][mt][2], acc[nt][mt][3]);
      }
  }
}

size_t state_smem_bytes(int Q, int N, int hps) {
  const size_t stage = (size_t)TT * (N + 8) + (size_t)hps * TT * LDXS;
  return sizeof(float) * ((size_t)hps * Q + 2 * stage);
}

// One launch, both roles: the y CTAs of the `heavy` lower t-tiles, then the
// state CTAs, then the other y CTAs.
template <int NT8>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nc = a.S / a.Q, T = a.Q / TT;
  int b = blockIdx.x, ti;
  if (b < a.heavy * a.ycols) {
    ti = T - 1 - b / a.ycols;
  } else if ((b -= a.heavy * a.ycols) < a.nstate) {
    const int per = a.hpg / a.hps;
    const int sb = b % per, gc = b / per;
    if (a.hps == 2)
      state_role<8>(a, smem, gc / nc, gc % nc, sb);
    else
      state_role<4>(a, smem, gc / nc, gc % nc, sb);
    return;
  } else {
    b -= a.nstate;
    ti = T - 1 - a.heavy - b / a.ycols;
  }
  const int col = b % a.ycols, per = a.hpg / a.hpc;
  const int hb = col % per, gc = col / per;
  y_role<NT8>(a, smem, gc / nc, gc % nc, hb, ti);
}

template <int NT8>
int launch(const Args& a, cudaStream_t stream) {
  const size_t yb = y_smem_bytes(a.Q, a.N, a.hpc, NT8);
  const size_t sb = state_smem_bytes(a.Q, a.N, a.hps);
  const size_t bytes = yb > sb ? yb : sb;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)(a.Q / TT) * a.ycols + a.nstate;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_chunk_kernel<NT8><<<(unsigned)blocks, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// heads per y CTA: the largest multiple of 4 dividing hpg (at most HPC_MAX)
// that leaves at least two CTAs (y CTAs over `tiles` t-tiles, and
// `state_ctas`) per SM; the smallest such multiple if none does; 2 or 1 if
// hpg has no multiple of 4 among its divisors
int heads_per_y_cta(int hpg, long long tiles, long long state_ctas,
                    int sms) {
  int best = 0;
  for (int h = 4; h <= HPC_MAX; h += 4) {
    if (hpg % h) continue;
    if (best == 0 || tiles * (hpg / h) + state_ctas >= 2LL * sms) best = h;
  }
  if (best) return best;
  return hpg % 2 == 0 ? 2 : 1;
}

}  // namespace

extern "C" int ssd_chunk_launch(const void* xdt, const void* adt,
                                const void* B, const void* C, void* y,
                                void* states, int bh, int s, int q, int p,
                                int n, int hpg, void* stream) {
  if (p != P || q <= 0 || q % TT != 0 || q > Q_MAX || s <= 0 || s % q != 0 ||
      n <= 0 || n % 32 != 0 || n > N_MAX || bh <= 0 || hpg <= 0 ||
      bh % hpg != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int groups = bh / hpg, nc = s / q, T = q / TT;
  Args a;
  a.xdt = (const float*)xdt;
  a.adt = (const float*)adt;
  a.B = (const float*)B;
  a.C = (const float*)C;
  a.y = (float*)y;
  a.states = (float*)states;
  a.S = s;
  a.Q = q;
  a.N = n;
  a.hpg = hpg;
  a.hps = hpg % 2 == 0 ? 2 : 1;
  const long long nstate = (long long)groups * nc * (hpg / a.hps);
  a.hpc = heads_per_y_cta(hpg, (long long)groups * nc * T, nstate, sms);
  const long long ycols = (long long)groups * nc * (hpg / a.hpc);
  if (ycols > 0x7fffffffLL || nstate > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.ycols = (int)ycols;
  a.nstate = (int)nstate;
  a.heavy = (T + 1) / 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.hpc % 4 == 0) return launch<8>(a, st);
  if (a.hpc % 2 == 0) return launch<4>(a, st);
  return launch<2>(a, st);
}
