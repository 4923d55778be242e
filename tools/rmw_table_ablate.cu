// Microbenchmarks of int32 atomics on Hopper by where the word lives: the
// measurement behind rmw_table's regimes (src/repro_torch/kernels/rmw/csrc/
// rmw.cu).  Development variants only; the port never calls them.  Built and
// timed by tools/rmw_table_ablate.py.
//
// Every variant streams a batch of n int32 slot indices (and, but for COUNT,
// n int32 values) with 16-byte loads, four ops a thread a step, from a
// persistent grid (a whole number of clusters for DSMEM), and applies each
// op where the variant says:
//   STREAM       no atomic: the loads alone (the floor)
//   GLOBAL       one global atomic an op (the L2, or HBM past it)
//   GLOBAL_SKIP  a plain L2 load first, no atomic where the slot already
//                orders at or past the operand (MIN; FAA and COUNT never skip)
//   SKIP_L1      GLOBAL_SKIP with the load cached in the SM's L1 (a stale
//                copy only skips less)
//   WARP_AGG     __match_any_sync on the warp's 32 slots, one atomic a group
//   SCALAR       GLOBAL with 4-byte loads, one op a thread a step
//   SMEM         a shared-memory atomic into a CTA-private table
//   DSMEM        a distributed-shared-memory atomic into the owner CTA of a
//                table partitioned over a cluster
// Only slots in [lo, hi) are applied (the L2 windows: one launch a window).
// The private tables are not flushed: the variants time where the word
// lives, and write one checksum word so nothing is dead code.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

enum { OP_FAA = 0, OP_MIN = 1, OP_COUNT = 2 };
enum { STREAM = 0, GLOBAL = 1, GLOBAL_SKIP = 2, WARP_AGG = 3, SCALAR = 4,
       SMEM = 5, DSMEM = 6, SKIP_L1 = 7 };

static const int THREADS = 256;

template <int OP>
__device__ __forceinline__ int combine(int a, int b) {
  return OP == OP_MIN ? min(a, b) : (int)((unsigned)a + (unsigned)b);
}

template <int OP>
__device__ __forceinline__ void atomic_op(int* w, int v) {
  if (OP == OP_MIN) atomicMin(w, v);
  else atomicAdd(w, v);
}

template <int WHERE, int OP>
__device__ __forceinline__ void apply(int s, int v, int* table, int* priv,
                                      int lo, int hi, int slots, int& acc) {
  const bool live = s >= lo && s < hi;
  if (WHERE == STREAM) {
    acc += s + v;
  } else if (WHERE == GLOBAL || WHERE == SCALAR) {
    if (live) atomic_op<OP>(&table[s], v);
  } else if (WHERE == GLOBAL_SKIP) {
    if (live && (OP != OP_MIN || v < __ldcg(&table[s])))
      atomic_op<OP>(&table[s], v);
  } else if (WHERE == SKIP_L1) {
    if (live && (OP != OP_MIN || v < __ldca(&table[s])))
      atomic_op<OP>(&table[s], v);
  } else if (WHERE == WARP_AGG) {
    const unsigned peers = __match_any_sync(__activemask(), live ? s : -1);
    int sum = v;
    if (peers & (peers - 1)) {            // a group of two or more: combine
      sum = OP == OP_MIN ? INT_MAX : 0;
      for (unsigned rest = peers; rest; rest &= rest - 1)
        sum = combine<OP>(sum, __shfl_sync(peers, v, __ffs(rest) - 1));
    }
    if (live && (threadIdx.x & 31) == __ffs(peers) - 1)
      atomic_op<OP>(&table[s], sum);
  } else if (WHERE == SMEM) {
    if (live) atomic_op<OP>(&priv[s - lo], v);
  } else {                                // DSMEM
    if (live) {
      const int local = s - lo;
      const int owner = local / slots;
      int* remote = cg::this_cluster().map_shared_rank(priv, owner);
      atomic_op<OP>(&remote[local - owner * slots], v);
    }
  }
}

template <int WHERE, int OP>
__global__ void __launch_bounds__(THREADS)
ablate_kernel(const int* __restrict__ idx, const int* __restrict__ vals,
              int* __restrict__ table, long long n, int lo, int hi,
              int slots) {
  extern __shared__ int priv[];
  const bool private_table = WHERE == SMEM || WHERE == DSMEM;
  if (private_table) {
    for (int s = threadIdx.x; s < slots; s += THREADS)
      priv[s] = OP == OP_MIN ? INT_MAX : 0;
    if (WHERE == DSMEM) cg::this_cluster().sync();
    else __syncthreads();
  }
  int acc = 0;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (WHERE == SCALAR) {
    for (long long i = first; i < n; i += stride)
      apply<WHERE, OP>(idx[i], OP == OP_COUNT ? 1 : vals[i], table, priv, lo,
                       hi, slots, acc);
  } else {
    const long long n4 = n / 4;
    for (long long q = first; q < n4; q += stride) {
      const int4 s = reinterpret_cast<const int4*>(idx)[q];
      const int4 v = OP == OP_COUNT ? make_int4(1, 1, 1, 1)
                                    : reinterpret_cast<const int4*>(vals)[q];
      apply<WHERE, OP>(s.x, v.x, table, priv, lo, hi, slots, acc);
      apply<WHERE, OP>(s.y, v.y, table, priv, lo, hi, slots, acc);
      apply<WHERE, OP>(s.z, v.z, table, priv, lo, hi, slots, acc);
      apply<WHERE, OP>(s.w, v.w, table, priv, lo, hi, slots, acc);
    }
    for (long long i = 4 * n4 + first; i < n; i += stride)
      apply<WHERE, OP>(idx[i], OP == OP_COUNT ? 1 : vals[i], table, priv, lo,
                       hi, slots, acc);
  }
  if (private_table) {
    if (WHERE == DSMEM) cg::this_cluster().sync();
    else __syncthreads();
    for (int s = threadIdx.x; s < slots; s += THREADS) acc += priv[s];
  }
  if (acc == 0x13579bdf) table[0] = acc;  // keeps the work live
}

template <int WHERE, int OP>
static int launch(const int* idx, const int* vals, int* table, long long n,
                  int lo, int hi, int slots, int cluster, cudaStream_t st,
                  int* grid_out) {
  auto kernel = ablate_kernel<WHERE, OP>;
  const int smem = (WHERE == SMEM || WHERE == DSMEM) ? slots * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  int grid;
  if (WHERE == DSMEM) {
    if (cluster > 8) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(cluster);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    grid = clusters * cluster;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  cfg.gridDim = dim3(grid);
  *grid_out = grid;
  err = cudaLaunchKernelEx(&cfg, kernel, idx, vals, table, n, lo, hi, slots);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int WHERE>
static int launch_op(int op, const int* idx, const int* vals, int* table,
                     long long n, int lo, int hi, int slots, int cluster,
                     cudaStream_t st, int* grid) {
  switch (op) {
    case OP_FAA: return launch<WHERE, OP_FAA>(idx, vals, table, n, lo, hi,
                                              slots, cluster, st, grid);
    case OP_MIN: return launch<WHERE, OP_MIN>(idx, vals, table, n, lo, hi,
                                              slots, cluster, st, grid);
    case OP_COUNT: return launch<WHERE, OP_COUNT>(idx, vals, table, n, lo, hi,
                                                  slots, cluster, st, grid);
  }
  return (int)cudaErrorInvalidValue;
}

// idx and vals 16-byte aligned; `slots` is the private table of a CTA
// (SMEM, DSMEM); `grid` receives the CTAs launched.
extern "C" int ablate_launch(int where, int op, const void* idx,
                             const void* vals, void* table, long long n,
                             int lo, int hi, int slots, int cluster,
                             void* stream, int* grid) {
  const int* i = (const int*)idx;
  const int* v = (const int*)vals;
  int* t = (int*)table;
  cudaStream_t st = (cudaStream_t)stream;
#define CASE(W) \
  case W: return launch_op<W>(op, i, v, t, n, lo, hi, slots, cluster, st, grid)
  switch (where) {
    CASE(STREAM); CASE(GLOBAL); CASE(GLOBAL_SKIP); CASE(WARP_AGG);
    CASE(SCALAR); CASE(SMEM); CASE(DSMEM); CASE(SKIP_L1);
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}
