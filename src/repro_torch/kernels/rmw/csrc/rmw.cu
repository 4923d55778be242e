// Combining read-modify-write kernels for Hopper (sm_90a).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o librmw.so rmw.cu
// Bound to PyTorch through the plain C entries at the bottom (ctypes, see
// ../kernel.py and ../../build.py).  Every entry takes device pointers, sizes,
// an op code and a dtype code plus the caller's CUDA stream, launches on that
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().  Tables are int32 or float32; indices int32.  An index
// outside [0, m) is dropped.
//
// Op codes: 0 faa, 1 swp, 2 min, 3 max, 4 cas, 5 count.  Dtype codes: 0 int32,
// 1 fp32.
//
// ---------------------------------------------------------------------------
// rmw_table and slot_counts  (replace src/repro/kernels/rmw/kernel.py:107
//             rmw_table, body _rmw_kernel, and :169 slot_counts, body
//             _slot_count_kernel: one-hot (block x tile) MXU contractions)
//   One family of table-only combining kernels, table_combine_kernel: the
//   table after a faa/min/max/swp batch, and slot_counts as its "count" mode
//   (int32 FAA of 1 onto a zero table, no values read).  No per-op outputs:
//   hardware atomics only ever build the final table here; they return
//   values in thread order, never the serialized fetched values.
//   Bound: bytes, (8 n + 8 m) / 3.35 TB/s ((4 n + 4 m) for a count).  What
//   bounds it on this card is where the word lives (tools/rmw_table_ablate.py,
//   int32, n = 2^25, H100 80GB HBM3 at 700 W, operations a second): loads
//   alone 303 G (count 512 G); a shared-memory atomic 190 G (count 212 G);
//   an L2 atomic 76 G (m = 2^20); a distributed-shared-memory atomic in a
//   cluster of 8 78 G, of 16 66 G; past the L2 (m = 2^24) 21 G; one hot slot
//   1.35 G.  So the L2's request rate, not bytes, bounds a batch over a
//   table that fits the L2: a plain L2 load costs about what an atomic does
//   (a MIN that skips its atomic after one: 93 G), while a load that hits
//   the SM's L1 does not (one hot slot: 195 G).
//   Regimes, picked per call by kernel.table_regime (op, dtype, n, m):
//   - smem: m fits a CTA's shared memory (SMEM_SLOTS) and n >= 32 m.  CTAs
//     of 1,024 threads (one holding many slots is alone on its SM) combine
//     their share of the batch into a private copy with shared-memory
//     atomics, then flush it once: cp.reduce.async.bulk (add, min, max on
//     32-bit words, add on f32) or, for fp32 MIN/MAX, a compare-and-swap per
//     touched slot (so those take it only for small tables and many ops a
//     slot).  The paper's contended regime (n = 2^22 over 1,024): 15x the
//     global regime for FAA.
//   - global: one global atomic per kept op; MIN, MAX and SWP (atomicMax on
//     batch position) first read the slot through the L1 and skip the
//     atomic where it already orders at or past the operand (the slot only
//     moves one way, so a stale read only skips less: 0.43 -> 0.35 ms at
//     m = 2^20, and the L1 gives Kronecker slots 9% over reads from the L2).
//     SWP walks the batch from its end, so the winning position tends to
//     land first.
//   - windows: a table of two L2 windows (WINDOW_SLOTS) or more is applied
//     one window at a time, one pass over the batch a window, so the
//     atomics stay in the L2 and off HBM (m = 2^24: 2x one pass).
//   Each thread loads 8 indices, then their values and (global MIN, MAX,
//   SWP) the words they land on, before it combines any: more loads in
//   flight.  fp32 MIN/MAX into the output take one op a thread a step on
//   four times the resident CTAs, as each compare-and-swap waits for its
//   answer (eight a step: 25% slower).
//   Measured and not kept: a cluster's distributed shared memory (no faster
//   than the L2 at 8 CTAs, slower at 16); warp aggregation with
//   __match_any_sync (no gain on Graph500 Kronecker slots); 16-byte loads
//   (no gain over 4-byte ones where the atomics bound it).
//   Words: an op's 4-byte word is the table's type for FAA and MIN/MAX on
//   int32 and for a count, an order key for fp32 MIN/MAX (the reference's
//   order: −0 below +0, NaN wins; turned back at the flush), a batch position
//   for SWP (atomicMax into an int32 last_pos set to -1; a second kernel
//   writes vals[last_pos[s]]).  The private copy starts at the op's identity
//   (fp32 FAA: −0, since −0 + x is x for every x), so a slot no op touched
//   flushes to no change.  int32 results are exact in every regime; fp32 FAA
//   only reassociates: each slot's ops are summed per CTA, then into the
//   table, so the rounding stays within the tolerance a sum of that many
//   terms in any order already needs (rtol 1e-5, atol 1e-5 sqrt(occupancy)).
//   fp32 FAA into the output (global, windows) sums each thread's UNROLL
//   ops of one slot, then each warp's sums of one slot (__match_any_sync,
//   then a tree over the peers' ranks), before one atomicAdd: a hot slot's
//   sum is then a chain of n / 256 atomics, not of n.  Chained
//   op by op, a slot's rounding grows with its occupancy and can pass that
//   tolerance on one hot slot (m = 1); the warp's tree keeps it inside.

// rmw_table_fetched  (replaces kernel.py::rmw_table_fetched, body
//             _rmw_fetched_kernel: per-tile pallas_calls, each a 1-D grid over
//             index blocks with a strict-lower-triangular one-hot prefix)
//   Computes (table, fetched, success) in serialized batch order for
//   faa/min/max/swp and uniform-expected CAS.
//   Bound: bytes, (8 n in + 5 n out + 8 m) / 3.35 TB/s.
//   Design: a stable sort of the kept ops by slot, then a segmented scan;
//   nothing is ordered across the batch but the look-back below.  Five
//   stages of kernels over tiles of TILE = 4096 ops (256 threads x 16); a
//   kernel with a look-back takes its tiles in order by a dynamic ticket
//   (atomicAdd), so every tile a CTA waits on is resident or done and the
//   look-back cannot deadlock:
//   1. Compact: keep the ops with 0 <= idx < m as (slot, position) pairs in
//      batch order (warp ballots, a block scan, the tile's offset by
//      decoupled look-back); write fetched 0 and success 0 at the dropped
//      positions and success 1 at the kept ones (CAS: 0, see 5); build
//      the digit histograms of every radix pass, 4's too (shared bins, one
//      global atomicAdd per non-zero bin).  The last tile writes k, the number
//      kept: the later kernels size themselves by it on the device, and
//      their tiles past k exit at once.
//   2. Sort: ceil(bit_length(m - 1) / 8) stable LSD passes of 8-bit digits
//      (3 at m = 2^20 and 2^24, 4 at 2^25 + 1, none at m = 1).  A pass
//      ranks each warp's keys by digit (__match_any_sync), takes each
//      digit's offset among earlier tiles by decoupled look-back (one status
//      word per tile and digit), stages the tile digit-major in shared
//      memory and writes each digit's run out contiguously.
//   3. Scan: a segment is a run of one slot.  Each op gathers vals[pos], a
//      segment head also table[slot]; an inclusive segmented scan of
//      (head, value) under the op's combiner (wrapping int32 or fp32 add,
//      min, max; CAS: the first value other than `expected`, else the last)
//      gives the slot's value after each op, and the value before it is the
//      fetched one.  SWP needs no scan: fetched is the previous op's value.  The
//      carry across tiles is the same look-back; a tile that holds a head
//      publishes its inclusive value at once.  The last op of each segment
//      writes the slot's final value into the output table (the input
//      table is only read).  The fetched values go out in slot order,
//      beside their positions.
//   4. Bucket: one more pass of 2's kernel sorts the (position, fetched)
//      pairs by the top 8 bits of the position.
//   5. Scatter fetched to the positions, a tile per CTA.  A random 4-byte
//      write into an array larger than L2 costs far more than a streamed
//      one; bucketed, the writes in flight fall in a few windows of n / 256
//      positions that stay in L2.  CAS then streams success = kept and
//      fetched == expected over the batch (random 1-byte writes of it cost
//      more still).
//   Status words are 64-bit, flag and value in one load: flag in bits
//   56-63, value in bits 0-31.  Each stage has its own flags (2s + 1
//   aggregate, 2s + 2 inclusive), so a word left by an earlier stage reads
//   as not ready and the status words are zeroed once per call.  Hardware
//   atomics serve only tickets and histogram bins.
//   Moves 9 n + (52 + 16 P) k bytes for k kept ops and P passes, plus 8 per
//   slot touched (CAS: 9 n more), all of it streamed but the vals/table
//   gathers of 3 and the windowed scatter of 5.
//   fp32 FAA sums in tile order within the block, but the look-back may
//   stop at any published inclusive value, so its association across tiles
//   (and the rounding of a segment that spans tiles) can vary from run to
//   run.
//   Scratch (one buffer from the caller, sized by rmw_table_fetched_layout;
//   fetched_layout below): 16 counters,
//   MAX_PASSES + 1 rows of 256 histogram bins, ceil(n / TILE) x 256 status
//   words, two pair buffers of 2 n int32, every part 256-byte aligned.  The
//   counters, bins and status words are zeroed by cudaMemsetAsync.
//
// ---------------------------------------------------------------------------

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "csrc/order.cuh"

enum { OP_FAA = 0, OP_SWP = 1, OP_MIN = 2, OP_MAX = 3, OP_CAS = 4,
       OP_COUNT = 5 };
enum { DT_INT32 = 0, DT_FLOAT32 = 1 };

static const int THREADS = 256;        // threads per block of the others
static const int MAX_BLOCKS = 132 * 32;
static const int UNROLL = 8;           // ops a table_combine thread loads
                                       // before it combines any (see STEP)

// --- arithmetic that matches the plain PyTorch versions bit for bit -------

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);   // int32 wraps, as torch does
}
__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }

// min_of / max_of / order_key: kernels/csrc/order.cuh

// fp32 MIN/MAX on the table word by compare-and-swap, starting from `old`,
// a read of the word.  The slot only ever moves down (MIN) or up (MAX) in
// the reference's order (order.cuh), so a stale read that already orders at
// or past v needs no write; the loop stops as soon as the slot holds a NaN,
// and otherwise writes the combined value (a NaN operand writes NaN).
template <bool MIN>
__device__ __forceinline__ void atomic_minmax_float(float* a, float v,
                                                    unsigned old) {
  unsigned* w = reinterpret_cast<unsigned*>(a);
  while (!is_nan_bits(old)) {
    const float cur = __uint_as_float(old);
    const unsigned want = __float_as_uint(MIN ? min_of(cur, v)
                                              : max_of(cur, v));
    if (want == old) return;
    const unsigned seen = atomicCAS(w, old, want);
    if (seen == old) return;
    old = seen;
  }
}

// --- rmw_table and slot_counts: table_combine_kernel ----------------------

enum { REGIME_GLOBAL = 0, REGIME_SMEM = 1, REGIME_WINDOWS = 2 };

template <typename T>
constexpr bool IS_F32 = std::is_same<T, float>::value;

// An op's 4-byte word (see the note at the top): what the private copy and
// the flush combine.
template <typename T, int OP>
__device__ __forceinline__ int op_word(const T* vals, long long i) {
  if constexpr (OP == OP_COUNT) return 1;
  else if constexpr (OP == OP_SWP) return (int)i;
  else if constexpr (IS_F32<T>)
    return OP == OP_FAA ? __float_as_int(vals[i])
                        : order_key(vals[i], OP == OP_MIN);
  else return vals[i];
}

// The word no op changes: a private slot still holding it flushes to nothing.
// fp32 FAA's is −0 (its bits are INT_MIN): −0 + x is x for every x.
template <typename T, int OP>
__device__ __forceinline__ int identity_word() {
  if constexpr (OP == OP_MIN) return INT_MAX;
  else if constexpr (OP == OP_MAX) return INT_MIN;
  else if constexpr (OP == OP_SWP) return -1;
  else if constexpr (OP == OP_FAA && IS_F32<T>) return INT_MIN;
  else return 0;
}

// A word into the CTA's private copy.  MIN, MAX and SWP read first and skip
// the atomic where the slot already orders at or past the word.
template <typename T, int OP>
__device__ __forceinline__ void private_word(int* priv, int s, int w) {
  if constexpr (OP == OP_FAA && IS_F32<T>) {
    atomicAdd(reinterpret_cast<float*>(priv) + s, __int_as_float(w));
  } else if constexpr (OP == OP_FAA || OP == OP_COUNT) {
    atomicAdd(&priv[s], w);
  } else {
    const int cur = *reinterpret_cast<volatile int*>(&priv[s]);
    if (OP == OP_MIN ? w < cur : w > cur) {
      if (OP == OP_MIN) atomicMin(&priv[s], w);
      else atomicMax(&priv[s], w);
    }
  }
}

// The output word an op lands on: the table's, or last_pos's for SWP.
template <typename T, int OP>
__device__ __forceinline__ int* out_word(T* table, int* last_pos, int s) {
  return OP == OP_SWP ? &last_pos[s] : reinterpret_cast<int*>(table) + s;
}

// MIN, MAX and SWP read the output word first (`read_word`) and skip the
// atomic where it already orders at or past theirs.  The word only ever
// moves one way, so a stale read only skips less: the read may come from
// the SM's L1, which keeps a hot slot's line near.
template <int OP>
constexpr bool READS = OP == OP_MIN || OP == OP_MAX || OP == OP_SWP;

// Threads a CTA: a CTA that holds a private copy of many slots is alone on
// its SM, so it takes the SM's 1,024 threads itself.
template <bool PRIVATE>
constexpr int BLOCK = PRIVATE ? 1024 : THREADS;

// Ops a thread loads before it combines any: UNROLL, which keeps more loads
// in flight; but one for fp32 MIN/MAX into the output, whose
// compare-and-swap waits for its answer before the next op (eight: 25%
// slower at m = 2^20, tools/rmw_table_ablate.py), run on four times the
// resident CTAs instead.
template <typename T, int OP, bool PRIVATE>
constexpr int STEP =
    !PRIVATE && IS_F32<T> && (OP == OP_MIN || OP == OP_MAX) ? 1 : UNROLL;

template <typename T, int OP>
__device__ __forceinline__ int read_word(T* table, int* last_pos, int s) {
  return __ldca(out_word<T, OP>(table, last_pos, s));
}

// A word into the output, `cur` a read of it (READS).
template <typename T, int OP>
__device__ __forceinline__ void global_word(T* table, int* last_pos, int s,
                                            int w, int cur) {
  if constexpr (OP == OP_FAA && IS_F32<T>) {
    atomicAdd(&table[s], __int_as_float(w));
  } else if constexpr (OP == OP_FAA || OP == OP_COUNT) {
    atomicAdd(&table[s], w);
  } else if constexpr (IS_F32<T> && OP != OP_SWP) {  // fp32 MIN/MAX: a key
    atomic_minmax_float<OP == OP_MIN>(&table[s], from_order_key(w),
                                      (unsigned)cur);
  } else if (OP == OP_MIN ? w < cur : w > cur) {
    int* word = out_word<T, OP>(table, last_pos, s);
    if (OP == OP_MIN) atomicMin(word, w);
    else atomicMax(word, w);
  }
}

// The lane of the k-th (0-based) set bit of `mask`: the largest p with at
// most k set bits below it.
__device__ __forceinline__ int nth_lane(unsigned mask, int k) {
  int p = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    if (__popc(mask & ((1u << (p + w)) - 1u)) <= k) p += w;
  return p;
}

// The sum of `v` over the warp's lanes holding the same `key` (every lane
// of the warp calls it), as a tree over the peers' ranks: the lowest peer
// returns the group's sum and true, the others false.
__device__ __forceinline__ bool warp_sum_by_key(int key, float& v) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int lane = threadIdx.x & 31;
  const int r = __popc(peers & ((1u << lane) - 1u));
  const int cnt = __popc(peers);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool take = (r & (2 * d - 1)) == 0 && r + d < cnt;
    const float o = __shfl_sync(0xffffffffu, v,
                                take ? nth_lane(peers, r + d) : lane);
    if (take) v += o;
  }
  return r == 0;
}

// fp32 FAA into the output: the U ops a thread loaded, summed first over
// the thread's ops of one slot, its distinct slots then packed to the front
// (so the t-th of every lane meet in one warp step whatever their batch
// positions), each step summed over the warp's lanes of one slot, then one
// atomicAdd a sum (see the note at the top).  Every lane of the warp calls
// it.
template <int U>
__device__ __forceinline__ void faa_f32_aggregated(float* table, int* s,
                                                   const int* w, int lo,
                                                   int hi) {
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool live = s[u] >= lo && s[u] < hi;
    acc[u] = live ? __int_as_float(w[u]) : 0.f;
    if (!live) s[u] = -1;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int v = u + 1; v < U; ++v)
      if (s[u] >= 0 && s[v] == s[u]) {
        acc[u] += acc[v];
        s[v] = -1;
      }
  }
#pragma unroll
  for (int t = 0; t < U; ++t) {
    int key = -1;
    float v = 0.f;
    int seen = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s[u] >= 0) {
        if (seen == t) {
          key = s[u];
          v = acc[u];
        }
        ++seen;
      }
    if (__all_sync(0xffffffffu, key < 0)) break;
    if (warp_sum_by_key(key, v) && key >= 0) atomicAdd(&table[key], v);
  }
}

// Bulk-reduce `bytes` of the private copy into dst (16-byte aligned, a
// multiple of 16 bytes), each element atomically, and wait until the
// shared memory has been read.
template <typename T, int OP>
__device__ __forceinline__ void bulk_flush(void* dst, const int* priv,
                                           int bytes) {
  const unsigned src = (unsigned)__cvta_generic_to_shared(priv);
  if constexpr (OP == OP_FAA && IS_F32<T>)
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
                 " [%0], [%1], %2;" :: "l"(dst), "r"(src), "r"(bytes)
                 : "memory");
  else if constexpr (OP == OP_FAA || OP == OP_COUNT)
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32"
                 " [%0], [%1], %2;" :: "l"(dst), "r"(src), "r"(bytes)
                 : "memory");
  else if constexpr (OP == OP_MIN)
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.min.s32"
                 " [%0], [%1], %2;" :: "l"(dst), "r"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.max.s32"
                 " [%0], [%1], %2;" :: "l"(dst), "r"(src), "r"(bytes)
                 : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Applies the ops whose slot lies in [lo, hi): each thread loads STEP
// indices (neighbouring threads, neighbouring ops), then the values of
// those in range (and, into the output, the words they land on: READS),
// then combines them, over the batch grid-stride (SWP from its end).
// PRIVATE (lo = 0): into the CTA's shared copy of the hi slots, then
// flushed, the first `bulk` slots in one bulk reduction and the rest one
// atomic per touched slot.
template <typename T, int OP, bool PRIVATE>
__global__ void __launch_bounds__(BLOCK<PRIVATE>)
table_combine_kernel(T* __restrict__ table, const int* __restrict__ idx,
                     const T* __restrict__ vals, int* __restrict__ last_pos,
                     long long n, int lo, int hi, int bulk) {
  constexpr int NT = BLOCK<PRIVATE>;
  extern __shared__ int priv[];
  if (PRIVATE) {
    for (int s = threadIdx.x; s < hi; s += NT)
      priv[s] = identity_word<T, OP>();
    __syncthreads();
  }
  constexpr int U = STEP<T, OP, PRIVATE>;
  const long long step = (long long)gridDim.x * NT * U;
  // the warp's lanes iterate together (an op past n loads slot -1), so
  // fp32 FAA into the output can sum over the whole warp
  const int lane = threadIdx.x & 31;
  for (long long j0 = (long long)blockIdx.x * NT * U + threadIdx.x;
       j0 - lane < n; j0 += step) {
    int s[U], w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + u * NT;
      s[u] = j < n ? idx[OP == OP_SWP ? n - 1 - j : j] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + u * NT;
      if (s[u] >= lo && s[u] < hi)
        w[u] = op_word<T, OP>(vals, OP == OP_SWP ? n - 1 - j : j);
    }
    if constexpr (!PRIVATE && OP == OP_FAA && IS_F32<T>) {
      faa_f32_aggregated<U>(reinterpret_cast<float*>(table), s, w, lo, hi);
      continue;
    }
    int cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (!PRIVATE && READS<OP> && s[u] >= lo && s[u] < hi)
        cur[u] = read_word<T, OP>(table, last_pos, s[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s[u] < lo || s[u] >= hi) continue;
      if (PRIVATE) private_word<T, OP>(priv, s[u], w[u]);
      else global_word<T, OP>(table, last_pos, s[u], w[u], cur[u]);
    }
  }
  if (!PRIVATE) return;
  // the shared copy's writes become visible to the bulk copy's proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (bulk > 0 && threadIdx.x == 0)
    bulk_flush<T, OP>(OP == OP_SWP ? (void*)last_pos : (void*)table, priv,
                      bulk * 4);
  for (int s = bulk + threadIdx.x; s < hi; s += NT) {
    const int w = priv[s];
    if (w != identity_word<T, OP>())
      global_word<T, OP>(table, last_pos, s, w,
                         READS<OP> ? read_word<T, OP>(table, last_pos, s) : 0);
  }
}

template <typename T>
__global__ void swp_write_kernel(T* __restrict__ table,
                                 const T* __restrict__ vals,
                                 const int* __restrict__ last_pos, int m) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < m;
       s += gridDim.x * blockDim.x) {
    const int p = last_pos[s];
    if (p >= 0) table[s] = vals[p];
  }
}

// --- rmw_table_fetched -----------------------------------------------------

static const int FT = 256;                  // threads per CTA of the stages
static const int FW = FT / 32;              // warps per CTA
static const int FI = 16;                   // ops per thread
static const int TILE = FT * FI;            // ops per tile
static const int WCHUNK = TILE / FW;        // ops per warp in stages 1-2
static const int DBITS = 8;                 // radix digit
static const int DIGITS = 1 << DBITS;       // == FT: a thread per digit
static const int MAX_PASSES = 4;            // slots below 2^31
// histogram rows: one per slot pass, then the positions' top digit
static const int HIST_ROWS = MAX_PASSES + 1;
// counters[]: one ticket per look-back kernel (compact, the slot passes,
// scan, the position pass), then k, the number of ops kept
enum { C_KEPT = 8, N_COUNTERS = 16 };

typedef unsigned long long u64;

__device__ __forceinline__ u64 status_word(unsigned flag, unsigned value) {
  return ((u64)flag << 56) | value;
}
__device__ __forceinline__ unsigned status_flag(u64 w) {
  return (unsigned)(w >> 56);
}
__device__ __forceinline__ void publish(u64* s, u64 w) {
  *(volatile u64*)s = w;      // one 64-bit store: flag and value together
}
// Spin until the word carries this stage's aggregate (`flag`) or inclusive
// (`flag + 1`) flag.  The tile that writes it holds an earlier ticket, so it
// is resident or done.
__device__ __forceinline__ u64 wait_status(const u64* s, unsigned flag) {
  u64 w;
  do {
    w = *(const volatile u64*)s;
  } while (status_flag(w) < flag);
  return w;
}

// Tile t's exclusive prefix of `own` over tiles 0..t-1, by decoupled
// look-back over the status words status[j * stride], j < t.  (Reading
// several predecessors' words at once was slower in a radix pass.)
__device__ unsigned look_back_sum(u64* status, int t, int stride,
                                  unsigned own, unsigned flag) {
  u64* mine = status + (long long)t * stride;
  if (t == 0) {
    publish(mine, status_word(flag + 1, own));
    return 0;
  }
  publish(mine, status_word(flag, own));
  unsigned excl = 0;
  for (int j = t - 1;; --j) {
    const u64 w = wait_status(status + (long long)j * stride, flag);
    excl += (unsigned)w;
    if (status_flag(w) == flag + 1) break;
  }
  publish(mine, status_word(flag + 1, excl + own));
  return excl;
}

// Exclusive sum of one int per thread over the CTA (FT threads).
__device__ int block_exclusive_sum(int x, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp; ++w) off += s_warp[w];
  __syncthreads();
  return off + incl - x;
}

// Stage 1: compact the kept ops into (slot, position) pairs in batch order.
// `kept_success` is what a kept op's success is (1, or for CAS 0 until the
// last stage writes it).
template <typename T>
__global__ void __launch_bounds__(FT)
fetched_compact_kernel(const int* __restrict__ idx, T* __restrict__ fetched,
                       uint8_t* __restrict__ success, int* __restrict__ keys,
                       int* __restrict__ pos, u64* status, int* counters,
                       int* hist, long long n, int m, int passes,
                       int pos_shift, uint8_t kept_success) {
  __shared__ int s_hist[HIST_ROWS * DIGITS];
  __shared__ int s_warp[FW];
  __shared__ int s_ticket, s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < HIST_ROWS * DIGITS; i += FT) s_hist[i] = 0;
  if (tid == 0) s_ticket = atomicAdd(&counters[0], 1);
  __syncthreads();
  const int t = s_ticket;
  const long long first = (long long)t * TILE + warp * WCHUNK + lane;
  const unsigned below = (1u << lane) - 1;
  int slot[FI], rank[FI];
#pragma unroll
  for (int r = 0; r < FI; ++r)      // every load in flight before any use
    slot[r] = first + r * 32 < n ? idx[first + r * 32] : -1;
  int count = 0;
#pragma unroll
  for (int r = 0; r < FI; ++r) {
    const long long i = first + r * 32;
    int s = slot[r];
    if (i < n) {
      if (s < 0 || s >= m) {                     // dropped
        fetched[i] = T(0);
        s = -1;
      }
      success[i] = s >= 0 ? kept_success : 0;
    }
    const unsigned kept = __ballot_sync(0xffffffffu, s >= 0);
    slot[r] = s;
    rank[r] = count + __popc(kept & below);
    count += __popc(kept);
    if (s >= 0) {
      for (int p = 0; p < passes; ++p)
        atomicAdd(&s_hist[p * DIGITS + ((s >> (p * DBITS)) & (DIGITS - 1))],
                  1);
      atomicAdd(&s_hist[MAX_PASSES * DIGITS + (int)(i >> pos_shift)], 1);
    }
  }
  if (lane == 0) s_warp[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < FW; ++w) {
      const int c = s_warp[w];
      s_warp[w] = total;
      total += c;
    }
    s_base = (int)look_back_sum(status, t, 1, (unsigned)total, 1);
    if (t == (int)gridDim.x - 1) counters[C_KEPT] = s_base + total;
  }
  __syncthreads();
  const int base = s_base + s_warp[warp];
#pragma unroll
  for (int r = 0; r < FI; ++r) {
    if (slot[r] >= 0) {
      keys[base + rank[r]] = slot[r];
      pos[base + rank[r]] = (int)(first + r * 32);
    }
  }
  for (int i = tid; i < HIST_ROWS * DIGITS; i += FT) {
    const int c = s_hist[i];
    if (c) atomicAdd(&hist[i], c);
  }
}

// One stable LSD pass of (key, payload) pairs on the digit of the keys at
// `shift`, whose histogram is `hist` (DIGITS bins).  Stage 2 runs it on the
// slots with the positions as payload; stage 4 on the positions' top digit
// with the fetched values.
__global__ void __launch_bounds__(FT)
fetched_radix_kernel(const int* __restrict__ keys_in,
                     const int* __restrict__ pos_in,
                     int* __restrict__ keys_out, int* __restrict__ pos_out,
                     u64* status, int* counters, const int* hist, int shift,
                     int ticket, unsigned flag) {
  __shared__ int s_key[TILE], s_pos[TILE];
  __shared__ int s_wcnt[FW][DIGITS];   // per-warp counts, then warp offsets
  __shared__ int s_start[DIGITS];      // digit's first place in the tile
  __shared__ int s_dst[DIGITS];        // digit's first place in the output
  __shared__ int s_warp[FW];
  __shared__ int s_ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < FW * DIGITS; i += FT) (&s_wcnt[0][0])[i] = 0;
  if (tid == 0) s_ticket = atomicAdd(&counters[ticket], 1);
  __syncthreads();
  const int t = s_ticket;
  const long long k = counters[C_KEPT];
  const long long t0 = (long long)t * TILE;
  if (t0 >= k) return;
  const long long first = t0 + warp * WCHUNK + lane;
  const unsigned below = (1u << lane) - 1;
  int key[FI], ps[FI], rank[FI];
#pragma unroll
  for (int r = 0; r < FI; ++r) {    // every load in flight before any use
    const long long j = first + r * 32;
    key[r] = j < k ? keys_in[j] : -1;
    ps[r] = j < k ? pos_in[j] : 0;
  }
#pragma unroll
  for (int r = 0; r < FI; ++r) {
    const bool valid = key[r] >= 0;
    const int d = valid ? (key[r] >> shift) & (DIGITS - 1) : DIGITS;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = valid ? s_wcnt[warp][d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      s_wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
    rank[r] = before + __popc(peers & below);
  }
  __syncthreads();
  // thread `tid` owns digit `tid`: warp offsets and the tile's count
  int count = 0;
  for (int w = 0; w < FW; ++w) {
    const int c = s_wcnt[w][tid];
    s_wcnt[w][tid] = count;
    count += c;
  }
  const int start = block_exclusive_sum(count, s_warp);
  const int digit_base = block_exclusive_sum(hist[tid], s_warp);
  const unsigned earlier = look_back_sum(status + tid, t, DIGITS,
                                         (unsigned)count, flag);
  s_start[tid] = start;
  s_dst[tid] = digit_base + (int)earlier;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < FI; ++r) {
    if (key[r] >= 0) {
      const int d = (key[r] >> shift) & (DIGITS - 1);
      const int at = s_start[d] + s_wcnt[warp][d] + rank[r];
      s_key[at] = key[r];
      s_pos[at] = ps[r];
    }
  }
  __syncthreads();
  const int in_tile = (int)(k - t0 < TILE ? k - t0 : TILE);
  for (int i = tid; i < in_tile; i += FT) {
    const int kk = s_key[i];
    const int d = (kk >> shift) & (DIGITS - 1);
    const int dst = s_dst[d] + i - s_start[d];
    keys_out[dst] = kk;
    pos_out[dst] = s_pos[i];
  }
}

// Stage 3's combiners: the slot's value after `b` applied to `a`.
template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b, T e) {
  if constexpr (OP == OP_FAA) return add_wrap(a, b);
  else if constexpr (OP == OP_MIN) return min_of(a, b);
  else if constexpr (OP == OP_MAX) return max_of(a, b);
  // CAS: a slot other than e stays; else it takes b (b == e keeps the
  // chain alive but writes b's bits: ±0).  Folded from the table's value,
  // the first value other than e, else the last.
  else return a != e ? a : b;
}

__device__ __forceinline__ unsigned to_bits(int v) { return (unsigned)v; }
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
template <typename T> __device__ __forceinline__ T from_bits(unsigned b);
template <> __device__ __forceinline__ int from_bits<int>(unsigned b) {
  return (int)b;
}
template <> __device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

// (head seen, value) of a run of ops; `b` after `a`.  Associative.
template <typename T>
struct Seg {
  bool h;
  T v;
};
template <typename T, int OP>
__device__ __forceinline__ Seg<T> seg_combine(Seg<T> a, Seg<T> b, T e) {
  return b.h ? b : Seg<T>{a.h, combine<T, OP>(a.v, b.v, e)};
}

#define SPAD(i) ((i) + ((i) >> 5))   // shared index padded past bank conflicts

// Stage 3: each op's fetched value, in slot order beside its position, and
// the final table.
template <typename T, int OP>
__global__ void __launch_bounds__(FT)
fetched_scan_kernel(const T* __restrict__ table, T* __restrict__ out,
                    const int* __restrict__ keys, const int* __restrict__ pos,
                    const T* __restrict__ vals, int* __restrict__ f_pos,
                    unsigned* __restrict__ f_val, u64* status,
                    int* counters, int ticket, unsigned flag, T e) {
  __shared__ int s_key[SPAD(TILE)], s_pos[SPAD(TILE)];
  __shared__ T s_last[FT];
  __shared__ bool s_wh[FW];
  __shared__ T s_wv[FW];
  __shared__ int s_ticket, s_prev_key, s_next_key;
  __shared__ T s_carry;    // value before the tile (SWP: the previous op's)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(&counters[ticket], 1);
  __syncthreads();
  const int t = s_ticket;
  const long long k = counters[C_KEPT];
  const long long t0 = (long long)t * TILE;
  if (t0 >= k) return;
  const int in_tile = (int)(k - t0 < TILE ? k - t0 : TILE);
#pragma unroll
  for (int r = 0; r < FI; ++r) {
    const int l = r * FT + tid;
    if (l < in_tile) {
      s_key[SPAD(l)] = keys[t0 + l];
      s_pos[SPAD(l)] = pos[t0 + l];
    }
  }
  if (tid == 0) {
    s_prev_key = t > 0 ? keys[t0 - 1] : -1;
    s_next_key = t0 + TILE < k ? keys[t0 + TILE] : -1;
    if (OP == OP_SWP && t > 0) s_carry = vals[pos[t0 - 1]];
  }
  __syncthreads();

  // this thread's FI consecutive ops
  const int l0 = tid * FI;
  int key[FI], ps[FI];
  T v[FI], base[FI];
  unsigned head = 0, last = 0;
#pragma unroll
  for (int i = 0; i < FI; ++i) {
    const bool valid = l0 + i < in_tile;
    key[i] = valid ? s_key[SPAD(l0 + i)] : -1;
    ps[i] = valid ? s_pos[SPAD(l0 + i)] : 0;
  }
#pragma unroll
  for (int i = 0; i < FI; ++i) {
    if (key[i] < 0) continue;
    const int prev = i > 0 ? key[i - 1]
                           : (tid > 0 ? s_key[SPAD(l0 - 1)] : s_prev_key);
    const int next = i < FI - 1 ? key[i + 1]
                                : (l0 + FI < in_tile ? s_key[SPAD(l0 + FI)]
                                                     : s_next_key);
    if (key[i] != prev) head |= 1u << i;
    if (key[i] != next) last |= 1u << i;
  }
#pragma unroll
  for (int i = 0; i < FI; ++i) {
    v[i] = key[i] >= 0 ? vals[ps[i]] : T(0);
    base[i] = (head >> i) & 1 ? table[key[i]] : T(0);
  }

  if constexpr (OP == OP_SWP) {
    s_last[tid] = v[FI - 1];
    __syncthreads();
    T prev = tid > 0 ? s_last[tid - 1] : s_carry;
#pragma unroll
    for (int i = 0; i < FI; ++i) {
      if (key[i] < 0) continue;
      f_pos[t0 + l0 + i] = ps[i];
      f_val[t0 + l0 + i] = to_bits((head >> i) & 1 ? base[i] : prev);
      if ((last >> i) & 1) out[key[i]] = v[i];
      prev = v[i];
    }
  } else {
    // the thread's aggregate; ops past k count as heads and are never read
    Seg<T> agg;
#pragma unroll
    for (int i = 0; i < FI; ++i) {
      const bool h = key[i] < 0 || ((head >> i) & 1);
      const Seg<T> x{h, h && key[i] >= 0 ? combine<T, OP>(base[i], v[i], e)
                                         : v[i]};
      agg = i == 0 ? x : seg_combine<T, OP>(agg, x, e);
    }
    // inclusive over the warp, then the previous thread's (exclusive)
    Seg<T> s = agg;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg<T> o{(bool)__shfl_up_sync(0xffffffffu, (int)s.h, d),
                     __shfl_up_sync(0xffffffffu, s.v, d)};
      if (lane >= d) s = seg_combine<T, OP>(o, s, e);
    }
    if (lane == 31) {
      s_wh[warp] = s.h;
      s_wv[warp] = s.v;
    }
    Seg<T> ex{(bool)__shfl_up_sync(0xffffffffu, (int)s.h, 1),
              __shfl_up_sync(0xffffffffu, s.v, 1)};
    bool has_ex = lane > 0;
    __syncthreads();
    if (warp > 0) {
      Seg<T> wp{s_wh[0], s_wv[0]};
      for (int w = 1; w < warp; ++w)
        wp = seg_combine<T, OP>(wp, Seg<T>{s_wh[w], s_wv[w]}, e);
      ex = has_ex ? seg_combine<T, OP>(wp, ex, e) : wp;
      has_ex = true;
    }
    if (tid == 0) {
      Seg<T> tile{s_wh[0], s_wv[0]};
      for (int w = 1; w < FW; ++w)
        tile = seg_combine<T, OP>(tile, Seg<T>{s_wh[w], s_wv[w]}, e);
      u64* mine = status + t;
      // a tile holding a head knows its inclusive value already
      publish(mine, status_word(tile.h ? flag + 1 : flag, to_bits(tile.v)));
      if (!(head & 1)) {              // the tile continues a segment
        T acc = T(0);
        bool any = false;
        for (int j = t - 1;; --j) {
          const u64 w = wait_status(status + j, flag);
          const T wv = from_bits<T>((unsigned)w);
          acc = any ? combine<T, OP>(wv, acc, e) : wv;
          any = true;
          if (status_flag(w) == flag + 1) break;
        }
        s_carry = acc;
        if (!tile.h)
          publish(mine, status_word(
              flag + 1, to_bits(combine<T, OP>(acc, tile.v, e))));
      }
    }
    __syncthreads();
    // the slot's value before this thread's first op
    T prev = has_ex ? (ex.h ? ex.v : combine<T, OP>(s_carry, ex.v, e))
                    : s_carry;
#pragma unroll
    for (int i = 0; i < FI; ++i) {
      if (key[i] < 0) continue;
      const bool h = (head >> i) & 1;
      const T f = h ? base[i] : prev;
      prev = combine<T, OP>(f, v[i], e);
      f_pos[t0 + l0 + i] = ps[i];
      f_val[t0 + l0 + i] = to_bits(f);
      if ((last >> i) & 1) out[key[i]] = prev;
    }
  }
}

// Stage 5: fetched[pos] from the (position, value) pairs, now bucketed by
// the positions' top digit.  A CTA per tile, loads before stores: the writes
// of the CTAs in flight fall in a few windows of n / 256 positions, which
// stay in L2.
__global__ void __launch_bounds__(FT)
fetched_scatter_kernel(const int* __restrict__ f_pos,
                       const unsigned* __restrict__ f_val,
                       unsigned* __restrict__ fetched, const int* counters) {
  const long long k = counters[C_KEPT];
  const long long t0 = (long long)blockIdx.x * TILE;
  if (t0 >= k) return;
  int p[FI];
  unsigned v[FI];
#pragma unroll
  for (int u = 0; u < FI; ++u) {
    const long long j = t0 + u * FT + threadIdx.x;
    p[u] = j < k ? f_pos[j] : -1;
    v[u] = j < k ? f_val[j] : 0;
  }
#pragma unroll
  for (int u = 0; u < FI; ++u)
    if (p[u] >= 0) fetched[p[u]] = v[u];
}

// CAS: success = kept and fetched == expected, streamed over the batch.
template <typename T>
__global__ void cas_success_kernel(const int* __restrict__ idx,
                                   const T* __restrict__ fetched,
                                   uint8_t* __restrict__ success, long long n,
                                   int m, T e) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    success[i] = idx[i] >= 0 && idx[i] < m && fetched[i] == e;
}

// --- C entries -------------------------------------------------------------

static int grid_for(long long work) {
  long long b = (work + THREADS - 1) / THREADS;
  if (b < 1) b = 1;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename T, int OP>
static cudaError_t launch_table(T* table, const int* idx, const T* vals,
                                int* last_pos, long long n, int m, int regime,
                                long long window, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (regime == REGIME_SMEM) {
    constexpr int nt = BLOCK<true>;
    const long long most = (n + nt * UNROLL - 1) / (nt * UNROLL);
    auto kernel = table_combine_kernel<T, OP, true>;
    const int bytes = m * 4;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          nt, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // every CTA flushes m slots: at least m ops a CTA
    long long blocks = (long long)sms * per_sm;
    if (blocks > n / m) blocks = n / m;
    if (blocks > most) blocks = most;
    if (blocks < 1) blocks = 1;
    void* dst = OP == OP_SWP ? (void*)last_pos : (void*)table;
    const bool bulk_op = !(IS_F32<T> && (OP == OP_MIN || OP == OP_MAX));
    const int bulk = bulk_op && ((uintptr_t)dst & 15) == 0 ? (m & ~3) : 0;
    kernel<<<(int)blocks, nt, bytes, st>>>(table, idx, vals, last_pos, n, 0,
                                            m, bulk);
  } else {
    auto kernel = table_combine_kernel<T, OP, false>;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
    if (err != cudaSuccess) return err;
    constexpr int u = STEP<T, OP, false>;
    const long long most = (n + THREADS * u - 1) / (THREADS * u);
    long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1) *
                       (u == 1 ? 4 : 1);
    if (blocks > most) blocks = most;
    const long long step = regime == REGIME_WINDOWS ? window : m;
    for (long long lo = 0; lo < m; lo += step)
      kernel<<<(int)blocks, THREADS, 0, st>>>(
          table, idx, vals, last_pos, n, (int)lo,
          (int)(lo + step < m ? lo + step : m), 0);
  }
  if (OP == OP_SWP)
    swp_write_kernel<T><<<grid_for(m), THREADS, 0, st>>>(table, vals, last_pos,
                                                         m);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_table_op(int op, T* table, const int* idx,
                                   const T* vals, int* last_pos, long long n,
                                   int m, int regime, long long window,
                                   cudaStream_t st) {
#define TABLE(OP) \
  launch_table<T, OP>(table, idx, vals, last_pos, n, m, regime, window, st)
  switch (op) {
    case OP_FAA: return TABLE(OP_FAA);
    case OP_SWP: return TABLE(OP_SWP);
    case OP_MIN: return TABLE(OP_MIN);
    default: return TABLE(OP_MAX);
  }
#undef TABLE
}

// rmw_table (faa, swp, min, max) and slot_counts (count: int32, no values)
// into `table`, a copy of the input table (slot_counts: zeros) that the
// kernels update in place.  `last_pos` (SWP): m int32 set to -1.  `regime`
// as kernel.table_regime picks it; `window` the slots of an L2 window.
extern "C" int table_combine_launch(void* table, const void* idx,
                                    const void* vals, void* last_pos,
                                    long long n, long long m, int op,
                                    int dtype, int regime, long long window,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool count = op == OP_COUNT;
  if ((op != OP_FAA && op != OP_SWP && op != OP_MIN && op != OP_MAX && !count)
      || (dtype != DT_INT32 && dtype != DT_FLOAT32)
      || (count && dtype != DT_INT32) || (op == OP_SWP && last_pos == nullptr)
      || regime < REGIME_GLOBAL || regime > REGIME_WINDOWS
      || (regime == REGIME_WINDOWS && window < 1) || n < 0 || n > INT_MAX
      || m < 0 || m > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return (int)cudaGetLastError();
  cudaError_t err;
  if (count)
    err = launch_table<int, OP_COUNT>((int*)table, (const int*)idx, nullptr,
                                      nullptr, n, (int)m, regime, window, st);
  else if (dtype == DT_INT32)
    err = launch_table_op<int>(op, (int*)table, (const int*)idx,
                               (const int*)vals, (int*)last_pos, n, (int)m,
                               regime, window, st);
  else
    err = launch_table_op<float>(op, (float*)table, (const int*)idx,
                                 (const float*)vals, (int*)last_pos, n,
                                 (int)m, regime, window, st);
  return (int)err;
}

// Scratch layout of rmw_table_fetched for a batch of n ops (bytes); the
// wrapper asks rmw_table_fetched_layout below for its size.
struct FetchedLayout {
  long long counters, hist, status, keys[2], pos[2], zeroed, total;
};

static long long align256(long long b) { return (b + 255) & ~255LL; }

static FetchedLayout fetched_layout(long long n) {
  FetchedLayout L;
  const long long tiles = (n + TILE - 1) / TILE;
  const long long pairs = align256(4 * n);
  L.counters = 0;
  L.hist = align256(N_COUNTERS * 4);
  L.status = L.hist + align256(HIST_ROWS * DIGITS * 4);
  L.zeroed = L.status + align256(tiles * DIGITS * 8);
  L.keys[0] = L.zeroed;
  L.pos[0] = L.keys[0] + pairs;
  L.keys[1] = L.pos[0] + pairs;
  L.pos[1] = L.keys[1] + pairs;
  L.total = L.pos[1] + pairs;
  return L;
}

static int bit_length(long long x) {
  int bits = 0;
  while (bits < 62 && (x >> bits) > 0) ++bits;
  return bits;
}

// The kernels in order.  Look-back stage s (compact 0, slot pass p 1 + p,
// scan 1 + P, position pass 2 + P) takes tickets from counters[s] and
// flags 2s + 1 (aggregate) and 2s + 2 (inclusive).
template <typename T>
static void launch_fetched(const T* table, T* out, const int* idx,
                           const T* vals, T* fetched, uint8_t* success,
                           char* scratch, const FetchedLayout& L, long long n,
                           int m, int op, T expected, cudaStream_t st) {
  int* counters = (int*)(scratch + L.counters);
  int* hist = (int*)(scratch + L.hist);
  u64* status = (u64*)(scratch + L.status);
  int* keys[2] = {(int*)(scratch + L.keys[0]), (int*)(scratch + L.keys[1])};
  int* pos[2] = {(int*)(scratch + L.pos[0]), (int*)(scratch + L.pos[1])};
  const int tiles = (int)((n + TILE - 1) / TILE);
  // slots 0..m-1 in ceil(bit_length(m - 1) / DBITS) passes
  const int passes = (bit_length(m - 1) + DBITS - 1) / DBITS;
  const int bits_n = bit_length(n - 1);
  const int pos_shift = bits_n > DBITS ? bits_n - DBITS : 0;
  fetched_compact_kernel<T><<<tiles, FT, 0, st>>>(
      idx, fetched, success, keys[0], pos[0], status, counters, hist, n, m,
      passes, pos_shift, op == OP_CAS ? 0 : 1);
  for (int p = 0; p < passes; ++p)
    fetched_radix_kernel<<<tiles, FT, 0, st>>>(
        keys[p & 1], pos[p & 1], keys[(p + 1) & 1], pos[(p + 1) & 1], status,
        counters, hist + p * DIGITS, p * DBITS, 1 + p, 2 * (1 + p) + 1);
  const int f = passes & 1;            // the buffer the last pass wrote
#define FETCHED_SCAN(OP)                                                  \
  fetched_scan_kernel<T, OP><<<tiles, FT, 0, st>>>(                       \
      table, out, keys[f], pos[f], vals, pos[1 - f],                      \
      (unsigned*)keys[1 - f], status, counters, 1 + passes,               \
      2 * (1 + passes) + 1, expected)
  switch (op) {
    case OP_FAA: FETCHED_SCAN(OP_FAA); break;
    case OP_SWP: FETCHED_SCAN(OP_SWP); break;
    case OP_MIN: FETCHED_SCAN(OP_MIN); break;
    case OP_MAX: FETCHED_SCAN(OP_MAX); break;
    default: FETCHED_SCAN(OP_CAS); break;
  }
#undef FETCHED_SCAN
  // (position, fetched) pairs bucketed by the positions' top digit
  fetched_radix_kernel<<<tiles, FT, 0, st>>>(
      pos[1 - f], keys[1 - f], pos[f], keys[f], status, counters,
      hist + MAX_PASSES * DIGITS, pos_shift, 2 + passes,
      2 * (2 + passes) + 1);
  fetched_scatter_kernel<<<tiles, FT, 0, st>>>(
      pos[f], (const unsigned*)keys[f], (unsigned*)fetched, counters);
  if (op == OP_CAS)
    cas_success_kernel<T><<<grid_for(n), THREADS, 0, st>>>(
        idx, fetched, success, n, m, expected);
}

// The scratch bytes rmw_table_fetched_launch needs for n ops, and the bits
// of its radix digit (the passes for m slots: ceil(bit_length(m - 1) /
// digit_bits)).
extern "C" int rmw_table_fetched_layout(long long n, long long* scratch_bytes,
                                        int* digit_bits) {
  if (n < 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *scratch_bytes = n > 0 ? fetched_layout(n).total : 0;
  *digit_bits = DBITS;
  return 0;
}

// `table` is only read; `out` (a copy of it) receives the final values.
extern "C" int rmw_table_fetched_launch(const void* table, void* out,
                                        const void* idx, const void* vals,
                                        void* fetched, void* success,
                                        void* scratch, long long scratch_bytes,
                                        long long n, long long m, int op,
                                        int dtype, double expected,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (op < OP_FAA || op > OP_CAS || (dtype != DT_INT32 && dtype != DT_FLOAT32)
      || n < 0 || n > 0x7fffffffLL || m < 0 || m > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const FetchedLayout L = fetched_layout(n);
    if (scratch_bytes < L.total) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(scratch, 0, L.zeroed, st);
    if (err != cudaSuccess) return (int)err;
    if (dtype == DT_INT32)
      launch_fetched<int>((const int*)table, (int*)out, (const int*)idx,
                          (const int*)vals, (int*)fetched, (uint8_t*)success,
                          (char*)scratch, L, n, (int)m, op, (int)expected, st);
    else
      launch_fetched<float>((const float*)table, (float*)out,
                            (const int*)idx, (const float*)vals,
                            (float*)fetched, (uint8_t*)success,
                            (char*)scratch, L, n, (int)m, op,
                            (float)expected, st);
  }
  return (int)cudaGetLastError();
}
