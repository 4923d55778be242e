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
// Op codes: 0 faa, 1 swp, 2 min, 3 max, 4 cas.  Dtype codes: 0 int32, 1 fp32.
//
// ---------------------------------------------------------------------------
// rmw_table  (replaces src/repro/kernels/rmw/kernel.py::rmw_table, body
//             _rmw_kernel: the one-hot (block x tile) MXU contraction)
//   Computes the table after the batch, no per-op outputs.
//   Bound: bytes.  Each op reads its index and value (8 B), the table is read
//   and written once (8 B per slot): (8 n + 8 m) / 3.35 TB/s.
//   Design: one thread per op, hardware atomics on the table, which the
//   order-free ops tolerate exactly: atomicAdd (FAA), atomicMin/atomicMax
//   (int32; fp32 through the order-preserving int/uint mapping of the bits).
//   SWP is last-wins by batch position: pass 1 takes atomicMax(last[slot], i)
//   on an int32 scratch set to -1, pass 2 writes vals[last[slot]].  No tile
//   or one-hot matrix: the card's L2 atomics do the combining the TPU did on
//   the MXU.  Hardware atomics only ever build the final table here; they
//   return values in thread order, never the serialized fetched values.
//
// rmw_table_fetched  (replaces kernel.py::rmw_table_fetched, body
//             _rmw_fetched_kernel: per-tile pallas_calls, each a 1-D grid over
//             index blocks with a strict-lower-triangular one-hot prefix)
//   Computes (table, fetched, success) in serialized batch order for
//   faa/min/max/swp and uniform-expected CAS.
//   Bound: bytes, (8 n in + 5 n out + 8 m) / 3.35 TB/s; in practice the
//   ordered chain below (one dependent step per block of 1024 ops).
//   Design: one CTA per block of FB ops, in batch order by a dynamic ticket
//   (so a block's predecessor is always resident: no deadlock).  Phase 1,
//   unordered and overlapped across resident CTAs: the block's idx/vals go
//   to shared memory and each thread scans the block for its slot's
//   exclusive prefix (FAA sum, MIN/MAX reduce, SWP previous collider, CAS
//   first value != expected) and whether it is its slot's last op in the
//   block — the strict-lower-triangular mask of the TPU kernel as a loop
//   over shared memory.  Phase 2, ordered: spin on the predecessor's flag,
//   gather base = table[idx] past L1 (__ldcg), derive fetched/success, let
//   each slot's last op write the slot's new value, __threadfence(), publish.
//   The chain of n/FB steps is what bounds this kernel; a decoupled
//   look-back or a sort-based design is later work.
//
// slot_counts  (replaces kernel.py::slot_counts, body _slot_count_kernel:
//             column sums of the one-hot matrix)
//   Computes the (m,) int32 per-slot occupancy.
//   Bound: bytes, (4 n + 4 m) / 3.35 TB/s.
//   Design: an exact integer histogram.  Per-CTA counters in shared memory
//   (privatised, flushed with one global atomicAdd per non-zero bin) while m
//   fits in 48K slots and the flush is cheaper than the ops; global
//   atomicAdd otherwise.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

enum { OP_FAA = 0, OP_SWP = 1, OP_MIN = 2, OP_MAX = 3, OP_CAS = 4 };
enum { DT_INT32 = 0, DT_FLOAT32 = 1 };

static const int FB = 1024;            // ops per block of the fetched kernel
static const int THREADS = 256;        // threads per block of the others
static const int MAX_BLOCKS = 132 * 32;
static const int SMEM_HIST_SLOTS = 48 * 1024;

// --- arithmetic that matches the plain PyTorch versions bit for bit -------

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);   // int32 wraps, as torch does
}
__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T max_of(T a, T b) { return b > a ? b : a; }

__device__ __forceinline__ void atomic_min_t(int* a, int v) { atomicMin(a, v); }
__device__ __forceinline__ void atomic_max_t(int* a, int v) { atomicMax(a, v); }

// fp32 min/max by the order-preserving mapping: non-negative floats order as
// signed ints, negative floats order in reverse as unsigned ints.  Exact for
// every non-NaN value (min/max ignore the order of the batch).
__device__ __forceinline__ void atomic_min_t(float* a, float v) {
  if (!(__float_as_uint(v) >> 31)) atomicMin((int*)a, __float_as_int(v));
  else atomicMax((unsigned int*)a, __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_t(float* a, float v) {
  if (!(__float_as_uint(v) >> 31)) atomicMax((int*)a, __float_as_int(v));
  else atomicMin((unsigned int*)a, __float_as_uint(v));
}

// --- rmw_table -------------------------------------------------------------

template <typename T>
__global__ void rmw_table_kernel(T* __restrict__ table,
                                 const int* __restrict__ idx,
                                 const T* __restrict__ vals,
                                 int* __restrict__ last_pos,
                                 long long n, int m, int op) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = idx[i];
    if (s < 0 || s >= m) continue;
    switch (op) {
      case OP_FAA: atomicAdd(&table[s], vals[i]); break;
      case OP_MIN: atomic_min_t(&table[s], vals[i]); break;
      case OP_MAX: atomic_max_t(&table[s], vals[i]); break;
      default: atomicMax(&last_pos[s], (int)i); break;   // OP_SWP
    }
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

template <typename T>
__global__ void __launch_bounds__(FB)
rmw_fetched_kernel(T* __restrict__ table, const int* __restrict__ idx,
                   const T* __restrict__ vals, T* __restrict__ fetched,
                   uint8_t* __restrict__ success, int* counters, long long n,
                   int m, int op, T expected) {
  __shared__ int s_idx[FB];
  __shared__ T s_val[FB];
  __shared__ int s_ticket;
  const int tid = threadIdx.x;

  // counters[0]: next ticket; counters[1]: number of blocks published.
  if (tid == 0) s_ticket = atomicAdd(&counters[0], 1);
  __syncthreads();
  const int t = s_ticket;
  const long long g = (long long)t * FB + tid;
  const bool in_batch = g < n;

  int my = -1;
  T v = T(0);
  if (in_batch) {
    my = idx[g];
    v = vals[g];
    if (my < 0 || my >= m) my = -1;   // dropped: matches no valid op
  }
  s_idx[tid] = my;
  s_val[tid] = v;
  __syncthreads();

  // Phase 1 (unordered): exclusive same-slot prefix over earlier positions.
  bool has_prev = false, is_last = true;
  T prefix = T(0);
  int prev = -1, first_ne = -1;
  if (my >= 0) {
    for (int j = 0; j < FB; ++j) {
      if (s_idx[j] != my) continue;
      if (j > tid) { is_last = false; continue; }
      if (j == tid) continue;
      const T sv = s_val[j];
      if (op == OP_FAA) prefix = has_prev ? add_wrap(prefix, sv) : sv;
      else if (op == OP_MIN) prefix = has_prev ? min_of(prefix, sv) : sv;
      else if (op == OP_MAX) prefix = has_prev ? max_of(prefix, sv) : sv;
      else if (op == OP_SWP) prev = j;
      else if (first_ne < 0 && sv != expected) first_ne = j;   // OP_CAS
      has_prev = true;
    }
  }

  // Phase 2 (ordered): wait for the predecessor block to publish.
  if (tid == 0 && t > 0) {
    volatile int* done = counters + 1;
    while (*done < t) {
    }
    __threadfence();
  }
  __syncthreads();
  T base = T(0);
  if (my >= 0) base = __ldcg(&table[my]);
  __syncthreads();   // every read of the block precedes its writes

  if (my >= 0) {
    T f = base, after;
    bool ok = true;
    switch (op) {
      case OP_FAA:
        if (has_prev) f = add_wrap(base, prefix);
        after = add_wrap(f, v);
        break;
      case OP_MIN:
        if (has_prev) f = min_of(base, prefix);
        after = min_of(f, v);
        break;
      case OP_MAX:
        if (has_prev) f = max_of(base, prefix);
        after = max_of(f, v);
        break;
      case OP_SWP:
        if (prev >= 0) f = s_val[prev];
        after = v;
        break;
      default:   // OP_CAS, uniform expected: the slot holds `expected` until
                 // the first op writing another value, then that value
        if (base == expected && first_ne >= 0) f = s_val[first_ne];
        ok = f == expected;
        after = ok ? v : f;
        break;
    }
    fetched[g] = f;
    success[g] = ok ? 1 : 0;
    if (is_last) __stcg(&table[my], after);
  } else if (in_batch) {
    fetched[g] = T(0);
    success[g] = 0;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicExch(&counters[1], t + 1);
}

// --- slot_counts -----------------------------------------------------------

__global__ void slot_counts_smem_kernel(const int* __restrict__ idx,
                                        int* __restrict__ counts, long long n,
                                        int m) {
  extern __shared__ int hist[];
  for (int s = threadIdx.x; s < m; s += blockDim.x) hist[s] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = idx[i];
    if (s >= 0 && s < m) atomicAdd(&hist[s], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < m; s += blockDim.x) {
    const int c = hist[s];
    if (c) atomicAdd(&counts[s], c);
  }
}

__global__ void slot_counts_global_kernel(const int* __restrict__ idx,
                                          int* __restrict__ counts,
                                          long long n, int m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = idx[i];
    if (s >= 0 && s < m) atomicAdd(&counts[s], 1);
  }
}

// --- C entries -------------------------------------------------------------

static int grid_for(long long work) {
  long long b = (work + THREADS - 1) / THREADS;
  if (b < 1) b = 1;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

extern "C" int rmw_table_launch(void* table, const void* idx, const void* vals,
                                void* last_pos, long long n, long long m,
                                int op, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (op < OP_FAA || op > OP_MAX || (dtype != DT_INT32 && dtype != DT_FLOAT32))
    return (int)cudaErrorInvalidValue;
  if (n > 0 && m > 0) {
    const int blocks = grid_for(n);
    if (dtype == DT_INT32)
      rmw_table_kernel<int><<<blocks, THREADS, 0, st>>>(
          (int*)table, (const int*)idx, (const int*)vals, (int*)last_pos, n,
          (int)m, op);
    else
      rmw_table_kernel<float><<<blocks, THREADS, 0, st>>>(
          (float*)table, (const int*)idx, (const float*)vals, (int*)last_pos,
          n, (int)m, op);
    if (op == OP_SWP) {
      const int mb = grid_for(m);
      if (dtype == DT_INT32)
        swp_write_kernel<int><<<mb, THREADS, 0, st>>>(
            (int*)table, (const int*)vals, (const int*)last_pos, (int)m);
      else
        swp_write_kernel<float><<<mb, THREADS, 0, st>>>(
            (float*)table, (const float*)vals, (const int*)last_pos, (int)m);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int rmw_table_fetched_launch(void* table, const void* idx,
                                        const void* vals, void* fetched,
                                        void* success, void* counters,
                                        long long n, long long m, int op,
                                        int dtype, double expected,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (op < OP_FAA || op > OP_CAS || (dtype != DT_INT32 && dtype != DT_FLOAT32))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (int)((n + FB - 1) / FB);
    if (dtype == DT_INT32)
      rmw_fetched_kernel<int><<<blocks, FB, 0, st>>>(
          (int*)table, (const int*)idx, (const int*)vals, (int*)fetched,
          (uint8_t*)success, (int*)counters, n, (int)m, op, (int)expected);
    else
      rmw_fetched_kernel<float><<<blocks, FB, 0, st>>>(
          (float*)table, (const int*)idx, (const float*)vals,
          (float*)fetched, (uint8_t*)success, (int*)counters, n, (int)m, op,
          (float)expected);
  }
  return (int)cudaGetLastError();
}

extern "C" int slot_counts_launch(const void* idx, void* counts, long long n,
                                  long long m, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && m > 0) {
    const int blocks = grid_for(n / 16);
    if (m <= SMEM_HIST_SLOTS && (long long)blocks * m <= n) {
      const int bytes = (int)(m * sizeof(int));
      cudaError_t err = cudaFuncSetAttribute(
          slot_counts_smem_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
      slot_counts_smem_kernel<<<blocks, THREADS, bytes, st>>>(
          (const int*)idx, (int*)counts, n, (int)m);
    } else {
      slot_counts_global_kernel<<<grid_for(n), THREADS, 0, st>>>(
          (const int*)idx, (int*)counts, n, (int)m);
    }
  }
  return (int)cudaGetLastError();
}
