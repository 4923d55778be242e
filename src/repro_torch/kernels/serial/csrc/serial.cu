// One-thread device loops for Hopper (sm_90a): the serialized RMW executor
// and the dependent pointer chase.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -I <repro_torch/kernels> -o libserial.so serial.cu
// Bound to PyTorch through the plain C entries at the bottom (ctypes, see
// ../kernel.py and ../../build.py).  Every entry launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().
//
// Both kernels are launched <<<1, 1>>>: the order of the ops is the
// semantics, so one thread runs them one after another.  Neither replaces a
// Pallas kernel: each is the device counterpart of a loop that the
// reference runs on its accelerator.
//
// ---------------------------------------------------------------------------
// serial_rmw  (counterpart of src/repro/core/rmw.py:106 rmw_serialized, a
//             lax.scan over the batch)
//   Applies a batch to the table in batch order with the card's atomic
//   instructions, one op after another, and writes each op's fetched value
//   (the word before the op) and success flag: the serialized oracle's
//   (table, fetched, success), core/rmw.py's host loop bit for bit (NaN
//   compared as NaN).  Op codes 0 faa, 1 swp, 2 min, 3 max, 4 cas; dtype
//   codes 0 int32, 1 fp32; CAS takes a per-op `expected` array.  Index
//   conventions are the reference's: a negative index counts from the end;
//   an index outside the table after that reads the clamped slot (its
//   fetched value, and CAS's success against it) and writes nothing.
//   - int32: atom.global add (wrapping), exch, min, max, cas.
//   - fp32 FAA: atom.global.add.f32, which flushes subnormal inputs and
//     results to zero (PTX ISA); where the old word, the operand or the
//     sum is subnormal, the op then writes the unflushed sum by exch, so
//     the table keeps the host's IEEE sum.
//   - fp32 SWP: exch.  fp32 MIN/MAX: an atomic read (or of 0) and a
//     compare-and-swap in the reference's order (csrc/order.cuh: −0 below
//     +0, NaN wins), as kernels/rmw/csrc/rmw.cu's fp32 MIN/MAX.
//   - fp32 CAS compares values, as the host does: +0 matches −0 (a second
//     cas writes where the first compared the other zero's bits) and a NaN
//     `expected` matches nothing (an atomic read, no write).
//   Bound: latency.  Each op's fetched value is stored as soon as its
//   atomic returns; atomics to other words from the one thread may still
//   be in flight together, since the PTX memory model orders only the ops
//   of a thread on one address.  No fence or volatile forbids that
//   overlap: the paper's serialized mode is what one thread issuing a
//   batch of atomics gets on this card.
//
// chase  (counterpart of benchmarks/latency.py:60-92, the read walk and
//        the RMW chase, jitted fori_loops)
//   A dependent pointer chase over a table of m 32-bit words (m a power of
//   two) whose low log2(m) bits hold each slot's successor in one cycle
//   through every slot, f(p) = (a p + c) mod m (a = 1 mod 4 and c odd, so
//   the cycle is single; the caller draws a and c from a seeded
//   generator): the next slot is the word & (m - 1).  Four modes, each
//   `steps` ops long:
//   - read: a plain load (ld.global, through the L1);
//   - faa:  atomicAdd(word, m): the next address is the atomic's return;
//           the high bits count the visits (mod 2^32 / m), the low bits
//           keep the pointer;
//   - cas:  atomicCAS(word, p, p) at slot p: a word's low bits are f(p),
//           never p itself ((a - 1) p + c is odd), so the compare never
//           matches and the CAS returns the word unchanged (the
//           reference's where(old == c, old, old ^ 0));
//   - swp:  atomicExch(word, f(p)): the next address is the return, and
//           the word it writes is the link it replaces (its high bits
//           cleared), so every walk keeps the cycle.  f(p) is one multiply
//           and add on p, ready as the exch issues.
//   Writes the end slot.  Bound: latency, steps x the load-to-use latency
//   of the tier the table sits in.
//
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "csrc/order.cuh"
#include "csrc/stamp.cuh"

enum { OP_FAA = 0, OP_SWP = 1, OP_MIN = 2, OP_MAX = 3, OP_CAS = 4 };
enum { DT_INT32 = 0, DT_FLOAT32 = 1 };
enum { CHASE_READ = 0, CHASE_FAA = 1, CHASE_SWP = 2, CHASE_CAS = 3 };

// --- serial_rmw -------------------------------------------------------------

__device__ __forceinline__ bool is_subnormal(float x) {
  const unsigned b = __float_as_uint(x) & 0x7fffffffu;
  return b != 0u && b < 0x00800000u;
}

// An atomic read: OR with 0 returns the word and leaves it as it was.
__device__ __forceinline__ unsigned atomic_read(unsigned* w) {
  return atomicOr(w, 0u);
}

template <int OP>
__device__ __forceinline__ int apply(int* w, int v, int e, bool* ok) {
  if constexpr (OP == OP_FAA) return atomicAdd(w, v);
  else if constexpr (OP == OP_SWP) return atomicExch(w, v);
  else if constexpr (OP == OP_MIN) return atomicMin(w, v);
  else if constexpr (OP == OP_MAX) return atomicMax(w, v);
  else {
    const int old = atomicCAS(w, e, v);
    *ok = old == e;
    return old;
  }
}

template <int OP>
__device__ __forceinline__ float apply(float* w, float v, float e, bool* ok) {
  unsigned* u = reinterpret_cast<unsigned*>(w);
  if constexpr (OP == OP_FAA) {
    const float old = atomicAdd(w, v);
    const float sum = __fadd_rn(old, v);
    if (is_subnormal(old) || is_subnormal(v) || is_subnormal(sum))
      atomicExch(w, sum);                      // undo the flush to zero
    return old;
  } else if constexpr (OP == OP_SWP) {
    return atomicExch(w, v);
  } else if constexpr (OP == OP_MIN || OP == OP_MAX) {
    unsigned old = atomic_read(u);
    while (true) {
      const float cur = __uint_as_float(old);
      const unsigned want = __float_as_uint(OP == OP_MIN ? min_of(cur, v)
                                                         : max_of(cur, v));
      if (want == old) break;
      const unsigned seen = atomicCAS(u, old, want);
      if (seen == old) break;
      old = seen;
    }
    return __uint_as_float(old);
  } else {
    if (e != e) {                              // NaN equals nothing
      *ok = false;
      return __uint_as_float(atomic_read(u));
    }
    const unsigned vb = __float_as_uint(v);
    unsigned old = atomicCAS(u, __float_as_uint(e), vb);
    if (e == 0.0f && old != __float_as_uint(e) && (old & 0x7fffffffu) == 0u)
      old = atomicCAS(u, old, vb);             // the other zero: equal
    *ok = __uint_as_float(old) == e;
    return __uint_as_float(old);
  }
}

template <typename T, int OP>
__global__ void serial_rmw_kernel(T* table, const int* __restrict__ idx,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ expected,
                                  T* __restrict__ fetched,
                                  bool* __restrict__ success, long long n,
                                  long long m, unsigned long long* stamp) {
  stamp_entry(stamp);
  for (long long k = 0; k < n; ++k) {
    long long j = idx[k];
    if (j < 0) j += m;
    const T v = vals[k];
    const T e = OP == OP_CAS ? expected[k] : T(0);
    bool ok = true;
    T old;
    if (j >= 0 && j < m) {
      old = apply<OP>(&table[j], v, e, &ok);
    } else {                          // dropped: read the clamped slot
      old = __ldcg(&table[j < 0 ? 0 : m - 1]);
      if (OP == OP_CAS) ok = old == e;
    }
    fetched[k] = old;
    success[k] = ok;
  }
  stamp_exit(stamp);
}

template <typename T>
static cudaError_t serial_rmw_typed(void* table, const void* idx,
                                    const void* vals, const void* expected,
                                    void* fetched, void* success, long long n,
                                    long long m, int op,
                                    unsigned long long* stamp,
                                    cudaStream_t s) {
  T* t = static_cast<T*>(table);
  const int* i = static_cast<const int*>(idx);
  const T* v = static_cast<const T*>(vals);
  const T* e = static_cast<const T*>(expected);
  T* f = static_cast<T*>(fetched);
  bool* ok = static_cast<bool*>(success);
#define SERIAL_RMW(OP)                                                  \
  serial_rmw_kernel<T, OP><<<1, 1, 0, s>>>(t, i, v, e, f, ok, n, m,    \
                                           stamp);                      \
  break
  switch (op) {
    case OP_FAA: SERIAL_RMW(OP_FAA);
    case OP_SWP: SERIAL_RMW(OP_SWP);
    case OP_MIN: SERIAL_RMW(OP_MIN);
    case OP_MAX: SERIAL_RMW(OP_MAX);
    case OP_CAS: SERIAL_RMW(OP_CAS);
    default: return cudaErrorInvalidValue;
  }
#undef SERIAL_RMW
  return cudaGetLastError();
}

// --- chase ------------------------------------------------------------------

__global__ void chase_kernel(unsigned* table, unsigned mask, unsigned a,
                             unsigned c, unsigned start, long long steps,
                             int mode, unsigned* end) {
  unsigned p = start;
  if (mode == CHASE_READ) {
    for (long long k = 0; k < steps; ++k) p = table[p] & mask;
  } else if (mode == CHASE_FAA) {
    for (long long k = 0; k < steps; ++k)
      p = atomicAdd(&table[p], mask + 1u) & mask;
  } else if (mode == CHASE_CAS) {
    for (long long k = 0; k < steps; ++k)
      p = atomicCAS(&table[p], p, p) & mask;
  } else {
    for (long long k = 0; k < steps; ++k)
      p = atomicExch(&table[p], (a * p + c) & mask) & mask;
  }
  *end = p;
}

// --- C entries --------------------------------------------------------------

// `stamp_pair`: a telemetry.events.StampRing pair (csrc/stamp.cuh), or
// null.
extern "C" int serial_rmw_launch(void* table, const void* idx,
                                 const void* vals, const void* expected,
                                 void* fetched, void* success, long long n,
                                 long long m, int op, int dtype,
                                 void* stamp_pair, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* stamp = static_cast<unsigned long long*>(stamp_pair);
  if (dtype == DT_INT32)
    return (int)serial_rmw_typed<int>(table, idx, vals, expected, fetched,
                                      success, n, m, op, stamp, s);
  if (dtype == DT_FLOAT32)
    return (int)serial_rmw_typed<float>(table, idx, vals, expected, fetched,
                                        success, n, m, op, stamp, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int chase_launch(void* table, long long m, long long a,
                            long long c, long long start, long long steps,
                            int mode, void* end, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(table), (unsigned)(m - 1), (unsigned)a,
      (unsigned)c, (unsigned)start, steps, mode,
      static_cast<unsigned*>(end));
  return (int)cudaGetLastError();
}
