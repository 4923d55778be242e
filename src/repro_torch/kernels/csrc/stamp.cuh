// Time stamps a batch's kernels write themselves (telemetry.events.
// StampRing), shared by the port's RMW sources (kernels/rmw/csrc/rmw.cu,
// kernels/serial/csrc/serial.cu).
//
// A pair is two 64-bit words, zero when reset (one fill_ resets a window
// of pairs).  Each block of a batch's first kernel stamps the pair's first
// word at entry, thread 0 reading %globaltimer (ns); the word keeps the
// earliest entry as its complement under atomicMax, so zero is "no entry
// yet".  Each block of the batch's last kernel stamps the second word
// after its last store, a __syncthreads() and a __threadfence(): atomicMax
// keeps the latest exit.  The batch's device time is exit - ~entry.  A
// null pointer stamps nothing.

#pragma once

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp_entry(unsigned long long* pair) {
  if (pair != nullptr && threadIdx.x == 0) atomicMax(pair, ~global_ns());
}

// Every thread of the block calls it (it holds a __syncthreads()).
__device__ __forceinline__ void stamp_exit(unsigned long long* pair) {
  if (pair == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicMax(pair + 1, global_ns());
  }
}
