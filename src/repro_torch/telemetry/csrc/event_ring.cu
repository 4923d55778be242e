// Timing events for measured eager calls (telemetry.events.EventRing).
//
// Not a kernel and no TPU counterpart: the reference times a measured call
// by the host clock around a jitted call that blocks.  The port times a
// call on the card by two CUDA events recorded on its stream, read back
// after the fact (telemetry.core.DeviceSeconds).  torch.cuda.Event's
// record, wait, two queries and elapsed time cost an H100's host about
// 9 us a pair before any read; here the events are made once per device,
// a record is one cudaEventRecord, and a window of pairs is read back in
// one call: one cudaEventSynchronize on the newest end event, then
// cudaEventElapsedTime for each pair (a pair on another stream that is
// not done yet is waited for on its own).
//
// Pair k holds events 2k (start) and 2k + 1 (end).
//
// stamp_ring_read: a window of telemetry.events.StampRing's pairs (two
// 64-bit words each, on the device) copied to pinned host memory and
// zeroed for reuse: one copy, one wait on the stream, one memset.
//
// globaltimer_probe: the resolution of %globaltimer, which the RMW kernels'
// stamps read (kernels/csrc/stamp.cuh; telemetry.events.StampRing): one
// thread reads it `reads` times back to back, and writes the least nonzero
// step between two reads, the number of steps, and the span in ns.

#include <cuda_runtime.h>
#include <stdlib.h>

struct EventRing {
  int device;
  int pairs;
  cudaEvent_t* ev;
};

extern "C" int event_ring_create(int device, int pairs, void** out) {
  if (pairs < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  EventRing* r = (EventRing*)malloc(sizeof(EventRing));
  cudaEvent_t* ev = (cudaEvent_t*)calloc(2 * (size_t)pairs,
                                         sizeof(cudaEvent_t));
  if (r == nullptr || ev == nullptr) {
    free(r);
    free(ev);
    cudaSetDevice(prev);
    return (int)cudaErrorMemoryAllocation;
  }
  r->device = device;
  r->pairs = pairs;
  r->ev = ev;
  for (int i = 0; i < 2 * pairs && err == cudaSuccess; ++i)
    err = cudaEventCreateWithFlags(&ev[i], cudaEventDefault);
  cudaSetDevice(prev);
  if (err != cudaSuccess) {
    for (int i = 0; i < 2 * pairs; ++i)
      if (ev[i] != nullptr) cudaEventDestroy(ev[i]);
    free(ev);
    free(r);
    return (int)err;
  }
  *out = r;
  return (int)cudaSuccess;
}

// Event k (2 x pair, + 1 for its end) on `stream`, a cudaStream_t of the
// ring's device.
extern "C" int event_ring_record(void* ring, int k, void* stream) {
  EventRing* r = (EventRing*)ring;
  if (k < 0 || k >= 2 * r->pairs) return (int)cudaErrorInvalidValue;
  return (int)cudaEventRecord(r->ev[k], (cudaStream_t)stream);
}

// Milliseconds of `count` pairs (`pair` their indices, the newest last)
// into `ms`.
extern "C" int event_ring_read(void* ring, const int* pair, int count,
                               float* ms) {
  EventRing* r = (EventRing*)ring;
  if (count < 1) return (int)cudaSuccess;
  for (int i = 0; i < count; ++i)
    if (pair[i] < 0 || pair[i] >= r->pairs) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaEventSynchronize(r->ev[2 * pair[count - 1] + 1]);
  for (int i = 0; i < count && err == cudaSuccess; ++i) {
    cudaEvent_t a = r->ev[2 * pair[i]], b = r->ev[2 * pair[i] + 1];
    err = cudaEventElapsedTime(&ms[i], a, b);
    if (err == cudaErrorNotReady) {
      err = cudaEventSynchronize(b);
      if (err == cudaSuccess) err = cudaEventElapsedTime(&ms[i], a, b);
    }
  }
  return (int)err;
}

extern "C" int event_ring_destroy(void* ring) {
  EventRing* r = (EventRing*)ring;
  cudaError_t first = cudaSuccess;
  for (int i = 0; i < 2 * r->pairs; ++i) {
    cudaError_t err = cudaEventDestroy(r->ev[i]);
    if (first == cudaSuccess) first = err;
  }
  free(r->ev);
  free(r);
  return (int)first;
}

// `count` pairs from pair `lo` of `words` into `host`, then zeroed, on
// `stream` (a cudaStream_t of the words' device).
extern "C" int stamp_ring_read(void* words, long long lo, long long count,
                               void* host, void* stream) {
  if (lo < 0 || count < 0) return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* w = (unsigned long long*)words + 2 * lo;
  const size_t bytes = (size_t)count * 2 * sizeof(unsigned long long);
  cudaError_t err = cudaMemcpyAsync(host, w, bytes, cudaMemcpyDeviceToHost,
                                    st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  if (err == cudaSuccess) err = cudaMemsetAsync(w, 0, bytes, st);
  return (int)err;
}

__global__ void globaltimer_probe_kernel(unsigned long long* out,
                                         long long reads) {
  unsigned long long prev, now, least = ~0ull, steps = 0, first;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(first));
  prev = first;
  for (long long i = 0; i < reads; ++i) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (now != prev) {
      ++steps;
      if (now - prev < least) least = now - prev;
      prev = now;
    }
  }
  out[0] = steps ? least : 0;
  out[1] = steps;
  out[2] = prev - first;
}

// out: 3 unsigned 64-bit words on the device (least step, steps, span).
extern "C" int globaltimer_probe(void* out, long long reads, void* stream) {
  globaltimer_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)out, reads);
  return (int)cudaGetLastError();
}
