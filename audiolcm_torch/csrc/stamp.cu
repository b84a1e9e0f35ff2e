// Device timestamps for the recorder (audiolcm_torch/obs.py).
//
// One thread reads the card's global nanosecond timer (%globaltimer) and
// writes it into a ring of int64 at the slot that a device-side head counter
// names, then advances the head. Launched on the current stream at each
// boundary of a timed stage, it runs in stream order, after the work before
// it. Inside a CUDA graph capture the launch becomes a kernel node, so every
// replay stamps into the next free slots with no host work; the host keeps
// its own count of the stamps it issued, reads the ring only when asked
// (`obs.snapshot()`), and pays no CUDA call per stage or per replay.
//
// Plain C interface, loaded with ctypes (audiolcm_torch/obs.py).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libstamp.so stamp.cu

#include <cuda_runtime.h>

__global__ void stamp_kernel(long long* ring, long long* head, long long mask) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long i = *head;
  ring[i & mask] = t;
  *head = i + 1;
}

// ring: int64[mask + 1] (a power of two), head: int64[1], both on the
// stream's device. Returns the CUDA error of the launch (0: none).
extern "C" int stamp_launch(void* ring, void* head, long long mask, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(head), mask);
  return static_cast<int>(cudaGetLastError());
}
