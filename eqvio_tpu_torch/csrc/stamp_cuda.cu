// Frame stamps: one thread writes the card's global nanosecond timer
// (%globaltimer) into one slot of an int64 row.
//
// Replaces no TPU kernel: the JAX package times its stages by running stage
// programs again outside the frames that ran.  Launched on the current
// stream between two stages of the captured frame step, a stamp runs after
// every kernel of the stage before it and before every kernel of the stage
// after it, so two stamps bracket a stage's device time in the frames that
// ran.  Bound by nothing but its launch: one thread, one 8-byte store.
// Built and loaded only when a run asks for stamps (kernels/stamp.py).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void frame_stamp_kernel(long long* row, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  row[slot] = (long long)t;
}

// C entry point for ctypes: `row` is a device pointer to int64 slots.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a negative slot.
extern "C" int frame_stamp(long long* row, int slot, void* stream) {
  if (row == nullptr || slot < 0) return (int)cudaErrorInvalidValue;
  frame_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(row, slot);
  return (int)cudaGetLastError();
}
