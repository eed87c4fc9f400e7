// An empty kernel, launched through the same wrapper path as the port's
// kernels (ops/_build.py `launch`): its time, taken the way a kernel's is,
// is the floor that launching sets under any kernel's time at a small
// batch.  It replaces no TPU kernel and runs on no path of the port.

#include <cuda_runtime.h>

namespace {

__global__ void noop_kernel() {}

}  // namespace

extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}
