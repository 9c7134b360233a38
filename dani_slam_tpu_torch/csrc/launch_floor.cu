// An empty kernel behind the same kind of C entry point as the port's
// kernels (one launch on the caller's stream, the launch error returned).
// Its time is the floor under the time of any separately launched kernel:
// chip_smoke.py reports it beside the kernels' times, whose bounds of 1-2 us
// no single launch can reach.
#include <cuda_runtime.h>

namespace {
__global__ void launch_floor_kernel() {}
}  // namespace

extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
