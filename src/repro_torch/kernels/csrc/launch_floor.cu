// An empty kernel: what one launch costs on the card with no work in it.
//
// Not a port of any TPU kernel and on no serving path. The kernels phase of
// chip_smoke.py times it the way it times the kernels (a replayed CUDA
// graph, and eagerly through the same ctypes path), and the Qwen serve
// profile reads its device duration beside theirs: the floor that no
// kernel's time can go below, however little work it does.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// One block of one warp on ``stream``. Returns the launch's cudaError_t.
extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
