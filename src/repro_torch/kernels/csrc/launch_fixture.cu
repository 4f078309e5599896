// The launch fixture: a kernel that computes nothing, launched at a given
// geometry, so that the card's runtime itself takes or refuses a launch
// configuration.  Counterpart of the no-op kernel that
// repro/analysis/fixtures.py:_capture_2d fabricates for the static-analysis
// self-tests.  It reads its arguments and writes nothing.
#include <cuda_runtime.h>

#include "launch_query.cuh"

__global__ void launch_fixture_kernel(float* out, int rows, int cols) {
  extern __shared__ float smem[];
  // never true for a launch the wrapper makes (rows, cols >= 1); kept so
  // that the arguments and the shared memory are read, not optimized out
  if (rows < 0 && cols < 0 && out != nullptr) smem[threadIdx.x] = out[0];
}

// rc[0]: the cudaError_t of cudaFuncSetAttribute (called where the dynamic
// shared memory is above the 48 KB a launch takes without an opt-in, else
// 0); rc[1]: that of the launch.  Returns the launch's, else the
// attribute's.
extern "C" int launch_fixture_launch(float* out, int rows, int cols,
                                     int grid_x, int grid_y, int threads,
                                     int smem, int* rc, void* stream) {
  rc[0] = 0;
  if (smem > 48 * 1024) {
    rc[0] = (int)cudaFuncSetAttribute(
        launch_fixture_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    cudaGetLastError();   // the launch below gives its own verdict
  }
  QUERY_OR_LAUNCH(launch_fixture_kernel, dim3(grid_x, grid_y),
                  dim3(threads), (size_t)smem);
  launch_fixture_kernel<<<dim3(grid_x, grid_y), dim3(threads), smem,
                          (cudaStream_t)stream>>>(out, rows, cols);
  rc[1] = (int)cudaGetLastError();
  return rc[1] ? rc[1] : rc[0];
}

// The device's launch limits, in the order of DEVICE_ATTRS in
// kernels/launch_fixture.py
extern "C" int launch_fixture_device_attrs(int device, int* out) {
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlock,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxThreadsPerBlock,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMaxBlocksPerMultiprocessor,
      cudaDevAttrMaxGridDimX,
      cudaDevAttrMaxGridDimY,
      cudaDevAttrMaxGridDimZ,
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxRegistersPerBlock};
  for (int i = 0; i < (int)(sizeof(attrs) / sizeof(attrs[0])); ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(out + i, attrs[i], device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

LAUNCH_QUERY_ENTRY(launch_fixture)
