// A dry run of a launch entry, for the launch-contract checks.
// <lib>_query(out) arms lq::g_query; the next call of one of the library's
// launch entries (with null pointers) runs its checks and its choice of
// kernel, grid and shared memory as a launch would, fills `out` where it
// would launch, and launches nothing:
//   out[0..2] grid x, y, z; out[3] threads a CTA; out[4] dynamic shared
//   memory; out[5] static shared memory and out[6] registers a thread
//   (cudaFuncGetAttributes); out[7] the CTAs an SM holds at that shared
//   memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// <lib>_query(nullptr) disarms it (the caller does, whatever the entry
// returned).  The armed state is the calling thread's own: a launch from
// any other thread launches, whatever this one has armed.
#pragma once
#include <cuda_runtime.h>

namespace lq {

inline thread_local long long* g_query = nullptr;

inline int fill(const void* fn, dim3 grid, dim3 block, size_t smem) {
  long long* o = g_query;
  g_query = nullptr;
  o[0] = grid.x;
  o[1] = grid.y;
  o[2] = grid.z;
  o[3] = (long long)block.x * block.y * block.z;
  o[4] = (long long)smem;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  o[5] = (long long)a.sharedSizeBytes;
  o[6] = a.numRegs;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, (int)o[3],
                                                      smem);
  o[7] = n;
  return (int)err;
}

}  // namespace lq

// inside a launch entry, just before its launch
#define QUERY_OR_LAUNCH(fn, grid, block, smem) \
  if (lq::g_query) return lq::fill((const void*)(fn), grid, block, smem)

#define LAUNCH_QUERY_ENTRY(lib) \
  extern "C" void lib##_query(long long* out) { lq::g_query = out; }
