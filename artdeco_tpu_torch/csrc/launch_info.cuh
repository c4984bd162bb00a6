// The launch shape of a kernel, as the runtime reports it: what
// chip_smoke.py phase 1 prints beside the build log.
#pragma once

#include <cuda_runtime.h>

// info[0..6]: threads per block, cluster size, registers per thread, local
// (spill) bytes per thread, static shared bytes per block, blocks one SM
// holds at once, clusters the card holds at once (-1 where the runtime
// refuses the query).
template <class Kernel>
inline int launch_info(Kernel* kernel, int threads, int cluster, int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = threads;
  info[1] = cluster;
  info[2] = a.numRegs;
  info[3] = (int)a.localSizeBytes;
  info[4] = (int)a.sharedSizeBytes;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0) != cudaSuccess)
    n = -1;
  info[5] = n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg) !=
      cudaSuccess)
    n = -1;
  info[6] = n;
  cudaGetLastError();  // a refused query leaves no error behind
  return 0;
}
