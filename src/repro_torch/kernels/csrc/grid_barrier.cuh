// A grid-wide barrier for persistent, co-resident grids (a cooperative
// launch, or a grid capped at the co-resident count): shared by
// wave_elementwise.cu's epoch kernel and ready_queue.cu's pre-pass.
//
// Every block of the grid waits here until all have arrived; writes made
// before the barrier are visible to every block after it. The arrival
// count, zeroed by the wrapper per launch, only grows: the n-th barrier of
// the launch (n from 1) is passed once it reaches n * gridDim.x. A block's
// threads sync, its first thread fences, adds one and spins (no reset, no
// second word: one atomic a block). A block that is not resident would
// never arrive, so the grid must be co-resident.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void grid_barrier(unsigned int* arrivals, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrivals, 1u);
    const volatile unsigned int* seen = arrivals;
    while (*seen < target) {
    }
    __threadfence();
  }
  __syncthreads();
}
