// Shared device helpers of the port's kernels (plain C interface, no
// PyTorch headers: each source builds in seconds).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Exclusive prefix sum over the block of one int per thread.  Returns
// this thread's exclusive prefix and sets *total to the block's sum.
// blockDim.x must be a multiple of 32; warp_sums holds >= 32 ints of
// shared memory.  Every thread of the block must call it.
__device__ __forceinline__ int block_excl_scan(int v, int* warp_sums,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return base + x - v;
}

static inline int grid_for(int64_t n, int threads) {
  int64_t b = (n + threads - 1) / threads;
  if (b > (1 << 20)) b = 1 << 20;  // grid-stride loops cover the rest
  return b < 1 ? 1 : (int)b;
}
