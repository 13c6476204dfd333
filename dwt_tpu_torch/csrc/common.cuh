// Shared device helpers of the port's kernels (plain C interface, no
// PyTorch headers: each source builds in seconds).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

static inline int grid_for(int64_t n, int threads) {
  int64_t b = (n + threads - 1) / threads;
  if (b > (1 << 20)) b = 1 << 20;  // grid-stride loops cover the rest
  return b < 1 ? 1 : (int)b;
}
