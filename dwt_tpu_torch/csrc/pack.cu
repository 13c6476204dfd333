// Codeword packing: adds each token's <= 3 disjoint uint32 codeword pieces
// c0, c1, c2 into stream words widx, widx + 1, widx + 2.
//
// Replaces dwt_tpu/ops/pallas_pack.py:pack_words_pallas (_kernel), which
// compacts blocks of tokens into 128-aligned word windows with one-hot MXU
// matmuls and leaves "wild" blocks (spans past its window budget) to a
// straggler pass.  Here each token adds its pieces with atomics (mod 2^32,
// in any order); no block has a window, so none is wild.  The bits of
// different tokens are disjoint, so the sum is the OR of the pieces.
//
// Bound: bytes (16 B read a token, each word written once).  widx is
// nondecreasing, so one warp's 32 tokens land on a few neighbouring words:
// the warp first sums the pieces aimed at the same word (a segmented
// reduction over lanes with shuffles) and only the first lane of each run
// of equal words does the atomic, which cuts the atomics to about one
// per word and warp.
#include "common.cuh"

namespace {

// Sum (mod 2^32) of `v` over this lane and the later lanes of its run of
// equal `key` (runs are contiguous because keys are nondecreasing along
// the lanes), so the first lane of a run holds the run's sum.
__device__ __forceinline__ unsigned int run_sum(int64_t key, unsigned int v,
                                               int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned int ov = __shfl_down_sync(0xffffffffu, v, d);
    const int64_t ok = __shfl_down_sync(0xffffffffu, key, d);
    if (lane + d < 32 && ok == key) v += ov;
  }
  return v;
}

__global__ void pack_words_kernel(const int* __restrict__ widx,
                                  const unsigned int* __restrict__ c0,
                                  const unsigned int* __restrict__ c1,
                                  const unsigned int* __restrict__ c2,
                                  unsigned int* __restrict__ words,
                                  int64_t ntok, int64_t nwords) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // Whole warps iterate together (the shuffles need all 32 lanes).
  const int64_t nround = (ntok + 31) / 32 * 32;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < nround; i += stride) {
    const bool live = i < ntok;
    const int64_t w = live ? (int64_t)__ldg(widx + i) : -1;
    const unsigned int a = live ? __ldg(c0 + i) : 0u;
    const unsigned int b = live ? __ldg(c1 + i) : 0u;
    const unsigned int c = live ? __ldg(c2 + i) : 0u;
    const int64_t prev = __shfl_up_sync(0xffffffffu, w, 1);
    const bool head = lane == 0 || prev != w;
    // Piece k of a token goes to word w + k: sum each piece over the run
    // of equal w.
    const unsigned int ra = run_sum(w, a, lane);
    const unsigned int rb = run_sum(w, b, lane);
    const unsigned int rc = run_sum(w, c, lane);
    if (live && head && w >= 0) {
      if (ra && w < nwords) atomicAdd(words + w, ra);
      if (rb && w + 1 < nwords) atomicAdd(words + w + 1, rb);
      if (rc && w + 2 < nwords) atomicAdd(words + w + 2, rc);
    }
  }
}

}  // namespace

extern "C" int dwt_pack_words(const void* widx, const void* c0,
                              const void* c1, const void* c2, void* words,
                              int64_t ntok, int64_t nwords, void* stream) {
  const int threads = 256;
  if (ntok > 0)
    pack_words_kernel<<<grid_for(ntok, threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const int*)widx, (const unsigned int*)c0, (const unsigned int*)c1,
        (const unsigned int*)c2, (unsigned int*)words, ntok, nwords);
  return (int)cudaGetLastError();
}
