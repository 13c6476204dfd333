// Stage-1 linearization: N frames of (H, W, C) int32 coefficients ->
// (N, C, nlin) int32 in the padded scan order of
// hilbert.padded_layout(pyr, ALIGN), in one launch.
//
// Replaces dwt_tpu/ops/pallas_hilbert.py:hilbert_gather_pallas (kernel
// _gather_kernel), which permutes 32x32 tiles with constant one-hot MXU
// matmuls because a TPU gather costs ~8 ns an index.  On Hopper a gather
// through L2 is cheap, so the static permutation arrives as a precomputed
// int32 source index per output slot (-1 for pads and the root band,
// which write 0; the caller writes the root raster crop).
//
// Bound: bytes.  Each output slot reads its index (4 B) once for all the
// frames, and C source values a frame, and writes C values a frame; the C
// reads of one pixel share a sector.  One thread per slot, consecutive
// threads on consecutive slots, so the index reads and the output rows
// are coalesced; the source reads follow the Hilbert curve, which keeps
// them within a few 32x32 squares per warp and so in L2.  The frames are
// an inner loop of the thread, not a grid axis, so the index (shared by
// all frames) is read once.
#include "common.cuh"

__global__ void hilbert_gather_kernel(const int* __restrict__ co,
                                      const int* __restrict__ src,
                                      int* __restrict__ out, int64_t nlin,
                                      int C, int nframes,
                                      int64_t frame_elems) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nlin;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int s = __ldg(src + i);
    for (int f = 0; f < nframes; ++f) {
      const int* cf = co + f * frame_elems;
      int* of = out + (int64_t)f * C * nlin;
      for (int c = 0; c < C; ++c)
        of[c * nlin + i] = s >= 0 ? __ldg(cf + (int64_t)s * C + c) : 0;
    }
  }
}

// co: nframes frames of frame_elems int32 each (H * W * C); out:
// (nframes, C, nlin).
extern "C" int dwt_hilbert_gather(const void* co, const void* src, void* out,
                                  int64_t nlin, int C, int nframes,
                                  int64_t frame_elems, void* stream) {
  const int threads = 256;
  if (nlin > 0 && nframes > 0)
    hilbert_gather_kernel<<<grid_for(nlin, threads), threads, 0,
                            (cudaStream_t)stream>>>(
        (const int*)co, (const int*)src, (int*)out, nlin, C, nframes,
        frame_elems);
  return (int)cudaGetLastError();
}
