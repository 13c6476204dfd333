// Decoder's inverse linearization: (C, L) int32 scan-order coefficients
// -> (H, W, C) int32 image plane, out[y, x, c] = lin[c, src[y*W + x]],
// and 0 where src is outside [0, L) (-1 marks the root band, whose raster
// crop the caller writes).
//
// Replaces dwt_tpu/ops/pallas_hilbert.py:hilbert_scatter_pallas (kernel
// _scatter_kernel), which places 32x32 tiles with constant one-hot MXU
// matmuls, 128-lane read windows and "partial" tiles merged through an
// ownership mask, because a TPU gather costs ~8 ns an index.  On Hopper
// the static permutation arrives as a precomputed int32 source index per
// output pixel and a run table of each aligned 32x32 output square.
//
// Bound: bytes (src once, lin once over the valid pixels, out once, and
// the run table).  A thread per pixel reading lin[c*L + src[i]] touches a
// 32-byte sector per useful int along the Hilbert curve and writes C
// strided ints, so it is bound by sector requests, not bytes.  Here one
// block takes one (square, channel group):
//   stage  - the square's valid scan positions form a few contiguous runs
//            (every level's Hilbert grid starts at the image origin, so a
//            square covers one stretch of each level's curve); the block
//            copies each run of each channel of its group from lin into
//            shared memory with coalesced asynchronous copies (cp.async),
//            each element once, all in flight together;
//   look up - meanwhile each pixel finds its slot among the square's runs
//            (a binary search over at most a few starts) from its src
//            value, read coalesced, 128 bytes a square row;
//   write  - each warp writes whole output rows of the square: 32 pixels
//            x the group's channels, consecutive lanes on consecutive
//            ints (one contiguous stretch when the group holds all C).
// Ragged bottom and right squares are masked in place (no zero-fill pass,
// no crop).  The run table is trusted for values, not for memory: runs are
// clipped to [0, L) and to the square's 1,024 slots, so a table that is
// not src's gives wrong values but never an access out of bounds.
#include <cuda_pipeline_primitives.h>

#include "common.cuh"

namespace {

constexpr int SQ = 32;               // output square side
constexpr int NPIX = SQ * SQ;        // pixels of a square, and its slots
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PPT = NPIX / THREADS;  // pixels a thread looks up
constexpr int RCH = 32;              // runs a round (one warp's scan)
constexpr int STRIDE = NPIX + 1;     // a channel's slots (odd: banks)

}  // namespace

__global__ void __launch_bounds__(THREADS, 6) hilbert_scatter_kernel(
    const int* __restrict__ lin, const int* __restrict__ src,
    const int* __restrict__ sq_ptr, const int* __restrict__ runs,
    int* __restrict__ out, int H, int W, int64_t L, int C, int64_t nruns,
    int ngroups, int G, int sqx) {
  extern __shared__ int buf[];  // [G][STRIDE] staged values
  __shared__ short slot_of[NPIX];
  __shared__ int r_start[RCH], r_off[RCH], r_cnt[RCH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x % ngroups, sq = blockIdx.x / ngroups;
  const int y0 = (sq / sqx) * SQ, x0 = (sq % sqx) * SQ;
  const int c0 = g * G, gc = min(G, C - c0);

  // This thread's pixels: column `lane` of rows warp + NWARPS * k.
  int s[PPT], slot[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int y = y0 + warp + NWARPS * k, x = x0 + lane;
    const int v = (y < H && x < W) ? __ldg(src + (int64_t)y * W + x) : -1;
    s[k] = (v >= 0 && v < L) ? v : -1;
    slot[k] = -1;
  }

  int64_t rb = __ldg(sq_ptr + sq), re = __ldg(sq_ptr + sq + 1);
  rb = min(max(rb, (int64_t)0), nruns);
  re = min(max(re, rb), nruns);
  int base = 0;  // slots taken by earlier rounds
  for (int64_t r0 = rb; r0 < re; r0 += RCH) {
    const int n = (int)min((int64_t)RCH, re - r0);
    if (warp == 0) {
      int st = 0, ct = 0;
      if (lane < n) {
        const int64_t a = __ldg(runs + 2 * (r0 + lane));
        const int64_t b = a + max(__ldg(runs + 2 * (r0 + lane) + 1), 0);
        const int64_t lo = max(a, (int64_t)0), hi = min(b, L);
        st = (int)lo;
        ct = hi > lo ? (int)min(hi - lo, (int64_t)NPIX) : 0;
      }
      int incl = ct;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const int off = min(base + incl - ct, NPIX);
      if (lane < n) {
        r_start[lane] = st;
        r_off[lane] = off;
        r_cnt[lane] = min(ct, NPIX - off);
      }
    }
    __syncthreads();
    // Stage the round's runs of the group's channels: asynchronous
    // copies from lin into shared memory, 128 contiguous bytes a warp
    // instruction, all in flight at once and held in no register.
    for (int r = 0; r < n; ++r) {
      const int st = r_start[r], ct = r_cnt[r];
      int* dst = buf + r_off[r];
      for (int c = 0; c < gc; ++c, dst += STRIDE) {
        const int* p = lin + (int64_t)(c0 + c) * L + st;
        for (int i = tid; i < ct; i += THREADS)
          __pipeline_memcpy_async(dst + i, p + i, sizeof(int));
      }
    }
    __pipeline_commit();
    // Look up, while the copies fly: the last run of the round that
    // starts at or before s.
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (slot[k] >= 0 || s[k] < 0) continue;
      int lo = 0, hi = n;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (r_start[mid] <= s[k]) lo = mid; else hi = mid;
      }
      const int d = s[k] - r_start[lo];
      if (d >= 0 && d < r_cnt[lo]) slot[k] = r_off[lo] + d;
    }
    base = r_off[n - 1] + r_cnt[n - 1];
    __syncthreads();  // the next round overwrites the run arrays
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    slot_of[(warp + NWARPS * k) * SQ + lane] = (short)slot[k];
  __pipeline_wait_prior(0);
  __syncthreads();

  // Write: warp w writes rows w, w + NWARPS, ...; lane j of a row's
  // npx * gc ints holds pixel j / gc, channel j % gc, advanced by 32.
  const int npx = min(SQ, W - x0), len = npx * gc;
  const int q = 32 / gc, rm = 32 % gc;
  const int px0 = lane / gc, cc0 = lane - px0 * gc;
  for (int row = warp; row < SQ && y0 + row < H; row += NWARPS) {
    int* o = out + ((int64_t)(y0 + row) * W + x0) * C + c0;
    const short* sl = slot_of + row * SQ;
    int px = px0, c = cc0;
    for (int j = lane; j < len; j += 32) {
      const int t = sl[px];
      o[(int64_t)px * C + c] = t >= 0 ? buf[c * STRIDE + t] : 0;
      px += q;
      c += rm;
      if (c >= gc) c -= gc, ++px;
    }
  }
}

// sq_ptr: (ceil(H/32) * ceil(W/32) + 1,) int32, runs: (nruns, 2) int32
// (start, count): the run table of src (ops/hilbert_scatter.py:square_runs).
// group: channels a block stages at most; the C channels are cut into
// ceil(C / group) groups of near-equal size.
extern "C" int dwt_hilbert_scatter(const void* lin, const void* src,
                                   const void* sq_ptr, const void* runs,
                                   void* out, int H, int W, int64_t L, int C,
                                   int64_t nruns, int group, void* stream) {
  if (H < 0 || W < 0 || C < 1 || group < 1 || L < 0 || nruns < 0)
    return (int)cudaErrorInvalidValue;
  const int sqy = (H + SQ - 1) / SQ, sqx = (W + SQ - 1) / SQ;
  const int ngroups = (C + group - 1) / group;
  const int G = (C + ngroups - 1) / ngroups;
  const int64_t blocks = (int64_t)sqy * sqx * ngroups;
  if (blocks == 0) return 0;
  const size_t smem = (size_t)G * STRIDE * sizeof(int);
  if (blocks > 0x7fffffff || smem > 200 * 1024)
    return (int)cudaErrorInvalidConfiguration;
  if (smem > 40 * 1024) {  // with the static arrays, past the default 48 KB
    static int granted[64];  // bytes already allowed, by device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev >= 64 || granted[dev] < (int)smem)) {
      e = cudaFuncSetAttribute(hilbert_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e == cudaSuccess && dev < 64) granted[dev] = (int)smem;
    }
    if (e != cudaSuccess) return (int)e;
  }
  hilbert_scatter_kernel<<<(unsigned)blocks, THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const int*)lin, (const int*)src, (const int*)sq_ptr, (const int*)runs,
      (int*)out, H, W, L, C, nruns, ngroups, G, sqx);
  return (int)cudaGetLastError();
}
