// The encoder's forward transform: YCoCg-R colour (image.h:39-79) and the
// multi-level integer CDF 5/3 lifting (cdf53.h:9-34, encode.c:16-30) of N
// (N, H, W, C) frames.
//
// No TPU kernel to replace: the JAX package runs the transform as XLA
// (dwt_tpu/ops/lifting.py:dwt2d_fwd and dwt_tpu/ops/color.py:rgb_to_ycocg,
// traced into one program with dwt_tpu/codec/encoder.py:
// _transform_and_stats), which fuses each direction's predict, update and
// deinterleave into one pass.  The plain PyTorch version
// (ops/lifting.py:forward_transform_plain) runs the same formulas eagerly,
// about 230 launches at 4K, with strided whole-level passes.
//
// Semantics: every division truncates toward zero (C's /).  Along an axis
// of n samples x, deinterleaved [L | H]: the odd sample k gets d = x[k] -
// (x[k-1] + x[k+1]) / 2, its right neighbour clamped to x[k-1] at k + 1 ==
// n; the even sample k gets s = x[k] + (d[k-1] + d[k+1]) / 4, its left
// neighbour clamped to d[k+1] at k == 0, except the last sample of an
// odd n, which keeps its value.  Rows first, then columns; the LL quadrant
// recurses.
//
// Bound: bytes.  The function reads each frame once (1 byte a sample for
// uint8 frames) and writes the (N, H, W, C) int32 coefficients once; its
// integer work (about 14 operations a sample over all levels) takes less
// time than those bytes at the card's INT32 rate.  Between levels the LL
// quadrant goes through device memory (written by one launch, read by the
// next: a third of the coefficient bytes again over the large levels).
//
// What held the first version (one launch a level, 16x16-pair halo tiles
// in shared memory) back, measured on the H100: the full-size level ran at
// a quarter of the memory rate (five block barriers, four shared-memory
// sweeps indexed by / and % of 35, 17 and 96, byte-wise loads), and each
// of the five coarse levels, a few blocks on 132 SMs, was a launch of
// 5-8 us of latency.  This design:
//
// lift_level_kernel (the large levels, one launch each): a warp owns a
// strip of 32 column pairs (64 samples) and a band of `bp` row pairs of
// one frame, all channels; no shared-memory tile and no block barrier.
// Lane l holds the pair (2l, 2l + 1) of a row in registers: the row's
// predict reads the right neighbour by __shfl_down_sync, its update the
// left detail by __shfl_up_sync; lane 0 loads the strip's two samples
// before it and lane 31 the one after it.  Columns are lifted as the warp
// walks down its band, two rows a step, from a sliding window in
// registers (the even row, the last detail), after a prologue of the
// band's three rows of halo above.  Each step writes the four quadrants'
// row runs of 32 pairs; for C = 3 a warp-private shared buffer turns the
// lane's three channels into coalesced 128-byte stores.  The colour
// transform is applied in registers as the finest level's samples load.
//
// lift_tail_kernel (every level from the first whose input has at most
// TAIL_SAMPLES samples a channel, ops/lifting.py): one launch lifts them
// all.  A block holds one frame's channel of that level in shared memory
// and lifts each level in place on the lattice of the one before (level k
// samples at stride 2^k), writing each level's detail quadrants to the
// coefficients and the root band last: no LL buffer and no launch a level.
#include "common.cuh"

constexpr int WARPS = 4;  // warps a block of lift_level_kernel
// Column pairs a warp of lift_level_kernel stores: lanes 1..30; lanes 0
// and 31 hold the pairs on either side of the strip, its halo.
constexpr int PAIRS = 30;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int ycocg(int ch, int R, int G, int B) {
  const int U = R - B;
  const int T = B + U / 2;
  const int V = G - T;
  return ch == 0 ? T + V / 2 : (ch == 1 ? U : V);
}

// Where a sample lives: frame base, row and pixel strides in elements.
struct Plane {
  int64_t frame, row;
};

// One pixel's C samples at element offset o of the source (uint8 or
// int32).
template <int C>
__device__ __forceinline__ void load_px(const void* src, bool u8, int64_t o,
                                        int* v) {
  if (u8) {
    const unsigned char* s = (const unsigned char*)src + o;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = __ldg(s + ch);
  } else {
    const int* s = (const int*)src + o;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = __ldg(s + ch);
  }
}

// A lane's raw samples of one row: its pair, a at column c and b at c + 1
// (read at the nearest column in the row where one lies past an edge: such
// a lane's values are never stored).
template <int C>
struct Raw {
  int a[C], b[C];
};

template <int C>
__device__ __forceinline__ void load_row(const void* src, bool u8, Plane in,
                                         int64_t n, int r, int c, int w,
                                         Raw<C>& x) {
  const int64_t row = n * in.frame + (int64_t)r * in.row;
  load_px<C>(src, u8, row + (int64_t)min(max(c, 0), w - 1) * C, x.a);
  load_px<C>(src, u8, row + (int64_t)min(max(c + 1, 0), w - 1) * C, x.b);
}

template <int C>
__device__ __forceinline__ void to_ycocg(int* v) {
  const int R = v[0], G = v[1 % C], B = v[2 % C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = ycocg(ch, R, G, B);
}

// The row lifted along itself, after the colour transform when asked:
// the low-pass value of the lane's pair at column c (v[0..C)) and its
// detail (v[C..2C)), right for lanes 1..30.  Every lane of the warp calls
// it (the shuffles).
template <int C>
__device__ __forceinline__ void lift_row(Raw<C> x, bool colour, int c, int w,
                                         int* v) {
  if (C == 3 && colour) {
    to_ycocg<C>(x.a);
    to_ycocg<C>(x.b);
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const int a = x.a[ch];
    int an = __shfl_down_sync(FULL, a, 1);  // x[c + 2]
    if (c + 2 >= w) an = a;  // x[c + 1] is the last: clamped
    const int d = x.b[ch] - (a + an) / 2;
    int dl = __shfl_up_sync(FULL, d, 1);  // d[c - 1]
    if (c == 0) dl = d;  // clamped to d[1]
    v[ch] = ((w & 1) && c == w - 1) ? a : a + (dl + d) / 4;
    v[C + ch] = d;
  }
}

// A step's row runs of the four quadrants: the C values of lanes
// 1..lanes[q] of each run q at dst[q], through the warp's buffer so that
// the stores are coalesced for C > 1 (one __syncwarp pair for the four).
// Streaming stores (evict first) for the coefficients, plain ones for the
// LL run (q = 0), which the next launch reads.
template <int C>
__device__ __forceinline__ void put_runs(int (*buf)[PAIRS * C],
                                         int* const* dst, const int* v,
                                         const int* lanes, int nq,
                                         int lane) {
  if (C == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq && lane >= 1 && lane <= lanes[q]) {
        if (q) __stcs(dst[q] + lane - 1, v[q]); else dst[q][lane - 1] = v[q];
      }
    return;
  }
  if (lane >= 1 && lane <= PAIRS) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        if (q < nq) buf[q][(lane - 1) * C + ch] = v[q * C + ch];
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const int k = lane + 32 * r;
      if (q < nq && k < lanes[q] * C) {
        if (q) __stcs(dst[q] + k, buf[q][k]); else dst[q][k] = buf[q][k];
      }
    }
  __syncwarp();
}

template <int C>
__global__ void __launch_bounds__(32 * WARPS) lift_level_kernel(
    const void* __restrict__ src, int src_u8, int colour, Plane in,
    int* __restrict__ coeff, Plane co, int* __restrict__ ll, Plane lo,
    int64_t nwarps, int h, int w, int bp, int nstrips, int nbands) {
  __shared__ int stage[WARPS][4][PAIRS * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  if (gw >= nwarps) return;  // uniform over the warp
  const int strip = (int)(gw % nstrips);
  const int64_t t = gw / nstrips;
  const int band = (int)(t % nbands);
  const int64_t n = t / nbands;
  const int j0 = PAIRS * strip;          // the first pair stored
  const int c = 2 * (j0 - 1 + lane);     // the lane's even column
  const int heven = (h + 1) / 2, weven = (w + 1) / 2;
  const int nl = min(PAIRS, weven - j0);  // lanes with an even column
  const int nh = min(PAIRS, w / 2 - j0);  // lanes with an odd column
  const int i0 = band * bp, i1 = min(i0 + bp, heven);
  const bool u8 = src_u8 != 0, col = colour != 0;
  int(*buf)[PAIRS * C] = stage[warp];
  auto load = [&](int r, Raw<C>& x) {  // rows past the end: the last one
    load_row<C>(src, u8, in, n, min(r, h - 1), c, w, x);
  };

  // The band's rows are loaded a step ahead of their use: the loads of
  // step i + 1 are in flight while step i is lifted and stored.
  Raw<C> re, ro, rn;
  load(2 * i0, re);
  load(2 * i0 + 1, ro);
  load(2 * i0 + 2, rn);
  // e: the lifted even row 2i; dp: the detail row 2i - 1 (columns lifted).
  int e[2 * C], dp[2 * C];
  if (i0 > 0) {
    Raw<C> rp, rq;
    load(2 * i0 - 2, rp);
    load(2 * i0 - 1, rq);
    int p[2 * C], q[2 * C];
    lift_row<C>(rp, col, c, w, p);
    lift_row<C>(rq, col, c, w, q);
    lift_row<C>(re, col, c, w, e);
#pragma unroll
    for (int k = 0; k < 2 * C; ++k) dp[k] = q[k] - (p[k] + e[k]) / 2;
  } else {
    lift_row<C>(re, col, c, w, e);
  }
  for (int i = i0; i < i1; ++i) {
    Raw<C> po = ro, pn = rn;
    if (i + 1 < i1) {  // uniform over the warp
      load(2 * i + 3, po);
      load(2 * i + 4, pn);
    }
    int s[2 * C], d[2 * C];
    const bool odd = 2 * i + 1 < h;  // uniform over the warp
    if (odd) {
      int o[2 * C], nx[2 * C];
      lift_row<C>(ro, col, c, w, o);
      if (2 * i + 2 < h) {
        lift_row<C>(rn, col, c, w, nx);
      } else {
#pragma unroll
        for (int k = 0; k < 2 * C; ++k) nx[k] = e[k];
      }
#pragma unroll
      for (int k = 0; k < 2 * C; ++k) {
        d[k] = o[k] - (e[k] + nx[k]) / 2;
        s[k] = e[k] + ((i == 0 ? d[k] : dp[k]) + d[k]) / 4;
      }
#pragma unroll
      for (int k = 0; k < 2 * C; ++k) {
        dp[k] = d[k];
        e[k] = nx[k];
      }
    } else {  // the last row of an odd height: no update
#pragma unroll
      for (int k = 0; k < 2 * C; ++k) s[k] = e[k];
    }
    // The quadrants' runs: LL (to ll), HL, LH, HH (LH and HH from an odd
    // row only).
    const int64_t lrow = n * co.frame + (int64_t)i * co.row;
    const int64_t hrow = n * co.frame + (int64_t)(heven + i) * co.row;
    int* const dst[4] = {
        ll + n * lo.frame + (int64_t)i * lo.row + (int64_t)j0 * C,
        coeff + lrow + (int64_t)(weven + j0) * C,
        coeff + hrow + (int64_t)j0 * C,
        coeff + hrow + (int64_t)(weven + j0) * C};
    const int lanes[4] = {nl, nh, nl, nh};
    int v[4 * C];
#pragma unroll
    for (int k = 0; k < 2 * C; ++k) {
      v[k] = s[k];
      v[2 * C + k] = d[k];
    }
    put_runs<C>(buf, dst, v, lanes, odd ? 4 : 2, lane);
    ro = po;
    rn = pn;
  }
}

__device__ __forceinline__ int tail_load(const void* src, bool u8,
                                         bool colour, int64_t o, int ch) {
  if (u8) {
    const unsigned char* s = (const unsigned char*)src + o;
    return colour ? ycocg(ch, s[0], s[1], s[2]) : s[ch];
  }
  const int* s = (const int*)src + o;
  return colour ? ycocg(ch, s[0], s[1], s[2]) : s[ch];
}

__global__ void __launch_bounds__(1024) lift_tail_kernel(
    const void* __restrict__ src, int src_u8, int colour, Plane in, int C,
    int* __restrict__ coeff, Plane co, int ht, int wt, int nlev) {
  extern __shared__ int t[];  // ht x wt samples of one frame's channel
  const int64_t n = blockIdx.x / C;
  const int ch = (int)(blockIdx.x % C);
  const int tx = threadIdx.x, ty = threadIdx.y, Y = blockDim.y;
  const bool u8 = src_u8 != 0, col = colour != 0;
  // The input, LOADS independent loads a thread in flight at a time.
  constexpr int LOADS = 8;
  const int T = 32 * Y, total = ht * wt;
  for (int p0 = ty * 32 + tx; p0 < total; p0 += LOADS * T) {
    int v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int p = p0 + k * T, r = p / wt;
      v[k] = p < total ? tail_load(src, u8, col,
                                   n * in.frame + (int64_t)r * in.row
                                       + (int64_t)(p - r * wt) * C, ch)
                       : 0;
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (p0 + k * T < total) t[p0 + k * T] = v[k];
  }
  __syncthreads();
  int h = ht, w = wt, st = 1;  // this level's size and lattice stride
  for (int l = 0; l < nlev; ++l) {
    const int rs = st * wt;  // a row of this level, in t
    for (int i = ty; i < h; i += Y)
      for (int k = tx; 2 * k + 1 < w; k += 32) {  // rows: predict
        int* x = t + i * rs;
        const int j = 2 * k + 1, right = j + 1 < w ? j + 1 : j - 1;
        x[j * st] -= (x[(j - 1) * st] + x[right * st]) / 2;
      }
    __syncthreads();
    for (int i = ty; i < h; i += Y)
      for (int k = tx; 2 * k < w; k += 32) {  // rows: update
        int* x = t + i * rs;
        const int j = 2 * k, left = j >= 1 ? j - 1 : j + 1;
        if (!((w & 1) && j == w - 1))
          x[j * st] += (x[left * st] + x[(j + 1) * st]) / 4;
      }
    __syncthreads();
    for (int k = ty; 2 * k + 1 < h; k += Y)
      for (int j = tx; j < w; j += 32) {  // columns: predict
        const int i = 2 * k + 1, below = i + 1 < h ? i + 1 : i - 1;
        t[i * rs + j * st] -= (t[(i - 1) * rs + j * st]
                               + t[below * rs + j * st]) / 2;
      }
    __syncthreads();
    for (int k = ty; 2 * k < h; k += Y)
      for (int j = tx; j < w; j += 32) {  // columns: update
        const int i = 2 * k, above = i >= 1 ? i - 1 : i + 1;
        if (!((h & 1) && i == h - 1))
          t[i * rs + j * st] += (t[above * rs + j * st]
                                 + t[(i + 1) * rs + j * st]) / 4;
      }
    __syncthreads();
    // The detail quadrants, deinterleaved, in output order; the LL
    // quadrant (even, even) stays for the next level, whose passes touch
    // nothing else, so no barrier is needed before them.
    const int he = (h + 1) / 2, we = (w + 1) / 2;
    for (int a = ty; a < h; a += Y) {
      const int i = a < he ? 2 * a : 2 * (a - he) + 1;
      for (int b = tx; b < w; b += 32) {
        const int j = b < we ? 2 * b : 2 * (b - we) + 1;
        if ((i | j) & 1)
          __stcs(coeff + n * co.frame + (int64_t)a * co.row
                     + (int64_t)b * C + ch, t[i * rs + j * st]);
      }
    }
    h = he;
    w = we;
    st *= 2;
  }
  const int rs = st * wt;
  for (int i = ty; i < h; i += Y)
    for (int j = tx; j < w; j += 32)
      coeff[n * co.frame + (int64_t)i * co.row + (int64_t)j * C + ch] =
          t[i * rs + j * st];
}

// One large level: src (the frames, uint8 or int32, or the previous
// level's LL buffer, int32) of n frames of h x w samples and C channels at
// the given frame and row strides (elements) -> the level's detail
// quadrants into coeff and its LL quadrant into ll, each at its own
// strides; `bp` row pairs a warp.
extern "C" int dwt_lift_level(const void* src, int src_u8, int colour,
                              int64_t src_frame, int64_t src_row, void* coeff,
                              int64_t co_frame, int64_t co_row, void* ll,
                              int64_t ll_frame, int64_t ll_row, int n, int h,
                              int w, int C, int bp, void* stream) {
  if (n < 0 || h < 2 || w < 2 || bp < 1 || (C != 1 && C != 3))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int nstrips = ((w + 1) / 2 + PAIRS - 1) / PAIRS;
  const int nbands = ((h + 1) / 2 + bp - 1) / bp;
  const int64_t nwarps = (int64_t)n * nstrips * nbands;
  const int64_t blocks = (nwarps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const Plane in{src_frame, src_row}, co{co_frame, co_row},
      lo{ll_frame, ll_row};
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1)
    lift_level_kernel<1><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        src, src_u8, colour, in, (int*)coeff, co, (int*)ll, lo, nwarps, h, w,
        bp, nstrips, nbands);
  else
    lift_level_kernel<3><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        src, src_u8, colour, in, (int*)coeff, co, (int*)ll, lo, nwarps, h, w,
        bp, nstrips, nbands);
  return (int)cudaGetLastError();
}

// The coarse tail: `nlev` levels from an h x w input (src as above) of n
// frames, every detail quadrant and the root band into coeff.
extern "C" int dwt_lift_tail(const void* src, int src_u8, int colour,
                             int64_t src_frame, int64_t src_row, void* coeff,
                             int64_t co_frame, int64_t co_row, int n, int h,
                             int w, int C, int nlev, void* stream) {
  const int64_t smem = (int64_t)h * w * 4;
  if (n < 0 || h < 2 || w < 2 || nlev < 1 || (C != 1 && C != 3)
      || (colour && C != 3) || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)n * C > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (n == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lift_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int Y = h * w > 4096 ? 32 : (h * w > 1024 ? 8 : 2);
  const Plane in{src_frame, src_row}, co{co_frame, co_row};
  lift_tail_kernel<<<(unsigned)(n * C), dim3(32, Y), (size_t)smem,
                     (cudaStream_t)stream>>>(src, src_u8, colour, in, C,
                                             (int*)coeff, co, h, w, nlev);
  return (int)cudaGetLastError();
}
