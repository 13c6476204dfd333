// The decoder's inverse transform (kernel 16): the multi-level integer
// CDF 5/3 inverse lifting (cdf53.h:36-61, decode.c:16-30) of N (N, H, W, C)
// int32 coefficient pyramids and, as the finest level stores, the inverse
// YCoCg-R colour with the reference's decode-side clamps (image.h:41-43),
// the clamp to [0, 255] and the uint8 cast.
//
// No TPU kernel to replace: the JAX package runs this as XLA
// (dwt_tpu/ops/lifting.py:dwt2d_inv with dwt_tpu/ops/color.py:ycocg_to_rgb
// and the clip and cast of dwt_tpu/codec/decoder.py:_tail_fn, traced into
// one program), which fuses each direction's undo-update, undo-predict and
// interleave into one pass.  The plain PyTorch version
// (ops/lifting.py:inverse_transform_plain) runs the same formulas eagerly:
// about a dozen launches a direction and level, some 200 at 4K, and the
// colour, clamps and cast 17 more.
//
// Semantics along an axis of n samples, deinterleaved [s | d] (ne = (n +
// 1) / 2 low samples, n / 2 high ones): ev[i] = s[i] - (d[i-1] + d[i]) / 4,
// d[-1] clamped to d[0], except the last even sample of an odd n, which
// keeps s; then od[i] = d[i] + (ev[i] + ev[i+1]) / 2, ev[ne] clamped to
// ev[ne-1]; x[2i] = ev[i], x[2i+1] = od[i].  Every division truncates
// toward zero (C's /).  Columns first, then rows; coarsest level first,
// each level's LL quadrant the output of the level before.
//
// Bound: bytes.  The function reads the (N, H, W, C) int32 coefficients
// once and writes the (N, H, W, C) image once (1 byte a sample as uint8);
// its integer work (about 14 operations a sample over all levels) takes
// less time than those bytes at the card's INT32 rate.  Between launches
// an LL buffer goes through device memory: each large level but the
// finest writes its output, and the next launch reads it again.
//
// The mirror of the forward transform's design (csrc/lifting.cu):
//
// inverse_level_kernel (one launch a level whose output holds more than
// TAIL_SAMPLES samples a channel, coarsest first): a warp owns a strip of
// 30 output column pairs and a band of `bp` output row pairs of one frame,
// all channels; no shared-memory tile and no block barrier.  Lane l holds
// the pair (2j, 2j + 1), j = j0 - 1 + l, of each row: the low column j
// and the high column we + j of the level's deinterleaved input.  Columns
// are undone first, as the warp walks down its band, from a sliding
// window in registers (the current pair's even row and detail, the next
// pair's raw rows, loaded a step ahead) after a prologue that reads the
// detail row above the band; an output row pair needs the even row of the
// pair below it, so the window looks one pair ahead.  Rows are undone
// next: the undo-update reads the left lane's detail by __shfl_up_sync,
// the undo-predict then the right lane's even sample by __shfl_down_sync;
// lane 0 and lane 31 hold the strip's halo pairs and are not stored.  The
// LL quadrant comes from the buffer the launch before wrote (from the
// coefficients' root band where no launch came before), the detail
// quadrants straight from the coefficients.  Each step's two output rows
// go through a warp-private shared buffer into coalesced stores: int32
// runs for an LL buffer, and at the finest level, after the colour, the
// clamps and the cast in registers, whole 4-byte words of the uint8 image.
//
// inverse_tail_kernel (every level whose output holds at most TAIL_SAMPLES
// samples a channel, ops/lifting.py): one launch lifts them all.  A block
// holds one frame's channel of the top tail level's output in shared
// memory (64 KB at most), or, where the tail reaches the finest level
// (small images and tiles) and stores the image, all C channels of the
// frame (3 x 64 KB at most, within the 227 KB a block may take), since
// the colour needs a pixel's three.  It loads the root band and every
// tail level's detail quadrants straight to their places on the lattices
// (level k of t at stride 2^(t-k): the places of the levels' details and
// of the root are disjoint and cover the grid), undoes each level in
// place, coarsest first, and writes the top level's output into an LL
// buffer, or into the image with the colour, clamps and cast, so that no
// eager pass follows.
#include "common.cuh"

constexpr int MAXL = 17;  // levels a chain holds (runtime/build.py CHAIN_LEVELS)

// The levels one tail launch lifts: level k's output h[k-1] x w[k-1],
// coarsest first (runtime/build.py Chain).  Outside the unnamed namespace:
// the exported entry point takes it by value.
struct UnliftChain {
  int n;
  int h[MAXL], w[MAXL];
};

namespace {

constexpr int WARPS = 4;  // warps a block of inverse_level_kernel
// Column pairs a warp of inverse_level_kernel stores: lanes 1..30; lanes 0
// and 31 hold the pairs on either side of the strip, its halo.
constexpr int PAIRS = 30;
constexpr unsigned FULL = 0xffffffffu;

// Where samples live: frame base and row strides in elements.
struct Plane {
  int64_t frame, row;
};

// Channel ch of the RGB pixel of (Y, Co, Cg), after the decode-side
// clamps.
__device__ __forceinline__ int rgb_of(int ch, int Y, int U, int V) {
  Y = min(max(Y, 0), 255);
  U = min(max(U, -255), 255);
  V = min(max(V, -255), 255);
  const int T = Y - V / 2;
  const int G = V + T;
  const int B = T - U / 2;
  return ch == 0 ? B + U : (ch == 1 ? G : B);
}

__device__ __forceinline__ int to_byte(int v) { return min(max(v, 0), 255); }

// Bytes at(0..n) into dst by threads t of nt: the run's unaligned head and
// tail byte by byte, the rest as whole 4-byte words (little-endian).
template <class F>
__device__ __forceinline__ void put_bytes(unsigned char* dst, int n, int t,
                                          int nt, F at) {
  const int head = min(n, (int)((4u - ((unsigned)(uintptr_t)dst & 3u)) & 3u));
  const int words = (n - head) >> 2;
  for (int i = t; i < head; i += nt) dst[i] = (unsigned char)at(i);
  for (int i = head + 4 * words + t; i < n; i += nt)
    dst[i] = (unsigned char)at(i);
  unsigned* wd = (unsigned*)(dst + head);
  for (int q = t; q < words; q += nt) {
    const int i = head + 4 * q;
    wd[q] = (unsigned)at(i) | (unsigned)at(i + 1) << 8
            | (unsigned)at(i + 2) << 16 | (unsigned)at(i + 3) << 24;
  }
}

// One row undone along itself: the lane's low sample s[C] (column j of the
// deinterleaved row) and high sample d[C] (column we + j) -> its output
// pair a[C] (column 2j) and b[C] (column 2j + 1), right for lanes 1..30.
// Every lane of the warp calls it (the shuffles).
template <int C>
__device__ __forceinline__ void unlift_row(const int* s, const int* d, int j,
                                           int w, int* a, int* b) {
  const int we = (w + 1) / 2, nupd = (w & 1) ? we - 1 : we;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    int dl = __shfl_up_sync(FULL, d[ch], 1);  // d[j - 1]
    if (j == 0) dl = d[ch];                   // clamped to d[0]
    const int ev = j < nupd ? s[ch] - (dl + d[ch]) / 4 : s[ch];
    int en = __shfl_down_sync(FULL, ev, 1);  // ev[j + 1]
    if (j + 1 >= we) en = ev;                // clamped to ev[we - 1]
    a[ch] = ev;
    b[ch] = d[ch] + (ev + en) / 2;
  }
}

template <int C>
__global__ void __launch_bounds__(32 * WARPS) inverse_level_kernel(
    const int* __restrict__ coeff, Plane co, const int* __restrict__ ll,
    Plane lo, void* __restrict__ dst, Plane ds, int colour, int u8,
    int64_t nwarps, int h, int w, int bp, int nstrips, int nbands) {
  __shared__ int stage[WARPS][2][2 * PAIRS * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  if (gw >= nwarps) return;  // uniform over the warp
  const int strip = (int)(gw % nstrips);
  const int64_t t = gw / nstrips;
  const int band = (int)(t % nbands);
  const int64_t n = t / nbands;
  const int he = (h + 1) / 2, we = (w + 1) / 2, nh = h / 2, nw = w / 2;
  const int nupd = (h & 1) ? he - 1 : he;
  const int j0 = PAIRS * strip;  // the first pair stored
  const int j = j0 - 1 + lane;   // the lane's pair
  // The lane's columns, read at the nearest column in range past an edge
  // (such a lane's values are never stored).
  const int cl = min(max(j, 0), we - 1), chi = we + min(max(j, 0), nw - 1);
  const int i0 = band * bp, i1 = min(i0 + bp, he);
  int(*buf)[2 * PAIRS * C] = stage[warp];

  // Row i of the top half (LL, HL) and of the bottom half (LH, HH), each
  // clamped into its half: the lane's low column's C values, then its
  // high column's.
  auto load_s = [&](int i, int* v) {
    const int r = min(i, he - 1);
    const int* a = ll + n * lo.frame + (int64_t)r * lo.row + (int64_t)cl * C;
    const int* b = coeff + n * co.frame + (int64_t)r * co.row
                   + (int64_t)chi * C;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = __ldg(a + k);
      v[C + k] = __ldg(b + k);
    }
  };
  auto load_d = [&](int i, int* v) {
    const int* a = coeff + n * co.frame
                   + (int64_t)(he + min(i, nh - 1)) * co.row;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = __ldg(a + (int64_t)cl * C + k);
      v[C + k] = __ldg(a + (int64_t)chi * C + k);
    }
  };

  // E: the even row 2i undone along the columns; D: the detail of pair i;
  // sN, dN: pair i + 1's raw rows.
  int E[2 * C], D[2 * C], sN[2 * C], dN[2 * C];
  {
    int s[2 * C], dp[2 * C];
    load_s(i0, s);
    load_d(i0, D);
    if (i0 > 0) {
      load_d(i0 - 1, dp);
    } else {
#pragma unroll
      for (int k = 0; k < 2 * C; ++k) dp[k] = D[k];
    }
#pragma unroll
    for (int k = 0; k < 2 * C; ++k)
      E[k] = i0 < nupd ? s[k] - (dp[k] + D[k]) / 4 : s[k];
  }
  if (i0 + 1 < he) {
    load_s(i0 + 1, sN);
    load_d(i0 + 1, dN);
  }
  const bool col = C == 3 && colour != 0, b8 = u8 != 0;
  const int npx = min(2 * PAIRS, w - 2 * j0);  // pixels a row of the strip
  for (int i = i0; i < i1; ++i) {
    // Pair i + 2's rows load while pair i is undone and stored.
    int s2[2 * C], d2[2 * C];
    if (i + 1 < i1 && i + 2 < he) {  // uniform over the warp
      load_s(i + 2, s2);
      load_d(i + 2, d2);
    }
    int EN[2 * C];
#pragma unroll
    for (int k = 0; k < 2 * C; ++k)
      EN[k] = i + 1 >= he ? E[k]  // clamped: ev[he] = ev[he - 1]
                          : (i + 1 < nupd ? sN[k] - (D[k] + dN[k]) / 4
                                          : sN[k]);
    const bool odd = i < nh;  // uniform over the warp
    int o[2 * C];
#pragma unroll
    for (int k = 0; k < 2 * C; ++k) o[k] = D[k] + (E[k] + EN[k]) / 2;
    // The rows: output row 2i from E, 2i + 1 from o; into the buffer, the
    // finest level's after the colour and clamps.
    int px[2][2][C];
    unlift_row<C>(E, E + C, j, w, px[0][0], px[0][1]);
    if (odd) unlift_row<C>(o, o + C, j, w, px[1][0], px[1][1]);
    const int nrows = odd ? 2 : 1;
    if (lane >= 1 && lane <= PAIRS) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (r >= nrows) continue;
          int* v = px[r][p];
          if (col) {
            const int Y = v[0], U = v[1 % C], V = v[2 % C];
#pragma unroll
            for (int ch = 0; ch < C; ++ch) v[ch] = rgb_of(ch, Y, U, V);
          }
#pragma unroll
          for (int ch = 0; ch < C; ++ch)
            buf[r][(2 * (lane - 1) + p) * C + ch] = b8 ? to_byte(v[ch])
                                                       : v[ch];
        }
    }
    __syncwarp();
    for (int r = 0; r < nrows; ++r) {
      const int64_t at = n * ds.frame + (int64_t)(2 * i + r) * ds.row
                         + (int64_t)2 * j0 * C;
      const int* v = buf[r];
      if (b8) {
        put_bytes((unsigned char*)dst + at, npx * C, lane, 32,
                  [&](int e) { return v[e]; });
      } else {
        int* d = (int*)dst + at;
        for (int e = lane; e < npx * C; e += 32) d[e] = v[e];
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2 * C; ++k) {
      E[k] = EN[k];
      D[k] = dN[k];
      sN[k] = s2[k];
      dN[k] = d2[k];
    }
  }
}

// Index a of the top tail level's deinterleaved axis, whose levels'
// output sizes are n[0..L): its level (0 for the root band, a < ceil(n[0]
// / 2), else the first level k whose output holds it, a < n[k - 1]) << 16
// | its own place on the top level's axis, 2(a - ceil(n[k - 1] / 2)) + 1
// at level k's stride 2^(L - k) (the root band's a at stride 2^L).  Sides
// of the tail are below 2^16 / 2 (at most TAIL_SAMPLES samples, 2 at
// least a side).
__device__ __forceinline__ int axis_entry(int a, const int* n, int L) {
  int k = 0;
  if (a >= (n[0] + 1) / 2) {
    k = 1;
    while (k < L && a >= n[k - 1]) ++k;
  }
  const int own = k == 0 ? a << L
                         : (2 * (a - (n[k - 1] + 1) / 2) + 1) << (L - k);
  return k << 16 | own;
}

// The place of index a (axis entry e) as an input of level k, k at least
// its own level: its own place at its own level, else the low half's 2a
// at level k's stride (a lies below level k - 1's output size).
__device__ __forceinline__ int place(int a, int e, int k, int L) {
  return (e >> 16) == k ? (e & 0xffff) : a << (L - k + 1);
}

// A block: CB of the C channels (1, or C where it stores the image) of a
// frame.
template <int CB>
__global__ void __launch_bounds__(1024) inverse_tail_kernel(
    const int* __restrict__ coeff, Plane co, int C, UnliftChain ch,
    void* __restrict__ dst, Plane ds, int colour, int u8) {
  // CB planes of ht x wt samples, then the two axes' entries.
  extern __shared__ int t[];
  const int64_t n = blockIdx.x / (C / CB);
  const int c0 = (int)(blockIdx.x % (C / CB)) * CB;  // the first channel
  const int tx = threadIdx.x, ty = threadIdx.y, Y = blockDim.y;
  const int L = ch.n, ht = ch.h[L - 1], wt = ch.w[L - 1];
  const int plane = ht * wt;
  int* ey = t + CB * plane;
  int* ex = ey + ht;
  for (int i = ty * 32 + tx; i < ht + wt; i += 32 * Y) {
    if (i < ht) ey[i] = axis_entry(i, ch.h, L);
    else ex[i - ht] = axis_entry(i - ht, ch.w, L);
  }
  __syncthreads();
  // The root band and every level's detail quadrants: the coefficients'
  // ht x wt corner, each to its place on its level's lattice.
  for (int a = ty; a < ht; a += Y) {
    const int* row = coeff + n * co.frame + (int64_t)a * co.row + c0;
    const int ea = ey[a];
    for (int e = tx; e < wt * CB; e += 32) {
      const int b = e / CB, c = e - b * CB, eb = ex[b];
      const int k = max(ea >> 16, eb >> 16);
      t[c * plane + place(a, ea, k, L) * wt + place(b, eb, k, L)] =
          __ldg(row + (int64_t)b * C + c);
    }
  }
  __syncthreads();
  for (int k = 1; k <= L; ++k) {
    const int h = ch.h[k - 1], w = ch.w[k - 1], st = 1 << (L - k);
    const int rs = st * wt;  // a row of this level, in t
    const int he = (h + 1) / 2, we = (w + 1) / 2, nh = h / 2, nw = w / 2;
    const int nuh = (h & 1) ? he - 1 : he, nuw = (w & 1) ? we - 1 : we;
    for (int q = ty; q < CB * nuh; q += Y) {  // columns: undo the update
      const int c = q / nuh, i = 2 * (q - c * nuh);
      int* x = t + c * plane + i * rs;
      const int up = i >= 1 ? -rs : rs;
      for (int jj = tx; jj < w; jj += 32)
        x[jj * st] -= (x[jj * st + up] + x[jj * st + rs]) / 4;
    }
    __syncthreads();
    for (int q = ty; q < CB * nh; q += Y) {  // columns: undo the predict
      const int c = q / nh, i = 2 * (q - c * nh) + 1;
      int* x = t + c * plane + i * rs;
      const int down = i + 1 < h ? rs : -rs;
      for (int jj = tx; jj < w; jj += 32)
        x[jj * st] += (x[jj * st - rs] + x[jj * st + down]) / 2;
    }
    __syncthreads();
    for (int q = ty; q < CB * h; q += Y) {  // rows: undo the update
      const int c = q / h;
      int* x = t + c * plane + (q - c * h) * rs;
      for (int kk = tx; kk < nuw; kk += 32) {
        const int jj = 2 * kk, left = jj >= 1 ? jj - 1 : jj + 1;
        x[jj * st] -= (x[left * st] + x[(jj + 1) * st]) / 4;
      }
    }
    __syncthreads();
    for (int q = ty; q < CB * h; q += Y) {  // rows: undo the predict
      const int c = q / h;
      int* x = t + c * plane + (q - c * h) * rs;
      for (int kk = tx; kk < nw; kk += 32) {
        const int jj = 2 * kk + 1, right = jj + 1 < w ? jj + 1 : jj - 1;
        x[jj * st] += (x[(jj - 1) * st] + x[right * st]) / 2;
      }
    }
    __syncthreads();
  }
  // The top level's output, a row at a time: int32 into an LL buffer (or
  // the int32 result), or the image's bytes after the colour and clamps
  // (CB == C).
  const bool col = CB == 3 && colour != 0, b8 = u8 != 0;
  for (int y = ty; y < ht; y += Y) {
    const int* p = t + y * wt;
    auto at = [&](int e) {
      const int x = e / CB, c = e - x * CB;
      const int v = col ? rgb_of(c, p[x], p[plane + x], p[2 * plane + x])
                        : p[c * plane + x];
      return b8 ? to_byte(v) : v;
    };
    const int64_t o = n * ds.frame + (int64_t)y * ds.row;
    if (b8) {
      put_bytes((unsigned char*)dst + o, wt * C, tx, 32, at);
    } else {
      int* d = (int*)dst + o + c0;
      for (int e = tx; e < wt * CB; e += 32) {
        const int x = e / CB;
        d[(int64_t)x * C + (e - x * CB)] = at(e);
      }
    }
  }
}

bool bad_out(int C, int colour) {
  return (C != 1 && C != 3) || (colour && C != 3);
}

}  // namespace

// One large level: its output, n frames of h x w samples and C channels,
// from the LL quadrant at ll (the previous launch's output, or the root
// band in the coefficients) and the detail quadrants in coeff, each at its
// frame and row strides (elements), into dst at its strides: int32, or
// with u8 the clamped uint8 image, with colour the inverse colour first;
// `bp` row pairs a warp.
extern "C" int dwt_unlift_level(const void* coeff, int64_t co_frame,
                                int64_t co_row, const void* ll,
                                int64_t ll_frame, int64_t ll_row, void* dst,
                                int64_t ds_frame, int64_t ds_row, int n,
                                int h, int w, int C, int bp, int colour,
                                int u8, void* stream) {
  if (n < 0 || h < 2 || w < 2 || bp < 1 || bad_out(C, colour))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int nstrips = ((w + 1) / 2 + PAIRS - 1) / PAIRS;
  const int nbands = ((h + 1) / 2 + bp - 1) / bp;
  const int64_t nwarps = (int64_t)n * nstrips * nbands;
  const int64_t blocks = (nwarps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const Plane co{co_frame, co_row}, lo{ll_frame, ll_row},
      ds{ds_frame, ds_row};
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1)
    inverse_level_kernel<1><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        (const int*)coeff, co, (const int*)ll, lo, dst, ds, colour, u8,
        nwarps, h, w, bp, nstrips, nbands);
  else
    inverse_level_kernel<3><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        (const int*)coeff, co, (const int*)ll, lo, dst, ds, colour, u8,
        nwarps, h, w, bp, nstrips, nbands);
  return (int)cudaGetLastError();
}

// The coarse tail: the chain's levels (level 1 first, from the root band)
// of n frames from the coefficients, the top level's output into dst as
// dwt_unlift_level writes it.
extern "C" int dwt_unlift_tail(const void* coeff, int64_t co_frame,
                               int64_t co_row, int n, int C, UnliftChain chain,
                               void* dst, int64_t ds_frame, int64_t ds_row,
                               int colour, int u8, void* stream) {
  if (n < 0 || chain.n < 1 || chain.n > MAXL || bad_out(C, colour))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < chain.n; ++k)
    if (chain.h[k] < 2 || chain.w[k] < 2) return (int)cudaErrorInvalidValue;
  const int ht = chain.h[chain.n - 1], wt = chain.w[chain.n - 1];
  // A block a frame's channel, or all C where the image is stored.
  const int cb = colour || u8 ? C : 1;
  const int64_t smem = ((int64_t)cb * ht * wt + ht + wt) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if ((int64_t)n * (C / cb) > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  if (n == 0) return 0;
  auto kernel = cb == 1 ? inverse_tail_kernel<1> : inverse_tail_kernel<3>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // Blocks of 1,024 threads for a large level, halved where a block holds
  // one channel and there are enough blocks to keep several on each SM.
  const int64_t blocks = (int64_t)n * (C / cb);
  const int Y = ht * wt > 4096 ? (cb == 1 && blocks >= 256 ? 16 : 32)
                               : (ht * wt > 1024 ? 8 : 2);
  const Plane co{co_frame, co_row}, ds{ds_frame, ds_row};
  kernel<<<(unsigned)blocks, dim3(32, Y), (size_t)smem,
           (cudaStream_t)stream>>>((const int*)coeff, co, C, chain, dst, ds,
                                   colour, u8);
  return (int)cudaGetLastError();
}
