// The decoder's inverse transform (kernel 16): the multi-level integer
// CDF 5/3 inverse lifting (cdf53.h:36-61, decode.c:16-30) of N (N, H, W, C)
// int32 coefficient pyramids and, as the finest level stores, the inverse
// YCoCg-R colour with the reference's decode-side clamps (image.h:41-43),
// the clamp to [0, 255] and the uint8 cast; with the decoder's midpoint
// bias for planes lost to truncation (decode.c:50-58) added to each detail
// coefficient as it is loaded.
//
// No TPU kernel to replace: the JAX package runs this as XLA
// (dwt_tpu/codec/decoder.py:_tail_fn: the bias, the scatter and root crop,
// dwt_tpu/ops/lifting.py:dwt2d_inv, dwt_tpu/ops/color.py:ycocg_to_rgb, the
// clip and cast, traced into one program).  The plain PyTorch version
// (ops/lifting.py:inverse_transform_plain) runs the same formulas eagerly.
//
// Semantics along an axis of n samples, deinterleaved [s | d] (ne = (n +
// 1) / 2 low samples, n / 2 high ones): ev[i] = s[i] - (d[i-1] + d[i]) / 4,
// d[-1] clamped to d[0], except the last even sample of an odd n, which
// keeps s; then od[i] = d[i] + (ev[i] + ev[i+1]) / 2, ev[ne] clamped to
// ev[ne-1]; x[2i] = ev[i], x[2i+1] = od[i].  Every division truncates
// toward zero (C's /).  Columns first, then rows; coarsest level first,
// each level's LL quadrant the output of the level before.
//
// Inputs as the decoder has them, read in place: the detail quadrants from
// the scatter's (H, W, N, C) output seen as (N, H, W, C) (frame stride C,
// column stride N * C), the root band from the parsed (N, C, total)
// coefficients (a View each: any element strides), and an (N, C, 16) table
// of bias magnitudes, bias[n][c][l] for the details that chain level l + 1
// adds: a nonzero detail v becomes v + sign(v) * bias (root and LL values
// get none).
//
// Bound: bytes.  The function reads the int32 coefficients once and writes
// the image once (1 byte a sample as uint8); its integer work (about 14
// operations a sample over all levels) takes less time than those bytes at
// the card's INT32 rate.  Between launches an LL buffer goes through device
// memory: each large level but the finest writes its output, and the next
// launch reads it again.
//
// inverse_tail_kernel (the coarse levels, ops/lifting.py:unlift_plan): a
// cluster of K blocks (one block where enough frames and channels fill the
// card) holds one frame's channel, or all C channels of it where the tail
// stores the image (the colour needs a pixel's three) or the frames are
// interleaved (a block then reads whole pixels), of the top tail level's
// output, a band of R rows a block, in shared memory.  The levels live on
// the lattices of that grid (level k of t at stride 2^(t-k)): a sample's
// level and its place in the coefficients follow in closed form from the
// trailing zeros of its row and column, so each block loads its band
// straight from the views, several loads in flight a thread, and undoes
// each level in place, coarsest first.  Columns are skewed (column x at x +
// x / 32), so that a warp's lanes on a lattice of stride up to 32 fall on
// 32 banks.  A column pass reads the rows above and below, which at a
// band's edge lie in a peer's shared memory (distributed shared memory);
// three cluster barriers a level order the column update, the column
// predict and the row passes (a warp owns a row in the row passes).  The
// band's rows of the top level leave as int32 runs into an LL buffer, or
// as the image's bytes with the colour, clamps and cast.
//
// inverse_level_kernel (one launch a larger level, coarsest first): a warp
// owns a strip of column pairs and a band of `bp` output row pairs of F
// frames, all channels; no block barrier.  Lane (p, f) = (lane / F, lane %
// F) holds pair j = j0 - 1 + p of frame f of its group: the low column j
// and the high column we + j of the level's deinterleaved input.  F = 1 on
// a contiguous pyramid (30 stored pairs a strip, lanes 0 and 31 the halo);
// on interleaved frames F = 2: lanes read two adjacent frames' pixels
// together (14 stored pairs), and the warps of a block take adjacent frame
// groups of one strip and band.  Columns are undone first, as the warp
// walks down its band, from a window in registers (the current pair's even
// row and detail, the next pair's raw rows, loaded a step ahead; the bias
// is added a step after the load, so that the loads stay in flight), after
// a prologue that reads the detail row above the band.  Rows are undone
// next: the undo-update reads the left pair's detail by __shfl_up_sync(F),
// the undo-predict the right pair's even sample by __shfl_down_sync(F).
// The LL quadrant comes from the buffer the launch before wrote (from the
// root view where no launch came before).  Each step's two output rows go
// through a warp-private shared buffer into coalesced 4-byte stores: int32
// runs for an LL buffer, and at the finest level, after the colour, the
// clamps and the cast in registers, the 2C bytes of a lane's two pixels in
// C 16-bit shared stores, read back and stored as whole words.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int MAXL = 17;  // levels a chain holds (runtime/build.py CHAIN_LEVELS)

// The levels one tail launch lifts: level k's output h[k-1] x w[k-1],
// coarsest first (runtime/build.py Chain).  Outside the unnamed namespace:
// the exported entry points take these by value.
struct UnliftChain {
  int n;
  int h[MAXL], w[MAXL];
};

// Where samples live: a base and element strides (runtime/build.py View).
struct View {
  const int* p;
  int64_t f, r, c, ch;  // frame, row, column, channel
};

// Built with -DDWT_STAMPS (tools/inverse_stamps.py): the tail's block 0,
// thread 0, writes the global timer and the SM clock at the ends of its
// phases; each of the first STAMP_WARPS warps of a level launch sums the SM
// cycles of each phase of its walk (the last launch writes last).
#ifdef DWT_STAMPS
constexpr int STAMP_WARPS = 8192;
__device__ unsigned long long g_tail_stamps[2][32];
__device__ long long g_warp_cycles[STAMP_WARPS][8];
#define TAIL_STAMP(k)                                              \
  do {                                                             \
    if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) { \
      unsigned long long t_;                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));       \
      g_tail_stamps[0][k] = t_;                                    \
      g_tail_stamps[1][k] = (unsigned long long)clock64();         \
    }                                                              \
  } while (0)
#define WARP_T0              \
  long long t_w = clock64(); \
  long long acc_w[6] = {0, 0, 0, 0, 0, 0}
#define WARP_LAP(k)                 \
  do {                              \
    const long long t_ = clock64(); \
    acc_w[k] += t_ - t_w;           \
    t_w = t_;                       \
  } while (0)
#define WARP_STEP ++acc_w[5]
#define WARP_END(gw)                                   \
  do {                                                 \
    if ((threadIdx.x & 31) == 0 && (gw) < STAMP_WARPS) \
      for (int q_ = 0; q_ < 6; ++q_)                   \
        g_warp_cycles[gw][q_] = acc_w[q_];             \
  } while (0)
extern "C" int dwt_unlift_stamps(void* tail, void* warps) {
  cudaError_t e = cudaMemcpyFromSymbol(tail, g_tail_stamps,
                                       sizeof(g_tail_stamps));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(warps, g_warp_cycles,
                                   sizeof(g_warp_cycles));
}
#else
#define TAIL_STAMP(k) \
  do {                \
  } while (0)
#define WARP_T0 \
  do {          \
  } while (0)
#define WARP_LAP(k) \
  do {              \
  } while (0)
#define WARP_STEP \
  do {            \
  } while (0)
#define WARP_END(gw) \
  do {               \
  } while (0)
#endif

namespace {

constexpr int WARPS = 4;  // warps a block of inverse_level_kernel
// Column pairs a warp of inverse_level_kernel stores at F = 1: lanes 1..30;
// lanes 0 and 31 hold the pairs on either side of the strip, its halo.
constexpr int PAIRS = 30;
constexpr int LOADS = 4;  // loads a thread of the tail keeps in flight
// Blocks of inverse_level_kernel an SM must hold at once: 6 caps it at 80
// registers (24 warps an SM), the fastest of 1, 5, 6, 7 and 8 on an H100
// (NVIDIA H100 80GB HBM3, 700 W; 4K, 480x270 and 480 512x512 tiles).
constexpr int LEVEL_MIN_BLOCKS = 6;
constexpr unsigned FULL = 0xffffffffu;

// Where the output goes: frame base and row strides in elements (a pixel's
// C channels adjacent).
struct Plane {
  int64_t frame, row;
};

// v + sign(v) * b: the midpoint bias of a detail coefficient.
__device__ __forceinline__ int biased(int v, int b) {
  return v > 0 ? v + b : (v < 0 ? v - b : 0);
}

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

// Bytes buf[0..n) (a shared buffer, 4-byte aligned) into dst by the lanes
// of a warp: whole words where dst is 4-byte aligned, else byte by byte.
__device__ __forceinline__ void put_run(unsigned char* dst,
                                        const unsigned char* buf, int n,
                                        int lane) {
  if (((uintptr_t)dst & 3u) == 0) {
    const unsigned* src = (const unsigned*)buf;
    unsigned* wd = (unsigned*)dst;
    for (int q = lane; q < n >> 2; q += 32) wd[q] = src[q];
    for (int i = (n & ~3) + lane; i < n; i += 32) dst[i] = buf[i];
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = buf[i];
  }
}

// One row undone along itself: the lane's low sample s[C] (column j of the
// deinterleaved row) and high sample d[C] (column we + j) -> its output
// pair a[C] (column 2j) and b[C] (column 2j + 1), right for the lanes
// that are not the strip's halo; the neighbouring pairs are F lanes away.
// Every lane of the warp calls it (the shuffles).
template <int C>
__device__ __forceinline__ void unlift_row(const int* s, const int* d, int j,
                                           int w, int F, int* a, int* b) {
  const int we = (w + 1) / 2, nupd = (w & 1) ? we - 1 : we;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    int dl = __shfl_up_sync(FULL, d[ch], F);  // d[j - 1]
    if (j == 0) dl = d[ch];                   // clamped to d[0]
    const int ev = j < nupd ? s[ch] - (dl + d[ch]) / 4 : s[ch];
    int en = __shfl_down_sync(FULL, ev, F);  // ev[j + 1]
    if (j + 1 >= we) en = ev;                // clamped to ev[we - 1]
    a[ch] = ev;
    b[ch] = d[ch] + (ev + en) / 2;
  }
}

// Both views' channel strides are 1 here (ops/lifting.py copies any other).
// F and BIAS (a bias table given) are compile-time, so that the main
// path's F = 1 without a bias keeps a lean loop.
template <int C, int F, bool BIAS>
__global__ void __launch_bounds__(32 * WARPS, LEVEL_MIN_BLOCKS)
    inverse_level_kernel(View det, View ll, const int* __restrict__ bias,
                         int blev, void* __restrict__ dst, Plane ds,
                         int colour, int u8, int64_t nwarps, int N, int h,
                         int w, int bp, int nstrips, int nbands) {
  __shared__ __align__(16) int stage[WARPS][2][2 * PAIRS * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  if (gw >= nwarps) return;  // uniform over the warp
  // F = 1: adjacent warps on adjacent strips; F > 1: on adjacent frame
  // groups of one strip and band.
  const int64_t groups = (N + F - 1) / F, sb = (int64_t)nstrips * nbands;
  const int64_t g = F > 1 ? gw % groups : gw / sb;
  const int64_t t = F > 1 ? gw / groups : gw % sb;
  const int strip = (int)(t % nstrips), band = (int)(t / nstrips);
  WARP_T0;
  constexpr int sp = 32 / F - 2;  // pairs a strip stores
  const int f = lane % F, p = lane / F;
  const int64_t n = min(g * F + f, (int64_t)N - 1);  // past N: reads frame N-1
  const int he = (h + 1) / 2, we = (w + 1) / 2, nh = h / 2, nw = w / 2;
  const int nupd = (h & 1) ? he - 1 : he;
  const int j0 = sp * strip;   // the first pair stored
  const int j = j0 - 1 + p;    // the lane's pair
  // The lane's columns, read at the nearest column in range past an edge
  // (such a lane's values are never stored).
  const int cl = min(max(j, 0), we - 1), chi = we + min(max(j, 0), nw - 1);
  const int i0 = band * bp, i1 = min(i0 + bp, he);
  int* buf0 = stage[warp][0];
  int* buf1 = stage[warp][1];
  int bz[C];  // this level's bias for the lane's frame, by channel
#pragma unroll
  for (int k = 0; k < C; ++k)
    bz[k] = BIAS ? __ldg(bias + (n * C + k) * 16 + blev) : 0;
  const int* lo = ll.p + n * ll.f + (int64_t)cl * ll.c;
  const int* dl = det.p + n * det.f + (int64_t)cl * det.c;
  const int* dh = det.p + n * det.f + (int64_t)chi * det.c;

  // Row i of the top half (LL, HL) and of the bottom half (LH, HH), each
  // clamped into its half, raw: the lane's low column's C values, then its
  // high column's.
  auto load_s = [&](int i, int* v) {
    const int64_t r = min(i, he - 1);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = __ldg(lo + r * ll.r + k);
      v[C + k] = __ldg(dh + r * det.r + k);
    }
  };
  auto load_d = [&](int i, int* v) {
    const int64_t r = he + min(i, nh - 1);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = __ldg(dl + r * det.r + k);
      v[C + k] = __ldg(dh + r * det.r + k);
    }
  };
  // The bias of raw rows: the high column of a top-half row, both of a
  // bottom-half row.
  auto bias_s = [&](int* v) {
#pragma unroll
    for (int k = 0; k < C; ++k) v[C + k] = biased(v[C + k], bz[k]);
  };
  auto bias_d = [&](int* v) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = biased(v[k], bz[k]);
      v[C + k] = biased(v[C + k], bz[k]);
    }
  };

  // E: the even row 2i undone along the columns; D: the detail of pair i;
  // sN, dN: pair i + 1's raw rows.
  int E[2 * C], D[2 * C], sN[2 * C], dN[2 * C];
  {
    int s[2 * C], dp[2 * C];
    load_s(i0, s);
    load_d(i0, D);
    if (BIAS) {
      bias_s(s);
      bias_d(D);
    }
    if (i0 > 0) {
      load_d(i0 - 1, dp);
      if (BIAS) bias_d(dp);
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
  WARP_LAP(0);
  const bool col = C == 3 && colour != 0, b8 = u8 != 0;
  const int npx = min(2 * sp, w - 2 * j0);  // pixels a row of the strip
  const bool mine = p >= 1 && p <= sp && j < we;  // stored by this lane
  for (int i = i0; i < i1; ++i) {
    // Pair i + 2's rows load while pair i is undone and stored; pair i +
    // 1's, loaded a step ago, get their bias.
    int s2[2 * C], d2[2 * C];
    if (i + 1 < i1 && i + 2 < he) {  // uniform over the warp
      load_s(i + 2, s2);
      load_d(i + 2, d2);
    }
    WARP_LAP(1);
    int EN[2 * C];
    if (BIAS && i + 1 < he) {  // uniform over the warp
      bias_s(sN);
      bias_d(dN);
    }
#pragma unroll
    for (int k = 0; k < 2 * C; ++k)
      EN[k] = i + 1 >= he ? E[k]  // clamped: ev[he] = ev[he - 1]
                          : (i + 1 < nupd ? sN[k] - (D[k] + dN[k]) / 4
                                          : sN[k]);
    const bool odd = i < nh;  // uniform over the warp
    int o[2 * C];
#pragma unroll
    for (int k = 0; k < 2 * C; ++k) o[k] = D[k] + (E[k] + EN[k]) / 2;
    WARP_LAP(2);
    // The rows: output row 2i from E, 2i + 1 from o.
    int px[2][2][C];
    unlift_row<C>(E, E + C, j, w, F, px[0][0], px[0][1]);
    if (odd) unlift_row<C>(o, o + C, j, w, F, px[1][0], px[1][1]);
    WARP_LAP(3);
    const int nrows = odd ? 2 : 1;
    // Into the buffer: frame f's run of 2 * sp pixels a row; the finest
    // level's as bytes after the colour and clamps (an odd width's last
    // pair leaves its second pixel past the run's end).
    if (mine) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r >= nrows) continue;
        int* b = r ? buf1 : buf0;
        if (col) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            int* v = px[r][q];
            const int Y = v[0], U = v[1 % C], V = v[2 % C];
#pragma unroll
            for (int ch = 0; ch < C; ++ch) v[ch] = rgb_of(ch, Y, U, V);
          }
        }
        const int at = f * 2 * sp * C + 2 * (p - 1) * C;
        if (b8) {  // the 2C bytes at an even offset, in C 16-bit stores
          unsigned by[2 * C];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int ch = 0; ch < C; ++ch)
              by[q * C + ch] = (unsigned)to_byte(px[r][q][ch]);
          unsigned short* h16 = (unsigned short*)((unsigned char*)b + at);
#pragma unroll
          for (int q = 0; q < C; ++q)
            h16[q] = (unsigned short)(by[2 * q] | by[2 * q + 1] << 8);
        } else {
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int ch = 0; ch < C; ++ch) b[at + q * C + ch] = px[r][q][ch];
        }
      }
    }
    __syncwarp();
    for (int r = 0; r < nrows; ++r) {
      const int* b = r ? buf1 : buf0;
      for (int ff = 0; ff < F; ++ff) {  // uniform over the warp
        const int64_t nf = g * F + ff;
        if (nf >= N) break;
        const int64_t at = nf * ds.frame + (int64_t)(2 * i + r) * ds.row
                           + (int64_t)2 * j0 * C;
        const int base = ff * 2 * sp * C;
        if (b8) {
          put_run((unsigned char*)dst + at,
                  (const unsigned char*)b + base, npx * C, lane);
        } else {
          int* d = (int*)dst + at;
          for (int e = lane; e < npx * C; e += 32) d[e] = b[base + e];
        }
      }
    }
    __syncwarp();
    WARP_LAP(4);
    WARP_STEP;
#pragma unroll
    for (int k = 0; k < 2 * C; ++k) {
      E[k] = EN[k];
      D[k] = dN[k];
      sN[k] = s2[k];
      dN[k] = d2[k];
    }
  }
  WARP_END(gw);
}

// Column x of the tail's grid in shared memory: skewed by x / 32.
__device__ __forceinline__ int skew(int x) { return x + (x >> 5); }

// Coordinate y of the top tail level's axis, whose levels' output sizes
// are n[0..L): its level (0 for the root band: y a multiple of 2^L; else
// level k = L - tz, tz the trailing zeros of y, whose detail half holds
// it) << 16 | its index on that level's deinterleaved axis (the root
// band's y >> L; level k's high index ceil(n[k - 1] / 2) + (y / 2^(L-k) -
// 1) / 2).  Sides of the tail are below 2^15.
__device__ __forceinline__ int axis_entry(int y, const int* n, int L) {
  if (y == 0) return 0;
  const int k = max(0, L - (__ffs(y) - 1));
  const int own = k == 0 ? y >> L
                         : (n[k - 1] + 1) / 2 + (((y >> (L - k)) - 1) >> 1);
  return k << 16 | own;
}

// Coordinate y (entry e) as an input of level k, k at least its own level:
// its own index at its own level, else the low half's y / 2^(L-k+1).
__device__ __forceinline__ int index_at(int y, int e, int k, int L) {
  return (e >> 16) == k ? (e & 0xffff) : y >> (L - k + 1);
}

// A column pass over row x of a level of w columns at stride st: x[j] -=
// (up[j] + dn[j]) / 4 (sign -1, the undo-update) or x[j] += (up[j] +
// dn[j]) / 2 (sign 1, the undo-predict), lane tx taking columns tx, tx +
// 32, ...; each round's loads issued before its stores.
__device__ __forceinline__ void col_pass(int* x, const int* up,
                                         const int* dn, int w, int st, int tx,
                                         int sign) {
  constexpr int U = 4;
  for (int j0 = tx; j0 < w; j0 += 32 * U) {
    int a[U], o[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = j0 + 32 * u;
      o[u] = skew(min(jj, w - 1) * st);
      a[u] = up[o[u]] + dn[o[u]];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j0 + 32 * u < w) x[o[u]] += sign < 0 ? -(a[u] / 4) : a[u] / 2;
  }
}

// A row pass over row x of a level of w columns at stride st, lane tx
// taking pairs tx, tx + 32, ... of the m it undoes: odd 0, the undo-update
// of the even columns (x[2k] -= (x[2k - 1] + x[2k + 1]) / 4, x[-1] read as
// x[1]); odd 1, the undo-predict of the odd ones (x[2k + 1] += (x[2k] +
// x[2k + 2]) / 2, x[w] read as x[w - 2]); each round's loads issued before
// its stores (a pass reads only the other parity).
__device__ __forceinline__ void row_pass(int* x, int m, int w, int st, int tx,
                                         int odd) {
  constexpr int U = 4;
  for (int k0 = tx; k0 < m; k0 += 32 * U) {
    int a[U], o[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = 2 * min(k0 + 32 * u, m - 1) + odd;
      const int l = jj >= 1 ? jj - 1 : jj + 1, r = jj + 1 < w ? jj + 1 : jj - 1;
      o[u] = skew(jj * st);
      a[u] = x[skew(l * st)] + x[skew(r * st)];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + 32 * u < m) x[o[u]] += odd ? a[u] / 2 : -(a[u] / 4);
  }
}

// A cluster of K blocks (one block at K = 1): CB of the C channels (1, or
// C) of a frame, a band of R rows of the top level's grid a block.
template <int CB>
__global__ void __launch_bounds__(1024) inverse_tail_kernel(
    View det, View root, const int* __restrict__ bias, int C,
    UnliftChain ch, void* __restrict__ dst, Plane ds, int colour, int u8,
    int K, int R, int pitch) {
  // CB planes of R x pitch samples, the columns' entries, the band's rows'
  // entries, and the bias by channel and level (0 at level 0).
  extern __shared__ int t[];
  TAIL_STAMP(0);
  const int rank = (int)(blockIdx.x % K);  // the block's rank in its cluster
  const int64_t task = blockIdx.x / K;
  const int64_t n = task / (C / CB);
  const int c0 = (int)(task % (C / CB)) * CB;  // the first channel
  const int tx = threadIdx.x, ty = threadIdx.y, Y = blockDim.y;
  const int tid = ty * 32 + tx, nt = 32 * Y;
  const int L = ch.n, ht = ch.h[L - 1], wt = ch.w[L - 1];
  const int y0 = min(rank * R, ht), y1 = min(y0 + R, ht);  // the band
  const int nb = y1 - y0, plane = R * pitch;
  int* ex = t + CB * plane;
  int* ey = ex + wt;
  int* bz = ey + R;  // [CB][MAXL + 1]
  for (int i = tid; i < wt + nb + CB * (L + 1); i += nt) {
    if (i < wt) {
      ex[i] = axis_entry(i, ch.w, L);
    } else if (i < wt + nb) {
      ey[i - wt] = axis_entry(y0 + i - wt, ch.h, L);
    } else {
      const int q = i - wt - nb, c = q / (L + 1), k = q - c * (L + 1);
      bz[c * (MAXL + 1) + k] =
          k == 0 || !bias ? 0 : __ldg(bias + (n * C + c0 + c) * 16 + k - 1);
    }
  }
  __syncthreads();
  TAIL_STAMP(1);
  // The band: each place's sample from the root view (level 0) or the
  // detail view with its level's bias, LOADS loads in flight a thread.
  const int64_t cnt = (int64_t)nb * wt * CB;
  for (int64_t e0 = tid; e0 < cnt; e0 += (int64_t)nt * LOADS) {
    int v[LOADS], to[LOADS], b[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int64_t e = e0 + (int64_t)u * nt;
      to[u] = -1;
      if (e < cnt) {
        const int rw = (int)(e / (wt * CB)), rem = (int)(e - (int64_t)rw * wt * CB);
        const int x = rem / CB, c = rem - x * CB, y = y0 + rw;
        const int ea = ey[rw], eb = ex[x];
        const int k = max(ea >> 16, eb >> 16);
        const int a = index_at(y, ea, k, L), bb = index_at(x, eb, k, L);
        const View& s = k == 0 ? root : det;
        v[u] = __ldg(s.p + n * s.f + a * s.r + bb * s.c + (c0 + c) * s.ch);
        b[u] = bz[c * (MAXL + 1) + k];
        to[u] = c * plane + rw * pitch + skew(x);
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (to[u] >= 0) t[to[u]] = biased(v[u], b[u]);
  }
  TAIL_STAMP(2);
  cg::cluster_group cluster = cg::this_cluster();
  auto bar = [&]() {
    if (K > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  // Plane c's row y of the grid: this block's, or a peer's (its band).
  auto row_of = [&](int y, int c) -> int* {
    const int o = y / R;
    int* r = t + c * plane + (y - o * R) * pitch;
    return o == rank ? r : cluster.map_shared_rank(r, o);
  };
  for (int k = 1; k <= L; ++k) {
    const int h = ch.h[k - 1], w = ch.w[k - 1], sh = L - k, st = 1 << sh;
    const int he = (h + 1) / 2, we = (w + 1) / 2, nh = h / 2, nw = w / 2;
    const int nuh = (h & 1) ? he - 1 : he, nuw = (w & 1) ? we - 1 : we;
    // This level's rows in the band: i in [ia, ib), at y = i * st.
    const int ia = (y0 + st - 1) >> sh, ib = min(h, (y1 + st - 1) >> sh);
    bar();
    {  // columns: undo the update of even rows i < 2 * nuh
      const int first = ia + (ia & 1), lim = min(ib, 2 * nuh);
      const int m = first < lim ? (lim - first + 1) / 2 : 0;
      for (int q = ty; q < CB * m; q += Y) {
        const int c = q / m, i = first + 2 * (q - c * m);
        int* x = row_of(i * st, c);
        const int* up = row_of((i >= 1 ? i - 1 : i + 1) * st, c);
        const int* dn = row_of((i + 1) * st, c);
        col_pass(x, up, dn, w, st, tx, -1);
      }
    }
    bar();
    {  // columns: undo the predict of odd rows i < h
      const int first = ia + !(ia & 1), lim = min(ib, 2 * nh);
      const int m = first < lim ? (lim - first + 1) / 2 : 0;
      for (int q = ty; q < CB * m; q += Y) {
        const int c = q / m, i = first + 2 * (q - c * m);
        int* x = row_of(i * st, c);
        const int* up = row_of((i - 1) * st, c);
        const int* dn = row_of((i + 1 < h ? i + 1 : i - 1) * st, c);
        col_pass(x, up, dn, w, st, tx, 1);
      }
    }
    bar();
    // Rows, a warp a row: undo the update, then the predict.
    const int m = ib > ia ? ib - ia : 0;
    for (int q = ty; q < CB * m; q += Y) {
      const int c = q / m;
      const int y = (ia + q - c * m) * st;
      int* x = t + c * plane + (y - y0) * pitch;
      row_pass(x, nuw, w, st, tx, 0);
      __syncwarp();
      row_pass(x, nw, w, st, tx, 1);
    }
    TAIL_STAMP(2 + k);
  }
  __syncthreads();
  // The band's rows of the top level: int32 into an LL buffer (or the
  // int32 result), or the image's bytes after the colour and clamps (CB ==
  // C).
  const bool col = CB == 3 && colour != 0, b8 = u8 != 0;
  for (int y = y0 + ty; y < y1; y += Y) {
    const int* p = t + (y - y0) * pitch;
    auto at = [&](int e) {
      const int x = e / CB, c = e - x * CB, o = skew(x);
      const int v = col ? rgb_of(c, p[o], p[plane + o], p[2 * plane + o])
                        : p[c * plane + o];
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
  TAIL_STAMP(31);
}

// The level kernel of C channels, F frames a warp, with a bias table or
// not (null where F is not 1 or 2).
using LevelKernel = void (*)(View, View, const int*, int, void*, Plane, int,
                             int, int64_t, int, int, int, int, int, int);
template <int C>
LevelKernel pick_level_c(int F, bool bias) {
  switch (F * 2 + bias) {
    case 2: return inverse_level_kernel<C, 1, false>;
    case 3: return inverse_level_kernel<C, 1, true>;
    case 4: return inverse_level_kernel<C, 2, false>;
    case 5: return inverse_level_kernel<C, 2, true>;
  }
  return nullptr;
}

LevelKernel pick_level(int C, int F, bool bias) {
  return C == 1 ? pick_level_c<1>(F, bias) : pick_level_c<3>(F, bias);
}

bool bad_out(int C, int colour) {
  return (C != 1 && C != 3) || (colour && C != 3);
}

}  // namespace

// One large level: its output, n frames of h x w samples and C channels,
// from the LL quadrant in ll (the previous launch's output, or the root
// band) and the detail quadrants in det (with bias[.][.][blev] where bias
// is given), each a View with a channel stride of 1, into dst at its
// strides: int32, or with u8 the clamped uint8 image, with colour the
// inverse colour first; `bp` row pairs a warp, F frames a warp (F = 2:
// adjacent warps on adjacent frame groups).
extern "C" int dwt_unlift_level(View det, View ll, const void* bias, int blev,
                                void* dst, int64_t ds_frame, int64_t ds_row,
                                int n, int h, int w, int C, int bp, int F,
                                int colour, int u8, void* stream) {
  if (n < 0 || h < 2 || w < 2 || bp < 1 || bad_out(C, colour)
      || (F != 1 && F != 2) || det.ch != 1 || ll.ch != 1
      || blev < 0 || blev >= 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int sp = 32 / F - 2;
  const int nstrips = ((w + 1) / 2 + sp - 1) / sp;
  const int nbands = ((h + 1) / 2 + bp - 1) / bp;
  const int64_t nwarps = ((int64_t)n + F - 1) / F * nstrips * nbands;
  const int64_t blocks = (nwarps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const Plane ds{ds_frame, ds_row};
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = pick_level(C, F, bias != nullptr);
  if (!kernel) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
      det, ll, (const int*)bias, blev, dst, ds, colour, u8, nwarps, n, h, w,
      bp, nstrips, nbands);
  return (int)cudaGetLastError();
}

// The coarse tail: the chain's levels (level 1 first, from the root band
// in root) of n frames, the details from det with their levels' bias, the
// top level's output into dst as dwt_unlift_level writes it; cb channels
// a cluster of K blocks of Y warps, R rows of pitch samples a block.
extern "C" int dwt_unlift_tail(View det, View root, const void* bias, int n,
                               int C, UnliftChain chain, void* dst,
                               int64_t ds_frame, int64_t ds_row, int colour,
                               int u8, int cb, int K, int R, int pitch, int Y,
                               void* stream) {
  if (n < 0 || chain.n < 1 || chain.n > MAXL || bad_out(C, colour)
      || (cb != 1 && cb != C) || ((colour || u8) && cb != C) || K < 1
      || K > 8 || R < 1 || Y < 1 || Y > 32)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < chain.n; ++k)
    if (chain.h[k] < 2 || chain.w[k] < 2 || chain.h[k] >= 32768
        || chain.w[k] >= 32768)
      return (int)cudaErrorInvalidValue;
  const int ht = chain.h[chain.n - 1], wt = chain.w[chain.n - 1];
  if ((int64_t)R * K < ht || pitch < (wt - 1) + ((wt - 1) >> 5) + 1)
    return (int)cudaErrorInvalidValue;
  const int64_t smem =
      ((int64_t)cb * R * pitch + wt + R + cb * (MAXL + 1)) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)n * (C / cb) * K;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (n == 0) return 0;
  auto kernel = cb == 1 ? inverse_tail_kernel<1> : inverse_tail_kernel<3>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Plane ds{ds_frame, ds_row};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(32, Y);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, det, root, (const int*)bias, C, chain,
                         dst, ds, colour, u8, K, R, pitch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
