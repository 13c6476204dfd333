// The row-sharded halo transform's levels on one rank's block: kernel 18,
// the forward level (halo_fwd_kernel), and kernel 19, the inverse level
// (halo_inv_kernel), for ops/halo.py.
//
// No TPU kernel to replace: the JAX package compiles the sharded transform
// into one XLA program inside shard_map (dwt_tpu/parallel/tiled.py:
// halo_dwt2d_fwd and halo_dwt2d_inv, their _lift_fwd_strided and
// _lift_inv_strided, the colour of dwt_tpu/parallel/encode.py:sharded_lin
// and ShardedDecoder).  The plain PyTorch versions (ops/halo.py:
// halo_forward_plain, halo_inverse_plain) run the same formulas eagerly.
//
// Semantics (ops/halo.py's docstring): level t lifts its grid, the rank
// block's rows and columns at stride s = 2^t, `rows` x `w` samples of C
// channels.  Forward: each grid row by CDF 5/3, interleaved (odd k: d =
// x[k] - (x[k-1] + x[k+1]) / 2, x[k+1] clamped to x[k-1] at k + 1 == w;
// even k: s = x[k] + (d[k-1] + d[k+1]) / 4, d[-1] clamped to d[1], the
// last sample of an odd w keeps its value), then each grid column the
// same way with the image's true edge applied by global row index: odd
// row j's even neighbour below clamps to its own even where the global
// even index j + 1 >= n_even, and even rows from n_upd keep their value.
// Inverse: columns un-updated, then un-predicted, then rows.  Every
// division truncates toward zero (C's /).  A rank's first even row needs
// the previous rank's last detail row and its last odd row the next
// rank's first even row: they come in through `edge`, and the modes split
// a level where the exchanges fall (forward: head, bulk, fix; inverse:
// pack, head, bulk).
//
// Bound: bytes.  The forward reads its input once (the image's bytes at
// level 0, the LL quadrant after) and writes each coefficient once (the
// detail quadrants strided into the fine block, the LL quadrant compact
// for the next level); the inverse reads each coefficient once and writes
// its grid once (compact; the image's bytes at level 0).  Its integer
// work, about 14 operations a sample over the levels, takes less time at
// the card's INT32 rate than those bytes.
//
// Design: a warp owns a strip of grid columns and a band of `bp` row
// pairs.  Lane l holds the C channels of column 28 * strip + l - 2 in
// registers; the lifting along a row reads its neighbours by
// __shfl_up_sync / __shfl_down_sync, so lanes 0-1 and 30-31 are the
// strip's halo and lanes 2..29 store.  Columns are lifted in registers as
// the warp walks down its band, two rows a step, after a prologue of the
// rows above the band.  Between levels the LL quadrant goes compact
// through device memory, so a level reads its input contiguously whatever
// its stride; the fine block's strided stores are the detail quadrants
// alone (and level 0's LL quadrant, which the next level overwrites: a
// sector written in part costs the card a read of it).  The forward's
// contiguous runs of stores (level 0's rows of the fine block, the
// compact LL rows) go through a warp-private shared buffer, so that the
// lanes' C values leave as coalesced stores (the inverse's output rows
// took longer that way on an H100, and are stored lane by lane).
#include "common.cuh"

namespace {

constexpr int WARPS = 4;   // warps a block
constexpr int STRIP = 28;  // grid columns a warp stores: lanes 2..29
constexpr unsigned FULL = 0xffffffffu;
enum { TOP = 0, BOT = 1, NXT = 2, PRV = 3 };  // rows of `edge`
enum { FWD_HEAD = 0, FWD_BULK = 1, FWD_FIX = 2 };
enum { INV_PACK = 0, INV_HEAD = 1, INV_BULK = 2 };

}  // namespace

// One level of one rank's block (ops/halo.py:_args, by value).
struct HaloArgs {
  const void* src;  // forward: the level's input rows (uint8 or int32)
  int* fine;        // the rank's (rows * s, W, C) block
  int* ll;          // forward: the LL quadrant out; inverse: in (or null)
  int* edge;        // (4, w, C): TOP, BOT, NXT, PRV
  void* out;        // inverse: the level's (rows, w, C) output
  int64_t fine_row; // elements of a fine row: W * C
  int src_rows, src_u8, colour, out_u8;
  int s, w, rows, g0, n_even, n_upd, prev, next, coarsest, C, bp;
};

namespace {

// The grid's strip and band of this warp, and the lane's column.
struct Place {
  int lane, k, kc, band;
  int k0, run;  // the strip's first stored column and its stored columns
  bool store;
};

__device__ __forceinline__ bool place(const HaloArgs& a, int nstrips,
                                      int nbands, Place& p) {
  const int64_t gw = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= (int64_t)nstrips * nbands) return false;  // uniform over a warp
  p.lane = threadIdx.x & 31;
  p.band = (int)(gw / nstrips);
  p.k0 = STRIP * (int)(gw % nstrips);
  p.k = p.k0 + p.lane - 2;
  p.kc = min(max(p.k, 0), a.w - 1);
  p.run = min(STRIP, a.w - p.k0);
  p.store = p.lane >= 2 && p.lane < 2 + STRIP && p.k < a.w;
  return true;
}

// A warp's contiguous run of stores: the C values of `n` columns, the one
// of run index `idx` from this lane (-1: none), at dst onwards; staged in
// the warp's shared buffer so that the stores are coalesced (a lane's C
// values lie C elements apart from its neighbours').  Every lane of the
// warp calls it.
template <int C>
__device__ __forceinline__ void put_run(int* stage, int* dst, int n, int idx,
                                        int lane, const int* v) {
  if (idx >= 0) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) stage[idx * C + ch] = v[ch];
  }
  __syncwarp();
  for (int e = lane; e < n * C; e += 32) dst[e] = stage[e];
  __syncwarp();
}

// Element (r, k) of the level's grid in the fine block.
__device__ __forceinline__ int* grid_at(const HaloArgs& a, int r, int k) {
  return a.fine + (int64_t)r * a.s * a.fine_row + (int64_t)k * a.s * a.C;
}

__device__ __forceinline__ int* edge_at(const HaloArgs& a, int row, int k) {
  return a.edge + ((int64_t)row * a.w + k) * a.C;
}

template <int C>
__device__ __forceinline__ void load(const int* p, int* v) {
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = p[ch];
}

template <int C>
__device__ __forceinline__ void store(int* p, const int* v) {
#pragma unroll
  for (int ch = 0; ch < C; ++ch) p[ch] = v[ch];
}

// Pixel k of the forward's input row r: zeros past its rows, the YCoCg-R
// (image.h:39-79) of RGB rows where asked.
template <int C>
__device__ __forceinline__ void load_src(const HaloArgs& a, int r, int k,
                                         int* v) {
  if (r >= a.src_rows) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = 0;
    return;
  }
  const int64_t o = ((int64_t)r * a.w + k) * C;
  if (a.src_u8) {
    const unsigned char* p = (const unsigned char*)a.src + o;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = p[ch];
  } else {
    load<C>((const int*)a.src + o, v);
  }
  if constexpr (C == 3) {
    if (a.colour) {
      const int U = v[0] - v[2];
      const int T = v[2] + U / 2;
      const int V = v[1] - T;
      v[0] = T + V / 2;
      v[1] = U;
      v[2] = V;
    }
  }
}

// A row lifted along itself: lane holds sample x of column k (any value
// where k lies outside [0, w)); L gets the lifted value, right on lanes
// 2..29.  Every lane of the warp calls it (the shuffles).
template <int C>
__device__ __forceinline__ void lift_row(const int* x, int k, int w, int* L) {
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const int xl = __shfl_up_sync(FULL, x[ch], 1);
    const int xr = __shfl_down_sync(FULL, x[ch], 1);
    // The detail this column holds if it is odd.
    const int dd = x[ch] - (xl + (k + 1 < w ? xr : xl)) / 2;
    const int dl = __shfl_up_sync(FULL, dd, 1);
    const int dr = __shfl_down_sync(FULL, dd, 1);
    if (k & 1)
      L[ch] = dd;
    else if ((w & 1) && k == w - 1)
      L[ch] = x[ch];
    else
      L[ch] = x[ch] + ((k == 0 ? dr : dl) + dr) / 4;
  }
}

// The inverse of lift_row, likewise on lanes 2..29.
template <int C>
__device__ __forceinline__ void unlift_row(const int* y, int k, int w,
                                           int* X) {
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const int yl = __shfl_up_sync(FULL, y[ch], 1);
    const int yr = __shfl_down_sync(FULL, y[ch], 1);
    // The even sample this column holds if it is even.
    const int ev = ((w & 1) && k == w - 1)
                       ? y[ch]
                       : y[ch] - ((k >= 1 ? yl : yr) + yr) / 4;
    const int el = __shfl_up_sync(FULL, ev, 1);
    const int er = __shfl_down_sync(FULL, ev, 1);
    X[ch] = (k & 1) ? y[ch] + (el + (k + 1 < w ? er : el)) / 2 : ev;
  }
}

// Row r of the forward's input, lifted along itself.
template <int C>
__device__ __forceinline__ void lifted(const HaloArgs& a, const Place& p,
                                       int r, int* L) {
  int x[C];
  load_src<C>(a, r, p.kc, x);
  lift_row<C>(x, p.k, a.w, L);
}

// The forward's stores of grid rows 2j (the updated evens `s`) and 2j + 1
// (the details `d`): the LL columns of row 2j to the compact ll; the rest
// to the fine block (at level 0 the LL columns too, where the next level
// overwrites them, so that its rows go out in whole 32-byte sectors: a
// sector written in part costs the card a read of it; at the coarsest
// level the LL columns too, as the result holds them).  Runs of level 0
// and of ll go through the warp's buffer.  Every lane calls it; `d` null:
// row 2j alone.
template <int C>
__device__ __forceinline__ void put_rows(const HaloArgs& a, const Place& p,
                                         int* stage, int j, const int* s,
                                         const int* d) {
  const int idx = p.store ? p.lane - 2 : -1;
  if (a.s == 1) {  // uniform over the launch
    if (d) put_run<C>(stage, grid_at(a, 2 * j + 1, p.k0), p.run, idx,
                      p.lane, d);
    put_run<C>(stage, grid_at(a, 2 * j, p.k0), p.run, idx, p.lane, s);
  } else if (p.store) {
    if (d) store<C>(grid_at(a, 2 * j + 1, p.k), d);
    if ((p.k & 1) || a.coarsest) store<C>(grid_at(a, 2 * j, p.k), s);
  }
  put_run<C>(stage, a.ll + ((int64_t)j * ((a.w + 1) / 2) + p.k0 / 2) * C,
             (p.run + 1) / 2, p.store && !(p.k & 1) ? idx / 2 : -1, p.lane,
             s);
}

}  // namespace

template <int C>
__global__ void __launch_bounds__(32 * WARPS)
    halo_fwd_kernel(HaloArgs a, int mode, int nstrips, int nbands) {
  __shared__ int stages[WARPS][STRIP * C];
  int* stage = stages[threadIdx.x >> 5];
  Place p;
  if (!place(a, nstrips, nbands, p)) return;
  const int P = a.rows / 2;
  if (mode == FWD_HEAD) {  // the row-lifted first even row, to send
    int L[C];
    lifted<C>(a, p, 0, L);
    if (p.store) store<C>(edge_at(a, TOP, p.k), L);
    return;
  }
  if (mode == FWD_FIX) {  // the first even row's update, with PRV
    if (a.g0 >= a.n_upd) return;  // uniform over the launch
    int e[C], d[C], l[C];
    load<C>((p.kc & 1) ? grid_at(a, 0, p.kc)
                       : a.ll + (int64_t)(p.kc >> 1) * C, e);
    load<C>(grid_at(a, 1, p.kc), d);
    load<C>(edge_at(a, PRV, p.kc), l);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) e[ch] += (l[ch] + d[ch]) / 4;
    put_rows<C>(a, p, stage, 0, e, nullptr);
    return;
  }
  const int i0 = p.band * a.bp, i1 = min(i0 + a.bp, P);
  // e: the row-lifted even row 2j; dp: the detail row 2j - 1.
  int e[C], dp[C];
  lifted<C>(a, p, 2 * i0, e);
  if (i0 > 0) {
    int q[C], o[C];
    lifted<C>(a, p, 2 * i0 - 2, q);
    lifted<C>(a, p, 2 * i0 - 1, o);
    const bool clamp = a.g0 + i0 >= a.n_even;
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      dp[ch] = o[ch] - (q[ch] + (clamp ? q[ch] : e[ch])) / 2;
  }
  for (int j = i0; j < i1; ++j) {  // uniform over the warp
    const int jg = a.g0 + j;
    int o[C], en[C];
    lifted<C>(a, p, 2 * j + 1, o);
    if (j + 1 < P) {
      lifted<C>(a, p, 2 * j + 2, en);
    } else if (a.next) {
      load<C>(edge_at(a, NXT, p.kc), en);
    } else {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) en[ch] = e[ch];
    }
    const bool clamp = jg + 1 >= a.n_even;
    const bool upd = jg < a.n_upd && !(j == 0 && a.prev);
    int d[C], s[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      d[ch] = o[ch] - (e[ch] + (clamp ? e[ch] : en[ch])) / 2;
      s[ch] = upd ? e[ch] + ((j > 0 ? dp[ch] : d[ch]) + d[ch]) / 4 : e[ch];
    }
    put_rows<C>(a, p, stage, j, s, d);
    if (p.store && j == P - 1) store<C>(edge_at(a, BOT, p.k), d);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      dp[ch] = d[ch];
      e[ch] = en[ch];
    }
  }
}

namespace {

// Even grid row j of the inverse's input at column k: its LL columns from
// ll (the fine block at the coarsest level), its others from the fine
// block.
template <int C>
__device__ __forceinline__ void load_even(const HaloArgs& a, int j, int k,
                                          int* v) {
  if ((k & 1) || !a.ll)
    load<C>(grid_at(a, 2 * j, k), v);
  else
    load<C>(a.ll + ((int64_t)j * ((a.w + 1) / 2) + (k >> 1)) * C, v);
}

// Even grid row j un-updated at column k, its odd neighbour above `l`.
template <int C>
__device__ __forceinline__ void unupdate(const HaloArgs& a, int j,
                                         const int* e, const int* l,
                                         const int* d, int* sc) {
  const bool upd = a.g0 + j < a.n_upd;
#pragma unroll
  for (int ch = 0; ch < C; ++ch)
    sc[ch] = upd ? e[ch] - (l[ch] + d[ch]) / 4 : e[ch];
}

__device__ __forceinline__ int clamp_to(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Output row r of the inverse at the lane's column: int32, or the
// image's bytes after the inverse colour with its decode-side clamps
// (image.h:41-43) and the clamp to [0, 255].  Stored lane by lane: staged
// through the warp's buffer these rows took longer on the H100 (the
// inverse's loop waits on each step's stores).
template <int C>
__device__ __forceinline__ void put_out(const HaloArgs& a, const Place& p,
                                        int r, const int* x) {
  if (!p.store) return;
  const int64_t o = ((int64_t)r * a.w + p.k) * C;
  if (!a.out_u8) {
    store<C>((int*)a.out + o, x);
    return;
  }
  int v[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = x[ch];
  if constexpr (C == 3) {
    if (a.colour) {
      const int Y = clamp_to(x[0], 0, 255), U = clamp_to(x[1], -255, 255),
                V = clamp_to(x[2], -255, 255);
      const int T = Y - V / 2;
      v[1] = V + T;
      v[2] = T - U / 2;
      v[0] = v[2] + U;
    }
  }
  unsigned char* q = (unsigned char*)a.out + o;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) q[ch] = (unsigned char)clamp_to(v[ch], 0, 255);
}

}  // namespace

template <int C>
__global__ void __launch_bounds__(32 * WARPS)
    halo_inv_kernel(HaloArgs a, int mode, int nstrips, int nbands) {
  Place p;
  if (!place(a, nstrips, nbands, p)) return;
  const int P = a.rows / 2;
  if (mode == INV_PACK) {  // the last detail row, to send
    if (!p.store) return;
    int d[C];
    load<C>(grid_at(a, a.rows - 1, p.k), d);
    store<C>(edge_at(a, BOT, p.k), d);
    return;
  }
  if (mode == INV_HEAD) {  // the first even row un-updated with PRV
    if (!p.store) return;
    int e[C], d[C], l[C], sc[C];
    load_even<C>(a, 0, p.k, e);
    load<C>(grid_at(a, 1, p.k), d);
    load<C>(edge_at(a, PRV, p.k), l);
    unupdate<C>(a, 0, e, l, d, sc);
    store<C>(edge_at(a, TOP, p.k), sc);
    return;
  }
  const int i0 = p.band * a.bp, i1 = min(i0 + a.bp, P);
  // d: the detail row 2j; sc: the even row 2j un-updated.
  int d[C], sc[C];
  {
    int e[C], l[C];
    load<C>(grid_at(a, 2 * i0 + 1, p.kc), d);
    load_even<C>(a, i0, p.kc, e);
    if (i0 > 0)
      load<C>(grid_at(a, 2 * i0 - 1, p.kc), l);
    else if (a.prev)
      load<C>(edge_at(a, PRV, p.kc), l);
    else
      load<C>(grid_at(a, 1, p.kc), l);
    unupdate<C>(a, i0, e, l, d, sc);
  }
  for (int j = i0; j < i1; ++j) {  // uniform over the warp
    int dn[C], sn[C];
    if (j + 1 < P) {
      int en[C];
      load<C>(grid_at(a, 2 * j + 3, p.kc), dn);
      load_even<C>(a, j + 1, p.kc, en);
      unupdate<C>(a, j + 1, en, d, dn, sn);
    } else if (a.next) {
      load<C>(edge_at(a, NXT, p.kc), sn);
    } else {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) sn[ch] = sc[ch];
    }
    const bool clamp = a.g0 + j + 1 >= a.n_even;
    int od[C], x[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      od[ch] = d[ch] + (sc[ch] + (clamp ? sc[ch] : sn[ch])) / 2;
    unlift_row<C>(sc, p.k, a.w, x);
    put_out<C>(a, p, 2 * j, x);
    unlift_row<C>(od, p.k, a.w, x);
    put_out<C>(a, p, 2 * j + 1, x);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      d[ch] = dn[ch];
      sc[ch] = sn[ch];
    }
  }
}

namespace {

int check_args(const HaloArgs& a, int mode) {
  if ((a.C != 1 && a.C != 3) || a.w < 2 || a.rows < 2 || (a.rows & 1) ||
      a.s < 1 || a.bp < 1 || mode < 0 || mode > 2 || !a.fine || !a.edge)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Warps of a launch: a strip of columns each, `bp` row pairs a band in
// the bulk mode, the first rows alone in the others.
int64_t blocks_of(const HaloArgs& a, int mode, int bulk, int* nstrips,
                  int* nbands) {
  *nstrips = (a.w + STRIP - 1) / STRIP;
  *nbands = mode == bulk ? (a.rows / 2 + a.bp - 1) / a.bp : 1;
  return ((int64_t)*nstrips * *nbands + WARPS - 1) / WARPS;
}

}  // namespace

// Kernel 18: one step (`mode`: head, bulk, fix) of a forward halo level.
extern "C" int dwt_halo_forward(HaloArgs a, int mode, void* stream) {
  if (int rc = check_args(a, mode)) return rc;
  if (!a.ll || (mode != FWD_FIX && !a.src && a.src_rows > 0))
    return (int)cudaErrorInvalidValue;
  int nstrips, nbands;
  const int64_t blocks = blocks_of(a, mode, FWD_BULK, &nstrips, &nbands);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.C == 1)
    halo_fwd_kernel<1><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        a, mode, nstrips, nbands);
  else
    halo_fwd_kernel<3><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        a, mode, nstrips, nbands);
  return (int)cudaGetLastError();
}

// Kernel 19: one step (`mode`: pack, head, bulk) of an inverse halo level.
extern "C" int dwt_halo_inverse(HaloArgs a, int mode, void* stream) {
  if (int rc = check_args(a, mode)) return rc;
  if (mode == INV_BULK && !a.out) return (int)cudaErrorInvalidValue;
  int nstrips, nbands;
  const int64_t blocks = blocks_of(a, mode, INV_BULK, &nstrips, &nbands);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.C == 1)
    halo_inv_kernel<1><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        a, mode, nstrips, nbands);
  else
    halo_inv_kernel<3><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        a, mode, nstrips, nbands);
  return (int)cudaGetLastError();
}
