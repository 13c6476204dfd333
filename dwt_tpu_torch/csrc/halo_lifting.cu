// The row-sharded halo transform's levels on one rank's block: kernel 18,
// the forward (halo_fwd_kernel), and kernel 19, the inverse
// (halo_inv_kernel), for ops/halo.py.
//
// No TPU kernel to replace: the JAX package compiles the sharded transform
// into one XLA program inside shard_map (dwt_tpu/parallel/tiled.py:
// halo_dwt2d_fwd and halo_dwt2d_inv, their _lift_fwd_strided and
// _lift_inv_strided, the colour of dwt_tpu/parallel/encode.py:sharded_lin
// and ShardedDecoder).  The plain PyTorch versions (ops/halo.py:
// halo_forward_plain, halo_inverse_plain) run the same formulas eagerly,
// level by level.
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
// division truncates toward zero (C's /).  A launch runs one level, or
// the two finest levels of a rank without neighbours (a pair: forward
// levels 0 then 1, inverse 1 then 0).  A rank's first even row needs the
// previous rank's last detail row and its last odd row the next rank's
// first even row: they come in through `edge`, and the modes split a
// one-level launch where the exchanges fall (forward: head, bulk, fix;
// inverse: pack, head, bulk).
//
// Bound: bytes.  The forward reads its input once (the image's bytes, the
// LL quadrant after) and writes each coefficient once (the detail
// quadrants strided into the fine block, the LL quadrant compact for the
// next launch); the inverse reads each coefficient once and writes its
// grid once (compact; the image's bytes at level 0).  At 3840x2160 RGB
// the pair moves about 140 MB, 0.04 ms at 3.35 TB/s; the levels after it
// a sixteenth of that, their fine rows at stride s > 1 in sectors (32
// bytes) written or read in part.  The integer work, about 14 operations
// a sample, takes less time at the card's INT32 rate.
//
// Two designs, each where it is the faster on an H100 (PERF.md §6):
//
// * One level (halo_fwd_kernel and halo_inv_kernel of a HaloArgs, entry points
//   dwt_halo_forward and dwt_halo_inverse): a warp owns a strip of grid
//   columns and a band of `bp` row pairs.  Lane l holds the C channels of
//   column 28 * strip + l - 2 in registers; the lifting along a row reads its
//   neighbours by shuffles, so lanes 0-1 and 30-31 are the strip's halo and
//   lanes 2..29 store.  Columns are lifted in registers as the warp walks down
//   its band, two rows a step, after a prologue of the rows above the band.
//   The forward's contiguous runs of stores (level 0's rows, the compact LL
//   rows) go through a warp-private shared buffer so that they leave
//   coalesced; the inverse's output rows are stored lane by lane (staged, they
//   took longer: its loop waits on each step).  A level's launch is short at
//   the coarse levels, and this design has the least to do before its first
//   store.
//
// * The pair (halo_fwd_kernel and halo_inv_kernel of a PairArgs, entry points
//   dwt_halo_forward_pair and dwt_halo_inverse_pair; namespace pair): a block
//   of NT threads owns a tile of PX * (NT - 2) grid columns (a thread PX
//   neighbouring columns, all C channels; the first and last thread only the
//   column halo) by a band of row pairs, which it walks down four level-0 rows
//   and two of level 1 a step.  Its input rows stream into a ring of rows in
//   shared memory by 16-byte cp.async copies of whole sectors, a stage (a
//   step's rows) a group, DEPTH stages ahead of the lifting; a thread reads
//   its own columns from the ring by 4- or 16-byte loads and its neighbours'
//   by shuffles.  Level 0's LL quadrant never leaves the chip: the thread
//   holding level 0's even columns lifts them as level 1's (rows of values
//   exchanged through shared memory), so each fine row leaves once, whole, as
//   16-byte stores of neighbouring threads (level 0's odd rows as they are
//   computed, its even rows, level 1's values interleaved with level 0's, when
//   level 1 has them), and only level 1's compact LL quadrant goes out.  The
//   inverse mirrors it: it reads each fine row once, level 1's output stays on
//   the chip for level 0, and the pixels leave as 4-byte stores of
//   neighbouring threads.  A band's prologue recomputes the rows above it that
//   its first steps need (six level-0 rows forward, two inverse).  The hot
//   loop holds each piece of a step's code once and runs it twice (level 0's
//   two pairs, their two rows): half the code to fetch.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;   // warps a block
constexpr int STRIP = 28;  // grid columns a warp stores: lanes 2..29
constexpr unsigned FULL = 0xffffffffu;
enum { TOP = 0, BOT = 1, NXT = 2, PRV = 3 };  // rows of `edge`
enum { FWD_HEAD = 0, FWD_BULK = 1, FWD_FIX = 2 };
enum { INV_PACK = 0, INV_HEAD = 1, INV_BULK = 2 };

}  // namespace

// A launch of one level of one rank's block (ops/halo.py:_args, by
// value).
struct HaloArgs {
  const void* src;  // forward: the level's input rows (uint8 or int32)
  int* fine;        // the rank's (rows * s, W, C) block
  int* ll;          // forward: the LL quadrant out; inverse: in (or null)
  int* edge;        // (4, w, C): TOP, BOT, NXT, PRV (null: no neighbours)
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
    if (p.store && j == P - 1 && a.next) store<C>(edge_at(a, BOT, p.k), d);
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


// --- the pair: levels 0 and 1 of a rank without neighbours ------------------

// One level of the pair (ops/halo.py:Level, by value).
struct HaloLevel {
  int s, w, rows, g0, n_even, n_upd, prev, next, coarsest;
};

// A launch of the pair (ops/halo.py:_pair_args, by value).
struct PairArgs {
  const void* src;  // forward: level 0's input rows (uint8 or int32)
  int* fine;        // the rank's (rows, W, C) block
  int* ll;          // forward: level 1's LL quadrant out; inverse: in (null:
                    // in the fine block)
  void* out;        // inverse: level 0's (rows, w, C) output
  int64_t fine_row; // elements of a fine row: W * C
  int src_rows, src_u8, colour, out_u8, C;
  int bp;           // level-0 row pairs of a band (the entry point's)
  HaloLevel lv[2];
};

namespace {

// The cp.async copies of the pair's rings and its dynamic shared memory
// (tests/cuda_cpu.py gives its CPU build its own: HALO_HOST).
#ifndef HALO_HOST
__device__ __forceinline__ void cp16(char* dst, const char* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ char* dynamic_smem() {
  extern __shared__ __align__(16) char smem[];
  return smem;
}
#endif

namespace pair {

constexpr int NT = 128;              // threads a block
constexpr int PX = 4;                // grid columns a thread
constexpr int TILE = PX * (NT - 2);  // columns a tile stores
// Stages in flight ahead of the lifting: forward, inverse (whose rows are
// int32 and four times as wide, and which keeps a stage more).
constexpr int DEPTH_FWD = 2, DEPTH_INV = 1;

// The YCoCg-R of an RGB pixel (image.h:39-79).
template <int C>
__device__ __forceinline__ void ycocg(int* v) {
  if constexpr (C == 3) {
    const int U = v[0] - v[2];
    const int T = v[2] + U / 2;
    const int V = v[1] - T;
    v[0] = T + V / 2;
    v[1] = U;
    v[2] = V;
  }
}

// The inverse colour of a pixel with its decode-side clamps (image.h:
// 41-43) for RGB, then the clamp to [0, 255].
template <int C>
__device__ __forceinline__ void to_pixel(const int* x, bool colour,
                                         unsigned char* q) {
  int v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = x[c];
  if constexpr (C == 3) {
    if (colour) {
      const int Y = clamp_to(x[0], 0, 255), U = clamp_to(x[1], -255, 255),
                V = clamp_to(x[2], -255, 255);
      const int T = Y - V / 2;
      v[1] = V + T;
      v[2] = T - U / 2;
      v[0] = v[2] + U;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = (unsigned char)clamp_to(v[c], 0, 255);
}

// --- staging through shared memory -----------------------------------------


// A grid's rows in device memory, contiguous: row r's pixel k at byte
// ((r * rp + k * C) * es), C elements of es bytes; `rows` rows present
// (those past them read as zeros), `w` columns.
struct Rows {
  const char* p;
  int64_t rp;
  int es, w, rows;
};

// The byte of pixel p0 of row r in its ring slot: the slot holds the
// row's bytes from the 16-byte boundary of the address space at or below
// it (the tensor may start anywhere).
__device__ __forceinline__ int lead(const Rows& g, int C, int r, int p0) {
  return (int)(((uintptr_t)g.p + ((int64_t)r * g.rp + (int64_t)p0 * C) *
                                     g.es) & 15);
}

// Issue the 16-byte copies of row r's pixels [p0, p0 + n) into its ring
// slot (only those inside the row; none for a row past `rows`).  Every
// thread of the block calls it.
__device__ __forceinline__ void stage_row(const Rows& g, int C, int r,
                                          int p0, int n, char* slot) {
  if (r < 0 || r >= g.rows) return;
  const int a = max(p0, 0), b = min(p0 + n, g.w);
  if (a >= b) return;
  const int64_t row = (int64_t)r * g.rp;
  const uintptr_t base = (uintptr_t)g.p;
  const uintptr_t f = (base + (row + (int64_t)p0 * C) * g.es) & ~(uintptr_t)15;
  const uintptr_t lo = (base + (row + (int64_t)a * C) * g.es) & ~(uintptr_t)15;
  const uintptr_t hi = base + (row + (int64_t)b * C) * g.es;
  for (uintptr_t o = lo + 16 * threadIdx.x; o < hi; o += 16 * NT)
    cp16(slot + (o - f), (const char*)o);
}

// Pixel k (clamped into the row) of a staged row whose pixel p0 lies at
// q; zeros for a row past the grid's rows.  `colour`: the YCoCg-R of RGB.
template <int C>
__device__ __forceinline__ void pixel(const Rows& g, const char* q, int r,
                                      int p0, int k, bool colour, int* v) {
  if (r >= g.rows) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0;
    return;
  }
  const int i = (min(max(k, 0), g.w - 1) - p0) * C;
  if (g.es == 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = ((const unsigned char*)q)[i + c];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = ((const int*)q)[i + c];
  }
  if (colour) ycocg<C>(v);
}

// N pixels from k of a staged int32 row (as pixel() reads them), by
// 16-byte loads where they lie inside the row and aligned.
template <int C, int N>
__device__ __forceinline__ void pixels(const Rows& g, const char* q, int r,
                                       int p0, int k, int (&v)[N][C]) {
  const int i = (k - p0) * C;
  if (r < g.rows && k >= 0 && k + N <= g.w && (N * C) % 4 == 0 &&
      ((uintptr_t)((const int*)q + i) & 15) == 0) {
    const int4* s = (const int4*)((const int*)q + i);
#pragma unroll
    for (int u = 0; u < N * C / 4; ++u) {
      const int4 t = s[u];
      v[(4 * u) / C][(4 * u) % C] = t.x;
      v[(4 * u + 1) / C][(4 * u + 1) % C] = t.y;
      v[(4 * u + 2) / C][(4 * u + 2) % C] = t.z;
      v[(4 * u + 3) / C][(4 * u + 3) % C] = t.w;
    }
    return;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) pixel<C>(g, q, r, p0, k + n, false, v[n]);
}

// --- lifting in registers ---------------------------------------------------

// A row lifted along itself at columns b..b+N-1 (b even): x holds columns
// b-2 .. b+N (x[m] is column b - 2 + m), L the lifted values (right where
// the column lies in [0, w)).
template <int C, int N>
__device__ __forceinline__ void lift(const int (&x)[N + 3][C], int b, int w,
                                     int (&L)[N][C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    int dl = x[1][c] - (x[0][c] + x[2][c]) / 2;  // column b - 1
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const int k = b + i;
      const int dr = x[i + 3][c] -
                     (x[i + 2][c] + (k + 2 < w ? x[i + 4][c] : x[i + 2][c])) /
                         2;
      L[i][c] = ((w & 1) && k == w - 1)
                    ? x[i + 2][c]
                    : x[i + 2][c] + ((k == 0 ? dr : dl) + dr) / 4;
      L[i + 1][c] = dr;
      dl = dr;
    }
  }
}

// The inverse of lift at columns b..b+N-1 (b even): y holds columns
// b-1 .. b+N+1 (y[m] is column b - 1 + m).
template <int C, int N>
__device__ __forceinline__ void unlift(const int (&y)[N + 3][C], int b,
                                       int w, int (&X)[N][C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // The even sample of column k = b + i.
    auto ev = [&](int i) {
      const int k = b + i;
      return ((w & 1) && k == w - 1)
                 ? y[i + 1][c]
                 : y[i + 1][c] - ((k >= 1 ? y[i][c] : y[i + 2][c]) +
                                  y[i + 2][c]) / 4;
    };
    int el = ev(0);
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const int er = ev(i + 2);
      X[i][c] = el;
      X[i + 1][c] = y[i + 2][c] + (el + (b + i + 2 < w ? er : el)) / 2;
      el = er;
    }
  }
}

// A row of values computed in registers, lifted (or un-lifted) along
// itself: each thread writes its N columns to a row of shared memory
// (xput, N * C + 1 words a thread), and after a __syncthreads reads its
// neighbours' (lift_s, unlift_s).  The first and last thread's reads past
// the block give them values they do not store.
template <int C, int N>
__device__ __forceinline__ void xput(int* xr, const int (&v)[N][C]) {
  int* m = xr + threadIdx.x * (N * C + 1);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < C; ++c) m[n * C + c] = v[n][c];
}

template <int C, int N>
__device__ __forceinline__ void xget(const int* xr, int t, int i, int* v) {
  const int* m = xr + min(max(t, 0), NT - 1) * (N * C + 1) + i * C;
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = m[c];
}

// lift's row of columns b, b + 1 (b even) from a row of 2 a thread.
template <int C>
__device__ __forceinline__ void lift_s(const int* xr, int b, int w,
                                       int (&L)[2][C]) {
  const int t = threadIdx.x;
  int x[5][C];
  xget<C, 2>(xr, t - 1, 0, x[0]);
  xget<C, 2>(xr, t - 1, 1, x[1]);
  xget<C, 2>(xr, t, 0, x[2]);
  xget<C, 2>(xr, t, 1, x[3]);
  xget<C, 2>(xr, t + 1, 0, x[4]);
  lift<C, 2>(x, b, w, L);
}

// unlift's row of columns b .. b + N - 1 (b even) from a row of N a
// thread.
template <int C, int N>
__device__ __forceinline__ void unlift_s(const int* xr, int b, int w,
                                         int (&X)[N][C]) {
  const int t = threadIdx.x;
  int y[N + 3][C];
  xget<C, N>(xr, t - 1, N - 1, y[0]);
#pragma unroll
  for (int n = 0; n < N; ++n) xget<C, N>(xr, t, n, y[n + 1]);
  xget<C, N>(xr, t + 1, 0, y[N + 1]);
  xget<C, N>(xr, t + 1, 1, y[N + 2]);
  unlift<C, N>(y, b, w, X);
}

// --- stores -----------------------------------------------------------------

// N pixels from column b of a row, those inside [0, w): 16-byte stores
// where they lie inside the row and aligned.
template <int C, int N>
__device__ __forceinline__ void put(int* row, int b, int w,
                                    const int (&v)[N][C]) {
  int* q = row + (int64_t)b * C;
  if (b >= 0 && b + N <= w && (N * C) % 4 == 0 && ((uintptr_t)q & 15) == 0) {
#pragma unroll
    for (int u = 0; u < N * C / 4; ++u)
      ((int4*)q)[u] = make_int4(
          v[(4 * u) / C][(4 * u) % C], v[(4 * u + 1) / C][(4 * u + 1) % C],
          v[(4 * u + 2) / C][(4 * u + 2) % C],
          v[(4 * u + 3) / C][(4 * u + 3) % C]);
    return;
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (b + n >= 0 && b + n < w)
#pragma unroll
      for (int c = 0; c < C; ++c) q[n * C + c] = v[n][c];
}

// N uint8 pixels (to_pixel) from column b of an output row; 4-byte stores
// where they lie inside the row and aligned.
template <int C, int N>
__device__ __forceinline__ void put_bytes(unsigned char* row, int b, int w,
                                          bool colour, const int (&x)[N][C]) {
  unsigned char v[N * C];
#pragma unroll
  for (int n = 0; n < N; ++n) to_pixel<C>(x[n], colour, v + n * C);
  unsigned char* q = row + (int64_t)b * C;
  if (b >= 0 && b + N <= w && (N * C) % 4 == 0 && ((uintptr_t)q & 3) == 0) {
#pragma unroll
    for (int u = 0; u < N * C / 4; ++u)
      ((unsigned*)q)[u] = v[4 * u] | (v[4 * u + 1] << 8) |
                          (v[4 * u + 2] << 16) | ((unsigned)v[4 * u + 3] << 24);
    return;
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (b + n >= 0 && b + n < w)
#pragma unroll
      for (int c = 0; c < C; ++c) q[n * C + c] = v[n * C + c];
}

template <int C, int N>
__device__ __forceinline__ void copy_px(int (&d)[N][C], const int (&s)[N][C]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < C; ++c) d[n][c] = s[n][c];
}

// --- a tile's geometry ------------------------------------------------------

// A tile: its columns and band, the thread's columns.
struct Tile {
  int c0, i0, i1;  // first stored column; the band's level-0 pairs
  int b;           // the thread's first column (of PX)
  bool mine;       // the thread stores
};

__device__ __forceinline__ Tile tile_of(int w, int P, int bp, int t) {
  const int ntc = (w + TILE - 1) / TILE;
  Tile T;
  T.c0 = (t % ntc) * TILE;
  T.i0 = (t / ntc) * bp;
  T.i1 = min(T.i0 + bp, P);
  T.b = T.c0 - PX + PX * (int)threadIdx.x;
  T.mine = threadIdx.x >= 1 && threadIdx.x <= NT - 2;
  return T;
}

// Bytes of a ring slot for n pixels of C elements of es bytes.
__host__ __device__ __forceinline__ int slot_bytes(int n, int C, int es) {
  return ((n * C * es + 15) & ~15) + 16;
}

// Rows of a ring: the prologue's, a stage (four rows) a step ahead of
// DEPTH more, and the inverse's stage before.
constexpr int FWD_RING = 4 * DEPTH_FWD + 5, INV_RING = 4 * DEPTH_INV + 8;

// Staged pixels of a ring row: forward the threads' columns with two left
// and one right, inverse the threads' columns.
constexpr int FWD_PX = PX * NT + 3;
constexpr int INV_PX = PX * NT;

// Words of the rows exchanged through shared memory: forward, level 1's
// two rows of 2 a thread and the odd columns of level 0's last three
// updated even rows (2 a thread); inverse, level 1's two rows of 2 a
// thread and level 0's two pairs' two rows of PX a thread.
__host__ __device__ __forceinline__ int xwords(bool inverse, int C) {
  return inverse ? NT * (2 * (2 * C + 1) + 4 * (PX * C + 1))
                 : NT * (2 * (2 * C + 1) + 3 * 2 * C);
}

// The shared memory of a block: its ring, the inverse's ring of LL rows
// (DEPTH_INV + 1 rows of 2 * NT pixels), its exchanged rows.
__host__ __device__ __forceinline__ int smem_bytes(bool inverse, int C,
                                                   int es) {
  if (!inverse) return FWD_RING * slot_bytes(FWD_PX, C, es) + 4 * xwords(false, C);
  return INV_RING * slot_bytes(INV_PX, C, 4) +
         (DEPTH_INV + 1) * slot_bytes(2 * NT, C, 4) + 4 * xwords(true, C);
}

// A thread's PX columns of level-0 row r lifted along the row, from the
// ring slot whose pixel p0 lies at q: its own columns by 4- or 16-byte
// loads where they lie inside the row and aligned, the next thread's
// first column and the last thread's last detail by shuffles (lanes 31
// and 0 read theirs from the ring).
template <int C>
__device__ __forceinline__ void lifted(const Rows& g, const char* q, int r,
                                       int p0, int b, int w, bool colour,
                                       int (&L)[PX][C]) {
  const int lane = threadIdx.x & 31;
  int x[PX][C];
  if (g.es == 4) {
    pixels<C, PX>(g, q, r, p0, b, x);
  } else if (r < g.rows && b >= 0 && b + PX <= g.w &&
             ((uintptr_t)(q + (b - p0) * C) & 3) == 0) {
    const unsigned* u = (const unsigned*)(q + (b - p0) * C);
#pragma unroll
    for (int i = 0; i < PX * C / 4; ++i) {
      const unsigned t = u[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[(4 * i + j) / C][(4 * i + j) % C] = (t >> (8 * j)) & 255;
    }
  } else {
#pragma unroll
    for (int n = 0; n < PX; ++n) pixel<C>(g, q, r, p0, b + n, false, x[n]);
  }
  if (colour)
#pragma unroll
    for (int n = 0; n < PX; ++n) ycocg<C>(x[n]);
  int x4[C], d1[C], d3[C], dm[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x4[c] = __shfl_down_sync(FULL, x[0][c], 1);
  if (lane == 31) pixel<C>(g, q, r, p0, b + PX, colour, x4);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    d1[c] = x[1][c] - (x[0][c] + (b + 2 < w ? x[2][c] : x[0][c])) / 2;
    d3[c] = x[3][c] - (x[2][c] + (b + 4 < w ? x4[c] : x[2][c])) / 2;
    dm[c] = __shfl_up_sync(FULL, d3[c], 1);
  }
  if (lane == 0) {
    int m2[C], m1[C];
    pixel<C>(g, q, r, p0, b - 2, colour, m2);
    pixel<C>(g, q, r, p0, b - 1, colour, m1);
#pragma unroll
    for (int c = 0; c < C; ++c) dm[c] = m1[c] - (m2[c] + x[0][c]) / 2;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    L[0][c] = ((w & 1) && b == w - 1)
                  ? x[0][c]
                  : x[0][c] + ((b == 0 ? d1[c] : dm[c]) + d1[c]) / 4;
    L[1][c] = d1[c];
    L[2][c] = ((w & 1) && b + 2 == w - 1) ? x[2][c]
                                          : x[2][c] + (d1[c] + d3[c]) / 4;
    L[3][c] = d3[c];
  }
}

// --- kernel 18: levels 0 and 1 ----------------------------------------------

template <int C>
__device__ void forward(const PairArgs& a, int tile, char* smem) {
  constexpr int D = DEPTH_FWD;
  const HaloLevel A = a.lv[0], B = a.lv[1];
  const int P = A.rows / 2, w = A.w, wb = B.w;
  const Tile T = tile_of(w, P, a.bp, tile);
  const Rows g{(const char*)a.src, (int64_t)w * C, a.src_u8 ? 1 : 4, w,
               a.src_rows};
  const bool colour = a.colour;
  const int p0 = T.c0 - PX - 2;
  const int SR = slot_bytes(FWD_PX, C, g.es);
  // Level 1's two rows exchanged, and the odd columns of level 0's
  // updated even rows 2j in slot j % 3 (each thread its own).
  int* xr = (int*)(smem + FWD_RING * SR);
  int* odd = xr + 2 * NT * (2 * C + 1) + threadIdx.x * 2 * C;
  int* ll = a.ll;
  const int llw = (wb + 1) / 2;
  // Steps: level-1 pair q = qs + k, rows 4q+3 .. 4q+6 a stage, after a
  // prologue of rows 4 qs - 2 .. 4 qs + 2 and the step of level-0 pair
  // 2 qs.
  const int q0 = T.i0 / 2, q1 = T.i1 / 2, qs = max(q0 - 1, 0);
  const int js = 2 * qs;
  constexpr int PRE = 5, RPS = 4;
  const int rho0 = 2 * js - 2;
  const int nst = q1 - qs;
  auto slot = [&](int r) { return smem + ((r - rho0) % FWD_RING) * SR; };
  auto issue = [&](int k) {  // stage k (k < 0: the prologue)
    if (k < nst) {
      const int r0 = k < 0 ? rho0 : rho0 + PRE + RPS * k;
      const int n = k < 0 ? PRE : RPS;
      for (int r = r0; r < r0 + n; ++r)
        stage_row(g, C, r, p0, FWD_PX, slot(r));
    }
    cp_commit();
  };
  auto row = [&](int r, int (&L)[PX][C]) {
    lifted<C>(g, slot(r) + lead(g, C, r, p0), r, p0, T.b, w, colour, L);
  };
  auto put_row = [&](int r, const int (&v)[PX][C]) {
    if (T.mine) put<C, PX>(a.fine + r * a.fine_row, T.b, w, v);
  };
  issue(-1);
#pragma unroll 1
  for (int k = 0; k < D; ++k) issue(k);
  cp_wait<D>();
  __syncthreads();
  // e: the row-lifted even row 2j; dp: the detail row 2j - 1.
  int e[PX][C], dp[PX][C];
  row(2 * js, e);
  if (js > 0) {
    int q[PX][C], o[PX][C];
    row(2 * js - 2, q);
    row(2 * js - 1, o);
    const bool clamp = A.g0 + js >= A.n_even;
#pragma unroll
    for (int n = 0; n < PX; ++n)
#pragma unroll
      for (int c = 0; c < C; ++c)
        dp[n][c] = o[n][c] - (q[n][c] + (clamp ? q[n][c] : e[n][c])) / 2;
  }
  // Level-0 pair j's rows 2j + 1 and 2j + 2 lifted along the row (the
  // latter not past the rank's rows: step takes e).
  auto rows2 = [&](int j, int (&o)[PX][C], int (&en)[PX][C]) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // one copy of the row lift's code
      if (h == 1 && j + 1 >= P) break;
      int L[PX][C];
      row(2 * j + 1 + h, L);
      if (h == 0)
        copy_px<C, PX>(o, L);
      else
        copy_px<C, PX>(en, L);
    }
  };
  // Level-0 pair j: d (row 2j + 1) and s (row 2j) from e and dp, which
  // move on to pair j + 1.
  auto step = [&](int j, const int (&o)[PX][C], int (&en)[PX][C],
                  int (&d)[PX][C], int (&s)[PX][C]) {
    if (j + 1 >= P) copy_px<C, PX>(en, e);
    const bool clamp = A.g0 + j + 1 >= A.n_even;
    const bool upd = A.g0 + j < A.n_upd;
#pragma unroll
    for (int n = 0; n < PX; ++n)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        d[n][c] = o[n][c] - (e[n][c] + (clamp ? e[n][c] : en[n][c])) / 2;
        s[n][c] = upd ? e[n][c] + ((j > 0 ? dp[n][c] : d[n][c]) + d[n][c]) / 4
                      : e[n][c];
      }
    copy_px<C, PX>(dp, d);
    copy_px<C, PX>(e, en);
  };
  // Level 1 on the even columns of level 0's updated even rows: the
  // thread's columns b', b' + 1 (b' = b / 2) hold its columns b and b + 2;
  // E its row-lifted even row 2q, DP its detail row 2q - 1.
  const int bb = T.b / 2;
  int E[2][C], DP[2][C];
  // Pair j's updated even row s: its even columns to exchange row h, its
  // odd columns to slot j % 3.
  auto keep = [&](int j, int h, const int (&s)[PX][C]) {
    int v[2][C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[0][c] = s[0][c];
      v[1][c] = s[2][c];
      odd[(j % 3) * NT * 2 * C + c] = s[1][c];
      odd[(j % 3) * NT * 2 * C + C + c] = s[3][c];
    }
    xput<C, 2>(xr + h * NT * (2 * C + 1), v);
  };
  {
    int o[PX][C], en[PX][C], d[PX][C], s[PX][C];
    rows2(js, o, en);
    step(js, o, en, d, s);
    if (js >= T.i0) put_row(2 * js + 1, d);
    keep(js, 0, s);
    __syncthreads();
    lift_s<C>(xr, bb, wb, E);
  }
#pragma unroll 1
  for (int q = qs; q < q1; ++q) {
    cp_wait<D - 1>();
    __syncthreads();
    issue(q - qs + D);
    const bool two = 2 * q + 2 < P;  // level-0 pair 2q + 2 exists
    // Level-0 pairs 2q + 1 and 2q + 2 (the hot loop's code once, run
    // twice): their detail rows stored, their updated even rows kept.
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * q + 1 + h;
      if (j >= P) break;
      int o[PX][C], en[PX][C], d[PX][C], s[PX][C];
      rows2(j, o, en);
      step(j, o, en, d, s);
      if (j >= T.i0 && j < T.i1) put_row(2 * j + 1, d);
      keep(j, h, s);
    }
    __syncthreads();
    // Level 1's rows 2q + 1 and 2q + 2, lifted along the row.
    int O[2][C], EN[2][C];
    lift_s<C>(xr, bb, wb, O);
    if (two)
      lift_s<C>(xr + NT * (2 * C + 1), bb, wb, EN);
    else
      copy_px<C, 2>(EN, E);
    const bool clamp = B.g0 + q + 1 >= B.n_even;
    const bool upd = B.g0 + q < B.n_upd;
    int dd[2][C], ss[2][C];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dd[n][c] = O[n][c] - (E[n][c] + (clamp ? E[n][c] : EN[n][c])) / 2;
        ss[n][c] = upd ? E[n][c] + ((q > 0 ? DP[n][c] : dd[n][c]) +
                                    dd[n][c]) / 4
                       : E[n][c];
      }
    if (q >= q0) {
      // Fine rows 4q and 4q + 2: level 1's values on the even columns,
      // level 0's on the odd.
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const int* po = odd + ((2 * q + h) % 3) * NT * 2 * C;
        int r[PX][C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          r[0][c] = h ? dd[0][c] : ss[0][c];
          r[1][c] = po[c];
          r[2][c] = h ? dd[1][c] : ss[1][c];
          r[3][c] = po[C + c];
        }
        put_row(4 * q + 2 * h, r);
      }
      if (T.mine && bb < wb)
#pragma unroll
        for (int c = 0; c < C; ++c)
          ll[((int64_t)q * llw + bb / 2) * C + c] = ss[0][c];
    }
    copy_px<C, 2>(E, EN);
    copy_px<C, 2>(DP, dd);
  }
  cp_wait<0>();
}

// --- kernel 19: levels 1 and 0 ----------------------------------------------

template <int C>
__device__ void inverse(const PairArgs& a, int tile, char* smem) {
  constexpr int D = DEPTH_INV;
  const HaloLevel A = a.lv[0], B = a.lv[1];
  const int P = A.rows / 2, w = A.w, wb = B.w;
  const Tile T = tile_of(w, P, a.bp, tile);
  // The fine block's rows, and level 1's LL input (null: in the fine
  // block).
  const Rows g{(const char*)a.fine, a.fine_row, 4, w, A.rows};
  const int* llp = a.ll;
  const Rows lg{(const char*)llp, (int64_t)((wb + 1) / 2) * C, 4,
                (wb + 1) / 2, B.rows / 2};
  const int p0 = T.c0 - PX;
  const int lp0 = p0 / 4;  // the LL pixel of a thread: b / 4
  const int SR = slot_bytes(INV_PX, C, 4);
  const int LR = slot_bytes(2 * NT, C, 4);
  char* llring = smem + INV_RING * SR;
  // Level 1's two rows exchanged (2 a thread), then level 0's two pairs'
  // two rows (PX a thread).
  int* xr = (int*)(llring + (D + 1) * LR);
  int* xt = xr + 2 * NT * (2 * C + 1);
  const bool to_bytes = a.out_u8;
  const bool colour = to_bytes && a.colour;
  const int q0 = T.i0 / 2, q1 = T.i1 / 2;
  // Steps: level-1 pair q = q0 + k, rows 4q+4 .. 4q+7 (LL row q + 1) a
  // stage, after rows 4 q0 - 2 .. 4 q0 + 3 (LL row q0).
  constexpr int PRE = 6, RPS = 4;
  const int rho0 = 4 * q0 - 2;
  const int nst = q1 - q0;
  auto slot = [&](int r) { return smem + ((r - rho0) % INV_RING) * SR; };
  auto lslot = [&](int r) { return llring + ((r - q0) % (D + 1)) * LR; };
  auto issue = [&](int k) {  // stage k (k < 0: the prologue)
    if (k < nst) {
      const int r0 = k < 0 ? rho0 : rho0 + PRE + RPS * k;
      const int n = k < 0 ? PRE : RPS;
      for (int r = r0; r < r0 + n; ++r)
        stage_row(g, C, r, p0, INV_PX, slot(r));
      if (llp) {
        const int r = q0 + k + 1;
        stage_row(lg, C, r, lp0, 2 * NT, lslot(r));
      }
    }
    cp_commit();
  };
  // The thread's PX columns of level-0 row r.
  auto fine_px = [&](int r, int (&v)[PX][C]) {
    pixels<C, PX>(g, slot(r) + lead(g, C, r, p0), r, p0, T.b, v);
  };
  auto ll_px = [&](int r, int k, int* v) {
    pixel<C>(lg, lslot(r) + lead(lg, C, r, lp0), r, lp0, k, false, v);
  };
  auto unupdate = [&](const HaloLevel& Lv, int j, const int* e,
                      const int* lf, const int* d, int* sc) {
    const bool upd = Lv.g0 + j < Lv.n_upd;
#pragma unroll
    for (int c = 0; c < C; ++c) sc[c] = upd ? e[c] - (lf[c] + d[c]) / 4 : e[c];
  };
  // Output row r of level 0.
  auto put_out = [&](int r, const int (&x)[PX][C]) {
    if (!T.mine) return;
    if (to_bytes)
      put_bytes<C, PX>((unsigned char*)a.out + (int64_t)r * w * C, T.b, w,
                       colour, x);
    else
      put<C, PX>((int*)a.out + (int64_t)r * w * C, T.b, w, x);
  };
  issue(-1);
#pragma unroll 1
  for (int k = 0; k < D; ++k) issue(k);
  cp_wait<D>();
  __syncthreads();
  // d: level 0's detail row 2j; sc: its even row 2j un-updated.
  int d[PX][C], sc[PX][C];
  // Level 0's even row 2j from its LL columns `ev` (columns b, b + 2)
  // and the fine block's odd columns.
  auto even_t = [&](int j, const int (&ev)[2][C], int (&e)[PX][C]) {
    fine_px(2 * j, e);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      e[0][c] = ev[0][c];
      e[2][c] = ev[1][c];
    }
  };
  // Level 0's pair j: its rows (column-inverted) to exchange rows xh and
  // xh + 1; d and sc move on to pair j + 1 (whose even row's LL columns
  // are `evn`).
  auto step_t = [&](int j, const int (&evn)[2][C], int* xh) {
    int dn[PX][C], sn[PX][C];
    if (j + 1 < P) {
      int en[PX][C];
      fine_px(2 * j + 3, dn);
      even_t(j + 1, evn, en);
#pragma unroll
      for (int n = 0; n < PX; ++n) unupdate(A, j + 1, en[n], d[n], dn[n], sn[n]);
    } else {
      copy_px<C, PX>(sn, sc);
      copy_px<C, PX>(dn, d);
    }
    const bool clamp = A.g0 + j + 1 >= A.n_even;
    int od[PX][C];
#pragma unroll
    for (int n = 0; n < PX; ++n)
#pragma unroll
      for (int c = 0; c < C; ++c)
        od[n][c] = d[n][c] + (sc[n][c] + (clamp ? sc[n][c] : sn[n][c])) / 2;
    xput<C, PX>(xh, sc);
    xput<C, PX>(xh + NT * (PX * C + 1), od);
    copy_px<C, PX>(d, dn);
    copy_px<C, PX>(sc, sn);
  };
  // After the __syncthreads: the pair's rows un-lifted along the row and
  // stored as output rows 2j and 2j + 1.
  auto finish_t = [&](int j, const int* xh) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // one copy of the un-lift and store
      int X[PX][C];
      unlift_s<C, PX>(xh + h * NT * (PX * C + 1), T.b, w, X);
      put_out(2 * j + h, X);
    }
  };
  // Level 1: the thread's columns b' = b / 2 and b' + 1 (level 0's b and
  // b + 2); DQ its detail row 2q + 1, SQ its even row 2q un-updated.
  const int bb = T.b / 2;
  int DQ[2][C], SQ[2][C];
  // Level 1's columns of level-0 row r (even): columns b and b + 2; its
  // LL column from llp's row r / 4 where `ll`.
  auto cols = [&](int r, bool ll, int (&v)[2][C]) {
    int t[PX][C];
    fine_px(r, t);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[0][c] = t[0][c];
      v[1][c] = t[2][c];
    }
    if (ll && llp) ll_px(r / 4, T.b / 4, v[0]);
  };
  {
    int e[2][C], lf[2][C];
    cols(4 * q0 + 2, false, DQ);
    cols(4 * q0, true, e);
    if (q0 > 0)
      cols(4 * q0 - 2, false, lf);
    else
      copy_px<C, 2>(lf, DQ);
#pragma unroll
    for (int n = 0; n < 2; ++n) unupdate(B, q0, e[n], lf[n], DQ[n], SQ[n]);
  }
  const int PB = B.rows / 2;
#pragma unroll 1
  for (int q = q0; q <= q1; ++q) {
    cp_wait<D - 1>();
    __syncthreads();
    if (q > q0) issue(q - q0 + D);  // the first step's after its reads
    int X0[2][C], X1[2][C];
    if (q < PB) {  // level 1's pair q: its output rows 2q, 2q + 1
      const bool look = q < q1 && q + 1 < PB;
      int sn[2][C], dn[2][C], od[2][C];
      if (look) {
        int en[2][C];
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
          int t[2][C];
          cols(4 * q + 6 - 2 * h, h == 1, t);
          if (h == 0)
            copy_px<C, 2>(dn, t);
          else
            copy_px<C, 2>(en, t);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
          unupdate(B, q + 1, en[n], DQ[n], dn[n], sn[n]);
      } else {
        copy_px<C, 2>(sn, SQ);
        copy_px<C, 2>(dn, DQ);
      }
      const bool clamp = B.g0 + q + 1 >= B.n_even;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < C; ++c)
          od[n][c] = DQ[n][c] + (SQ[n][c] + (clamp ? SQ[n][c] : sn[n][c])) / 2;
      xput<C, 2>(xr, SQ);
      xput<C, 2>(xr + NT * (2 * C + 1), od);
      __syncthreads();
      unlift_s<C, 2>(xr, bb, wb, X0);
      unlift_s<C, 2>(xr + NT * (2 * C + 1), bb, wb, X1);
      copy_px<C, 2>(DQ, dn);
      copy_px<C, 2>(SQ, sn);
    }
    if (q == q0) {  // level 0's first pair of the band
      int e[PX][C], left[PX][C];
      fine_px(4 * q + 1, d);
      even_t(2 * q, X0, e);
      if (T.i0 > 0)
        fine_px(4 * q - 1, left);
      else
        copy_px<C, PX>(left, d);
#pragma unroll
      for (int n = 0; n < PX; ++n)
        unupdate(A, 2 * q, e[n], left[n], d[n], sc[n]);
    }
    // Level 0's pairs 2q - 1 and 2q (the code once, run twice), a
    // __syncthreads each between their column and row steps.
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * q - 1 + h;
      if (j < T.i0 || j >= T.i1) continue;
      int evn[2][C];
      if (h == 0)
        copy_px<C, 2>(evn, X0);
      else
        copy_px<C, 2>(evn, X1);
      int* xh = xt + 2 * h * NT * (PX * C + 1);
      step_t(j, evn, xh);
      __syncthreads();
      if (q == q0 && h == 1) issue(D);  // the prologue's rows all read
      finish_t(j, xh);
    }
  }
  cp_wait<0>();
}

}  // namespace pair

}  // namespace

// Kernel 18, the pair: a block a tile.
template <int C>
__global__ void __launch_bounds__(pair::NT, 3) halo_fwd_kernel(PairArgs a) {
  pair::forward<C>(a, blockIdx.x, dynamic_smem());
}

// Kernel 19, the pair: a block a tile.
template <int C>
__global__ void __launch_bounds__(pair::NT) halo_inv_kernel(PairArgs a) {
  pair::inverse<C>(a, blockIdx.x, dynamic_smem());
}

namespace {

int check_args(const HaloArgs& a, int mode, int bulk) {
  if ((a.C != 1 && a.C != 3) || a.w < 2 || a.rows < 2 || (a.rows & 1) ||
      a.s < 1 || a.bp < 1 || mode < 0 || mode > 2 || !a.fine ||
      (!a.edge && (a.prev || a.next || mode != bulk)))
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

// One level: a warp a strip of columns and, in the bulk mode, a band of
// `bp` row pairs.
template <typename Kernel>
int launch_strip(Kernel kernel, const HaloArgs& a, int mode, int bulk,
                 void* stream) {
  int nstrips, nbands;
  const int64_t blocks = blocks_of(a, mode, bulk, &nstrips, &nbands);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      a, mode, nstrips, nbands);
  return (int)cudaGetLastError();
}

using StripKernel = void (*)(HaloArgs, int, int, int);

}  // namespace

// Kernel 18: one step (`mode`: head, bulk, fix) of a forward halo level.
extern "C" int dwt_halo_forward(HaloArgs a, int mode, void* stream) {
  if (int rc = check_args(a, mode, FWD_BULK)) return rc;
  if (!a.ll || (mode != FWD_FIX && !a.src && a.src_rows > 0))
    return (int)cudaErrorInvalidValue;
  return launch_strip(a.C == 1 ? (StripKernel)halo_fwd_kernel<1>
                               : (StripKernel)halo_fwd_kernel<3>,
                      a, mode, FWD_BULK, stream);
}

// Kernel 19: one step (`mode`: pack, head, bulk) of an inverse halo level.
extern "C" int dwt_halo_inverse(HaloArgs a, int mode, void* stream) {
  if (int rc = check_args(a, mode, INV_BULK)) return rc;
  if (mode == INV_BULK && !a.out) return (int)cudaErrorInvalidValue;
  return launch_strip(a.C == 1 ? (StripKernel)halo_inv_kernel<1>
                               : (StripKernel)halo_inv_kernel<3>,
                      a, mode, INV_BULK, stream);
}

namespace {

int check_pair(const PairArgs& a, bool inverse) {
  const HaloLevel &A = a.lv[0], &B = a.lv[1];
  if ((a.C != 1 && a.C != 3) || !a.fine || a.fine_row < 1 || A.s != 1 ||
      A.w < 2 || A.rows < 4 || (A.rows & 3) || A.prev || A.next ||
      B.s != 2 || B.rows * 2 != A.rows || B.w != (A.w + 1) / 2 ||
      B.g0 * 2 != A.g0 || B.prev || B.next ||
      (inverse ? !a.out : !a.ll || (!a.src && a.src_rows > 0)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The pair: a block a tile, bands of an even count of level-0 row pairs,
// enough tiles to fill the card's blocks once.
template <typename Kernel>
int launch_pair(Kernel kernel, PairArgs a, bool inverse, cudaStream_t s) {
  const int smem = pair::smem_bytes(inverse, a.C,
                                    !inverse && a.src_u8 ? 1 : 4);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      pair::NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int P = a.lv[0].rows / 2;
  const int ntc = (a.lv[0].w + pair::TILE - 1) / pair::TILE;
  const int nb = per_sm * sms / ntc > 1 ? per_sm * sms / ntc : 1;
  a.bp = (P + nb - 1) / nb;
  a.bp += a.bp & 1;  // whole level-1 pairs
  const int64_t tiles = (int64_t)ntc * ((P + a.bp - 1) / a.bp);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)tiles, pair::NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 18: the pair's launch.
extern "C" int dwt_halo_forward_pair(PairArgs a, void* stream) {
  if (int rc = check_pair(a, false)) return rc;
  using K = void (*)(PairArgs);
  return launch_pair(a.C == 1 ? (K)halo_fwd_kernel<1> : (K)halo_fwd_kernel<3>,
                     a, false, (cudaStream_t)stream);
}

// Kernel 19: the pair's launch.
extern "C" int dwt_halo_inverse_pair(PairArgs a, void* stream) {
  if (int rc = check_pair(a, true)) return rc;
  using K = void (*)(PairArgs);
  return launch_pair(a.C == 1 ? (K)halo_inv_kernel<1> : (K)halo_inv_kernel<3>,
                     a, true, (cudaStream_t)stream);
}
