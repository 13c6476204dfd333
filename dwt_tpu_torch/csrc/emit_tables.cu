// The emit half's step tables (kernel 17).
//
// No TPU kernel to replace: the JAX package computes these tables as XLA
// fused into its encode (dwt_tpu/codec/encoder.py: the tail of
// _codeword_contribs, _bit_partials, _kernel_b_meta and
// _layer_boundaries), about a hundred eager launches a sub-batch in the
// plain PyTorch version (ops/emit_tables.py: emit_tables_plain).
//
// Input, for N frames of S = C * L * PMAX steps: kernel 11's token offsets
// off (N, T) and 2048-slot bit sums chunks (N, NC); the steps' refinement
// bits nref and clamped injection sites (N, S); stage 1's schedule order
// (N, S: each schedule position's step), step_end, refpfx and step_base
// (N, S), planes (N, C), planes_max (N), the chunk tables nS_ck and nZ_ck
// and their level-exclusive scans over the chunks scar_ck and zcar_ck (N,
// C, nchunk, PMAX); kernel 15's unit columns elem, elen, p, flat_step,
// flat_ck and valid (N, U), U = C * nchunk * PMAX; the pyramid's chunk
// validity counts ch_valid and their level-exclusive scan vcar.  Output,
// each at its byte offset (enum Out) in the wrapper's one allocation:
//
// * refstart (N, S): off[end] - inj_le_end + refpfx, with end = step_end
//   clamped to [0, T - 1] and inj_le_end the sum of nref[t] over the steps
//   t whose site is at most end;
// * kernel B's meta (N * U, 8): the element row (elem + f * C * n) / SUBB,
//   the length, the plane, the word window ws + f * nwords, the unit's
//   first refinement bit less 32 * ws, 0, its refinement bits (0 for an
//   invalid step) and 0, where the first bit is refstart[flat_step] plus
//   rcar, the level-exclusive scan over the chunks of nR_ck = [p <
//   planes_max] (ch_valid - nS_ck - nZ_ck), and ws is its word's
//   128-aligned floor clamped to [0, wsmax];
// * head: the pack kernel's order flag (zeroed here), then bits_parts
//   (N, K), the chunk sums summed in groups of 512 and nref in groups of
//   8, then layer_ends (N, LMAX): for each layer k the least start bit
//   off[step_base] of a step of a later layer whose plane is below its
//   channel's planes, capped by the frame's int32 total of bits_parts.
//
// All arithmetic is int32 with wrapping adds, as the JAX package's.
//
// emit_tables_kernel, one launch (struct Plan; ops/emit_tables.py:
// launch_plan).  A group of threads works a frame: where a frame has at
// most 256 keys (np, a power of two >= S) and its units fit np / 4
// threads (at least a warp) 8 a thread, groups of np / 4 threads share a
// block of 256 (16x16 RGB tiles: 4 frames a block, 2 warps a frame);
// a larger frame takes a block of 256 threads for its step tables and bpf
// - 1 more of 256 for its units, ub a block.  Every group recomputes its
// frame's step tables in shared memory, so no block waits on another:
//
// 1. Every load a thread's steps and units need is issued first, at
//    indices clamped into the frame's tables and with no branch, so that
//    they are in flight together (a larger frame's 4K step tables and
//    token offsets lie in device memory, not L2): each step's end, off
//    there plus its refinement prefix, its base's off (the first block);
//    its schedule position's (site, nref) pair through `order`; each
//    unit's columns and chunk tables.  The kernel is instantiated at
//    (RUN, UPT) steps and units a thread (4, 4), (4, 8) and (8, 4), the
//    least that holds the plan: more than 4 keys a thread is a larger
//    frame's, whose blocks hold at most LARGE_UPT units a thread.
// 2. The pairs go to shared memory in schedule order.  The schedule puts
//    a step's injection site at the next step's base, which never
//    decreases, and the budget's cuts keep that; a permutation whose
//    sites never decrease (one vote a warp) is already sorted, so the
//    scan needs no sort.  Any other order (not a permutation, or sites
//    that decrease: no encode path makes one) sorts the frame's pairs as
//    64-bit keys by a bitonic network in shared memory instead (twice
//    the device time at 4K).  Sites are compared as signed ints (the sign
//    bit flipped in the keys).
// 3. The nrefs are scanned in that order (a run of np / tf keys a thread,
//    warp shuffles, the warps' totals); a step's inj_le_end is the scan at
//    the last key whose site is at most its end, by a binary search.
// 4. A frame's first block writes refstart, the bit partials (a warp two
//    token parts a turn; a thread a refinement part, from the nrefs that
//    step 2 also left in shared memory by step), the layer ends (a shared
//    atomic minimum a layer bucket, then a warp's suffix minimum) and,
//    frame 0, the order flag.
// 5. Each thread writes its units' 32-byte meta rows, consecutive threads
//    on consecutive rows.  rcar is closed form: the scans of nS_ck, nZ_ck
//    and ch_valid are linear, so it is [p < planes_max] (vcar - scar_ck -
//    zcar_ck) at the unit's chunk, in wrapping int32.
//
// Bound: bytes, what the function needs (not order, scar_ck, zcar_ck or
// vcar, which stand in for a sort and a level scan): 809,652 bytes a 4K
// frame (about 0.0002 ms at 3.35 TB/s), where one launch's latency and the
// first block's phases are the time; about 0.144 ms on a sub-batch of
// 29,126 16x16 tiles, mostly the step tables, the meta rows and the unit
// columns.
#include "common.cuh"

constexpr int PMAX = 29;              // ops/plane_stats.py
constexpr int MAX_STEPS = 2048;       // ops/schedule.py
constexpr int LMAX = 64;              // codec/emit.py
constexpr int SUBB_SHIFT = 10;        // ops/compact.py: SUBB = 1024
constexpr int PART_CHUNKS = 512;      // chunk sums a token part
constexpr int PART_STEPS = 8;         // steps a refinement part
constexpr int BIGBIT = 0x7fffffff;
constexpr int BLOCK = 256;            // threads a block, at most
constexpr int MAX_RUN = 8;            // keys a thread: np / tf
constexpr int MAX_UPT = 8;            // units a thread: ub / tf
constexpr int LARGE_UPT = 4;          // ... a larger frame's blocks' (UPT)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SIGN = 0x80000000u;

// The outputs, in ops/emit_tables.py's _layout order.
enum Out { O_REFSTART, O_META, O_HEAD, O_COUNT };

// The outputs' byte offsets in the wrapper's allocation, by value.
struct Offsets {
  int64_t at[O_COUNT];
};

// The launch plan (ops/emit_tables.py: launch_plan), by value.
struct Plan {
  int np;   // keys a frame: a power of two >= S, at least 64
  int tf;   // threads a frame: a power of two, np / MAX_RUN, at least 32
  int fpb;  // frames a block
  int bpf;  // blocks a frame: 1, or more (fpb is then 1, and block 0 of
            // a frame writes its step tables, blocks 1 to bpf - 1 its units)
  int ub;   // units a block of a frame, at most MAX_UPT * tf
            // (LARGE_UPT * tf where np / tf passes 4)
};

// The inputs are read-only, and the outputs never alias them: loads may
// be reordered freely.
struct Args {
  const int* __restrict__ off;
  const int* __restrict__ chunks;
  const int* __restrict__ nref;
  const int* __restrict__ site;
  const int* __restrict__ order;
  const int* __restrict__ step_end;
  const int* __restrict__ refpfx;
  const int* __restrict__ step_base;
  const int* __restrict__ planes;
  const int* __restrict__ planes_max;
  const int* __restrict__ nS_ck;
  const int* __restrict__ nZ_ck;
  const int* __restrict__ scar_ck;
  const int* __restrict__ zcar_ck;
  const int* __restrict__ elem;
  const int* __restrict__ elen;
  const int* __restrict__ p;
  const int* __restrict__ flat_step;
  const int* __restrict__ flat_ck;
  const bool* __restrict__ valid;
  const int* __restrict__ ch_valid;
  const int* __restrict__ vcar;
  int64_t nframes, T, nwords, cn;  // cn: C * n, a frame's packed elements
  int S, C, L, nchunk, U, NC, KT, K, wsmax;
  int* __restrict__ refstart;
  int4* __restrict__ meta;
  int* __restrict__ head;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d; d >>= 1)
    v = wrap_add(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// A (site, nref) pair as a key that sorts by signed site, then nref.
__device__ __forceinline__ unsigned long long pair_key(int site, int nref) {
  return (unsigned long long)((unsigned)site ^ SIGN) << 32 | (unsigned)nref;
}

// The group's barrier: named barrier `id` (1 + the group's index in its
// block) over its tf threads.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// A group's shared memory, carved from the block's at group_bytes(np).
struct Group {
  unsigned long long* key;  // np (site, nref) keys
  int* scan;                // np: inclusive scan of the nrefs in key order
  int* ref;                 // np: each step's first refinement bit
  int* smin;                // LMAX + 1 layer buckets (LMAX + 4 slots)
  unsigned* seen;           // np / 32: the steps `order` named
  int* wtot;                // 8: the warps' scan totals
  int* flag;                // [0]: sort the frame; [1]: its total bits;
                            // [2]: its one token part, where NC <= tf
};

__host__ __device__ constexpr size_t group_bytes(int np) {
  return ((size_t)16 * np + 4 * (LMAX + 4) + np / 8 + 48 + 15) / 16 * 16;
}

__device__ __forceinline__ Group group_at(unsigned char* base, int np) {
  Group G;
  G.key = (unsigned long long*)base;
  G.scan = (int*)(G.key + np);
  G.ref = G.scan + np;
  G.smin = G.ref + np;
  G.seen = (unsigned*)(G.smin + LMAX + 4);
  G.wtot = (int*)(G.seen + np / 32);
  G.flag = G.wtot + 8;
  return G;
}

// Built with -DDWT_STAMPS (tools/emit_stamps.py), thread 0 of each group
// of the first STAMP_SLOTS / 8 blocks stamps the global timer at the ends
// of the phases, at slot 8 * block + group.
#ifdef DWT_STAMPS
constexpr int STAMP_SLOTS = 1 << 15, STAMP_PHASES = 10;
__device__ unsigned long long g_stamps[STAMP_SLOTS][STAMP_PHASES];
#define STAMP(k)                                                       \
  do {                                                                 \
    if (t == 0 && blockIdx.x * 8 + g < STAMP_SLOTS) {                  \
      unsigned long long t_;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)::"memory"); \
      g_stamps[blockIdx.x * 8 + g][k] = t_;                            \
    }                                                                  \
  } while (0)
extern "C" int dwt_emit_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

// The kernel at RUN steps (and keys) a thread and UPT units a thread at
// most (the plan's np / tf and ub / tf; dwt_emit_tables picks the least
// instantiation that holds them).  Every load of phase 1 is issued
// unconditionally, at an index clamped into the frame's tables, so that
// the loads of all a thread's steps and units are in flight together.
template <int RUN, int UPT>
__global__ void __launch_bounds__(BLOCK) emit_tables_kernel(
    const __grid_constant__ Args A, const __grid_constant__ Plan P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tf = P.tf, np = P.np, S = A.S;
  const int g = threadIdx.x / tf, t = threadIdx.x % tf;
  const int lane = threadIdx.x & 31, warp = t >> 5, nwarp = tf >> 5;
  const int64_t f = (int64_t)(blockIdx.x / P.bpf) * P.fpb + g;
  const int b = blockIdx.x % P.bpf;
  if (f >= A.nframes) return;  // the whole group: its barrier is its own
  STAMP(0);
  const int bar = 1 + g;
  const Group G = group_at(smem + g * group_bytes(np), np);
  const int64_t fs = f * S, T = A.T, fu = f * A.U;
  const int* off = A.off + f * T;
  // Block 0 of a frame writes its step tables; the units go to the one
  // block of a frame, or to blocks 1 to bpf - 1 of a larger one.
  const bool first = b == 0;
  const int u0 = P.bpf == 1 ? 0 : max(b - 1, 0) * P.ub;
  const int u1 = P.bpf == 1 ? A.U : first ? u0 : min(A.U, u0 + P.ub);

  for (int k = t; k < np / 32; k += tf) G.seen[k] = 0;
  if (first)
    for (int k = t; k <= LMAX; k += tf) G.smin[k] = BIGBIT;
  if (t == 0) G.flag[0] = G.flag[1] = G.flag[2] = 0;
  if (f == 0 && first && t == 0) A.head[0] = 0;  // the pack's order flag
  group_sync(bar, tf);
  STAMP(1);
  const int pm = A.planes_max[f];

  // 1. The thread's steps s = t + j * tf: each one's end, off there plus
  // its refinement prefix, and its schedule position's (site, nref) pair
  // through `order`; its units u = u0 + t + j * tf: their columns and
  // chunk tables.
  int s_end[RUN], s_ref[RUN], s_o[RUN], s_site[RUN], s_nref[RUN],
      s_base[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int64_t s = fs + min(t + j * tf, S - 1);
    s_end[j] = min(max(A.step_end[s], 0), (int)(T - 1));
    s_ref[j] = A.refpfx[s];
    s_o[j] = A.order[s];
    if (first) s_base[j] = min(max(A.step_base[s], 0), (int)(T - 1));
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int src = (unsigned)s_o[j] < (unsigned)S ? s_o[j]
                                                   : min(t + j * tf, S - 1);
    s_ref[j] = wrap_add(off[s_end[j]], s_ref[j]);
    s_site[j] = A.site[fs + src];
    s_nref[j] = A.nref[fs + src];
    if (first) s_base[j] = off[s_base[j]];
  }
  // A frame of at most tf chunk sums (one token part): a sum a thread.
  const bool one_part = A.NC <= tf;
  const int chunk = first && one_part && t < A.NC ? A.chunks[f * A.NC + t]
                                                  : 0;
  const int64_t ulast = fu + max(u1 - 1, 0);
  int u_step[UPT], u_row[UPT], u_len[UPT], u_p[UPT], u_nR[UPT],
      u_rcar[UPT], u_ck[UPT];
  bool u_valid[UPT];
#pragma unroll
  for (int j = 0; j < UPT; ++j) {
    const int64_t i = min(fu + u0 + t + j * tf, ulast);
    u_ck[j] = A.flat_ck[i];
    u_step[j] = A.flat_step[i];
    u_row[j] = (int)((unsigned)A.elem[i] + (unsigned)(f * A.cn));
    u_len[j] = A.elen[i];
    u_p[j] = A.p[i];
    u_valid[j] = A.valid[i];
  }
#pragma unroll
  for (int j = 0; j < UPT; ++j) {
    const int fck = u_ck[j];
    const int k = (fck / PMAX) % A.nchunk;
    const bool live = fck % PMAX < pm;
    const int64_t c = fu + fck;
    const int nR = wrap_sub(wrap_sub(A.ch_valid[k], A.nS_ck[c]), A.nZ_ck[c]);
    const int rc = wrap_sub(wrap_sub(A.vcar[k], A.scar_ck[c]), A.zcar_ck[c]);
    u_nR[j] = live && u_valid[j] ? nR : 0;
    u_rcar[j] = live ? rc : 0;
  }

  // 2. The pairs in schedule order into shared memory, and `order`
  // checked to be a permutation; the nrefs also by step, in G.ref until
  // the first bits, for the bit partials.
  bool unsorted = false;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int i = t + j * tf;
    if (i < S) {
      G.key[i] = pair_key(s_site[j], s_nref[j]);
      const int o = s_o[j];
      if ((unsigned)o < (unsigned)S) {
        const unsigned bit = 1u << (o & 31);
        if (atomicOr(&G.seen[o >> 5], bit) & bit) unsorted = true;
        G.ref[o] = s_nref[j];
      } else {
        unsorted = true;
      }
    }
  }

  STAMP(2);

  // 4 (first part), the frame's first block.  The layer buckets: the
  // least start bit of each layer's steps whose plane is below their
  // channel's.  bits_parts' token parts: a warp two parts a turn, its 32
  // loads a lane issued together; their total.
  if (first) {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int s = t + j * tf;
      const int c = s / (A.L * PMAX), l = (s / PMAX) % A.L, p = s % PMAX;
      if (s < S && p < A.planes[f * A.C + c]) {
        const int layer = (c == 0 ? pm - 2 : pm - 1) - p + l;
        atomicMin(&G.smin[min(max(layer, -1) + 1, LMAX)], s_base[j]);
      }
    }
    // Two token parts a warp a turn: 32 loads a lane in flight; or the
    // one part from the sums loaded above.
    int* parts = A.head + 1 + f * A.K;
    const int* ck = A.chunks + f * A.NC;
    if (one_part) {
      const int v = warp_sum(chunk);
      if (lane == 0) {
        atomicAdd((unsigned*)&G.flag[1], (unsigned)v);
        atomicAdd((unsigned*)&G.flag[2], (unsigned)v);
      }
    }
    for (int j = one_part ? A.KT : warp; j < A.KT; j += 2 * nwarp) {
      int x[2][PART_CHUNKS / 32];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < PART_CHUNKS / 32; ++q)
          x[h][q] = ck[min((j + h * nwarp) * PART_CHUNKS + q * 32 + lane,
                           A.NC - 1)];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jh = j + h * nwarp;
        int v = 0;
#pragma unroll
        for (int q = 0; q < PART_CHUNKS / 32; ++q)
          if (jh * PART_CHUNKS + q * 32 + lane < A.NC)
            v = wrap_add(v, x[h][q]);
        v = warp_sum(v);
        if (lane == 0 && jh < A.KT) {
          parts[jh] = v;
          atomicAdd((unsigned*)&G.flag[1], (unsigned)v);
        }
      }
    }
  }

  STAMP(3);

  // 2 (cont.).  A permutation whose sites never decrease (one vote a warp)
  // is already sorted: the scan needs no sort.
  group_sync(bar, tf);
  for (int i = t + (t == 0 ? tf : 0); i < S; i += tf)
    unsorted |= (G.key[i - 1] >> 32) > (G.key[i] >> 32);
  if (__any_sync(FULL, unsorted) && lane == 0) G.flag[0] = 1;
  group_sync(bar, tf);
  STAMP(4);

  // 4 (cont.).  bits_parts' refinement parts, a thread a part: the nrefs
  // by step from shared memory where `order` was a permutation whose sites
  // never decrease, else from device memory.
  if (first) {
    const bool shared_nref = !G.flag[0];
    if (one_part && t == 0) A.head[1 + f * A.K] = G.flag[2];
    int* parts = A.head + 1 + f * A.K + A.KT;
    for (int j = t; j < A.K - A.KT; j += tf) {
      int v = 0;
#pragma unroll
      for (int q = 0; q < PART_STEPS; ++q) {
        const int s = j * PART_STEPS + q;
        if (s < S) v = wrap_add(v, shared_nref ? G.ref[s] : A.nref[fs + s]);
      }
      parts[j] = v;
      atomicAdd((unsigned*)&G.flag[1], (unsigned)v);
    }
  }
  if (G.flag[0]) {
    // Out of schedule order: the frame's pairs, padded to np with all
    // ones, sorted by the bitonic network (thread q of a stage exchanges
    // (i, i + j), i being q with a zero bit inserted at j, ascending where
    // bit k of i is 0).
    for (int i = t; i < np; i += tf)
      G.key[i] = i < S ? pair_key(A.site[fs + i], A.nref[fs + i]) : ~0ull;
    group_sync(bar, tf);
    for (int k = 2; k <= np; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = t; q < np / 2; q += tf) {
          const int i = 2 * q - (q & (j - 1));
          const unsigned long long x = G.key[i], y = G.key[i + j];
          if ((x > y) == ((i & k) == 0)) {
            G.key[i] = y;
            G.key[i + j] = x;
          }
        }
        group_sync(bar, tf);
      }
    }
  }

  STAMP(5);

  // 3. The inclusive scan of the nrefs in key order: thread t's run is
  // keys [t * R, t * R + R), R = np / tf <= RUN (1 where a larger frame's
  // block has more threads than keys).
  const int R = max(np / tf, 1);
  int v[RUN], run = 0;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int i = t * R + j;
    v[j] = j < R && i < S ? (int)(unsigned)G.key[i] : 0;
    run = wrap_add(run, v[j]);
  }
  int x = run;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x = wrap_add(x, y);
  }
  if (lane == 31) G.wtot[warp] = x;
  group_sync(bar, tf);
  int acc = wrap_sub(x, run);
  for (int w = 0; w < warp; ++w) acc = wrap_add(acc, G.wtot[w]);
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    if (j < R && t * R + j < np) {
      acc = wrap_add(acc, v[j]);
      G.scan[t * R + j] = acc;
    }
  }
  group_sync(bar, tf);

  // Each step's first refinement bit: inj_le_end is the scan at the last
  // key whose site is at most the step's end.
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int s = t + j * tf;
    if (s < S) {
      const unsigned fe = (unsigned)s_end[j] ^ SIGN;
      int lo = 0, hi = S;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((unsigned)(G.key[mid] >> 32) <= fe) lo = mid + 1;
        else hi = mid;
      }
      const int r = wrap_sub(s_ref[j], lo ? G.scan[lo - 1] : 0);
      G.ref[s] = r;
      if (first) A.refstart[fs + s] = r;
    }
  }
  group_sync(bar, tf);
  STAMP(6);

  // 4 (second part). The layer ends: ends[k] is the least bucket after
  // k, a suffix minimum over the LMAX buckets 1..LMAX by warp 0 (lane l
  // holds buckets 2l + 1 and 2l + 2), capped by the frame's total.
  if (first && warp == 0) {
    const int a = G.smin[2 * lane + 1], c = G.smin[2 * lane + 2];
    int m = min(a, c);
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_down_sync(FULL, m, d);
      if (lane + d < 32) m = min(m, y);
    }
    int next = __shfl_down_sync(FULL, m, 1);
    if (lane == 31) next = BIGBIT;
    int* ends = A.head + 1 + A.nframes * A.K + f * LMAX;
    const int tot = G.flag[1];
    ends[2 * lane] = min(m, tot);
    ends[2 * lane + 1] = min(min(c, next), tot);
  }
  STAMP(7);

  // 5. The meta rows.
#pragma unroll
  for (int j = 0; j < UPT; ++j) {
    const int u = u0 + t + j * tf;
    if (u < u1) {
      const int bit0 = wrap_add(
          G.ref[min((unsigned)u_step[j], (unsigned)(S - 1))], u_rcar[j]);
      const int ws = min(max((bit0 >> 5) & ~127, 0), A.wsmax);
      int4* out = A.meta + 2 * (fu + u);
      out[0] = make_int4(u_row[j] >> SUBB_SHIFT, u_len[j], u_p[j],
                         wrap_add(ws, (int)(f * A.nwords)));
      out[1] = make_int4(wrap_sub(bit0, (int)(32u * (unsigned)ws)), 0,
                         u_nR[j], 0);
    }
  }
  STAMP(8);
}

static bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

extern "C" int dwt_emit_tables(
    const void* off, const void* chunks, const void* nref, const void* site,
    const void* order, const void* step_end, const void* refpfx,
    const void* step_base, const void* planes, const void* planes_max,
    const void* nS_ck, const void* nZ_ck, const void* scar_ck,
    const void* zcar_ck, const void* elem, const void* elen, const void* p,
    const void* flat_step, const void* flat_ck, const void* valid,
    const void* ch_valid, const void* vcar, int64_t nframes, int64_t T,
    int64_t NC, int64_t C, int64_t L, int64_t nchunk, int64_t n,
    int64_t nwords, int64_t wsmax, void* arena, Offsets offsets, Plan plan,
    void* stream) {
  const int64_t S = C * L * PMAX, U = C * nchunk * PMAX;
  if (nframes < 0 || T < 1 || NC < 1 || C < 1 || L < 1 || nchunk < 1
      || n < 0 || S > MAX_STEPS || nwords < 0 || wsmax > 0x7fffffff
      || wsmax < -0x7fffffff || nframes * U >= 0x7fffffff
      || nframes * T >= ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  // The plan: a group holds the frame's keys at MAX_RUN a thread, a block
  // is whole groups, and the blocks of a frame hold its units.
  if (!pow2(plan.np) || plan.np < 64 || plan.np < S || !pow2(plan.tf)
      || plan.tf < 32 || plan.np > MAX_RUN * plan.tf || plan.fpb < 1
      || plan.bpf < 1 || plan.fpb * plan.tf > BLOCK
      || (plan.fpb > 1 && plan.bpf > 1) || plan.ub < 1
      || plan.ub > (plan.np > 4 * plan.tf ? LARGE_UPT : MAX_UPT) * plan.tf
      || (int64_t)plan.ub * (plan.bpf - (plan.bpf > 1)) < U
      || plan.fpb * group_bytes(plan.np) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (nframes == 0) return 0;
  const int64_t blocks = (nframes + plan.fpb - 1) / plan.fpb * plan.bpf;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  Args A;
  A.off = (const int*)off;
  A.chunks = (const int*)chunks;
  A.nref = (const int*)nref;
  A.site = (const int*)site;
  A.order = (const int*)order;
  A.step_end = (const int*)step_end;
  A.refpfx = (const int*)refpfx;
  A.step_base = (const int*)step_base;
  A.planes = (const int*)planes;
  A.planes_max = (const int*)planes_max;
  A.nS_ck = (const int*)nS_ck;
  A.nZ_ck = (const int*)nZ_ck;
  A.scar_ck = (const int*)scar_ck;
  A.zcar_ck = (const int*)zcar_ck;
  A.elem = (const int*)elem;
  A.elen = (const int*)elen;
  A.p = (const int*)p;
  A.flat_step = (const int*)flat_step;
  A.flat_ck = (const int*)flat_ck;
  A.valid = (const bool*)valid;
  A.ch_valid = (const int*)ch_valid;
  A.vcar = (const int*)vcar;
  A.nframes = nframes;
  A.T = T;
  A.nwords = nwords;
  A.cn = C * n;
  A.S = (int)S;
  A.C = (int)C;
  A.L = (int)L;
  A.nchunk = (int)nchunk;
  A.U = (int)U;
  A.NC = (int)NC;
  A.KT = (int)((NC + PART_CHUNKS - 1) / PART_CHUNKS);
  A.K = A.KT + (int)((S + PART_STEPS - 1) / PART_STEPS);
  A.wsmax = (int)wsmax;
  char* base = (char*)arena;
  A.refstart = (int*)(base + offsets.at[O_REFSTART]);
  A.meta = (int4*)(base + offsets.at[O_META]);
  A.head = (int*)(base + offsets.at[O_HEAD]);
  const int run = plan.np / plan.tf, upt = (plan.ub + plan.tf - 1) / plan.tf;
  // (a block of more threads than keys runs a key a thread)
  auto kernel = run > 4 ? emit_tables_kernel<MAX_RUN, LARGE_UPT>
                : upt > 4 ? emit_tables_kernel<4, MAX_UPT>
                          : emit_tables_kernel<4, 4>;
  kernel<<<(unsigned)blocks, plan.fpb * plan.tf,
           plan.fpb * group_bytes(plan.np), (cudaStream_t)stream>>>(A, plan);
  return (int)cudaGetLastError();
}
