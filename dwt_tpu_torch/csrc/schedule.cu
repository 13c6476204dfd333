// Stage 1's level sums, step order and zero-run carry chain (kernel 14).
//
// No TPU kernel to replace: the JAX package computes all of it as XLA in
// dwt_tpu/codec/encoder.py:_stats_from_lin (the level reductions of
// _plane_stats, :273-289; the stable argsort of the schedule keys, :391;
// the carry chain as a lax.scan, :404-414; the token bases) and the unit
// bases of _unit_common (:535-536).  The plain PyTorch version
// (ops/schedule.py:schedule_plain) is about 60 eager launches of level
// sums, the argsort, gathers and scatters.
//
// Input: the plane statistics' chunk tables of N frames of C channels,
// (N, C, nchunk, PMAX) nS_ck, lastS_ck, zup_ck and (N, C, nchunk) z0_ck,
// the (N, C) planes, the (N, C, pix0) root band (rows of unit stride at
// strides root_frame, root_ch), and per level its real element count,
// first chunk and chunk count.  Output: every stats leaf (ops/schedule.py
// OUT_KEYS), each at its byte offset (enum Out) in the wrapper's one
// allocation.
//
// schedule_kernel: one launch of a cluster of K = min(8, C * L) blocks of
// 1,024 threads a frame.
//   1. Level sums.  Block b takes the frame's (c, l) rows [b * CL / K,
//      (b + 1) * CL / K), CL = C * L, and cuts each row's chunks into
//      shares, warps a row in proportion to its chunks (one at least, no
//      more than its chunks), the shares of all its rows taken by its 32
//      warps in turn.  A share is walked by one warp, lane p < PMAX on
//      plane p, so a chunk's planes are one 116-byte read; a chunk's
//      nZ_ck is z0 plus the warp's exclusive shuffle scan of its nS over
//      the planes.  Each share keeps its sums of nS and nZ, the largest
//      lastS, and over the chunks that hold it the count and the sum of
//      (zeros before the chunk in the share + zup).  A warp a row then
//      folds the row's shares in order: the level's nS, nZ and trailZ =
//      nZ - (the folded sum, each share's count times the zeros of the
//      shares before it added), 0 subtracted when the largest lastS is
//      negative, as the plain version's sum over the chunks whose lastS
//      equals the level's (>= 0).  Each share is then walked again for
//      scar_ck and zcar_ck, the level-exclusive cumsums of nS_ck and
//      nZ_ck, from its base.
//   2. The sort, in every block for its own rows' steps, from the planes
//      alone, T lanes a step (T as large as the block's threads allow, up
//      to 32; each lane on every T-th pair, the lanes' sums added by
//      shuffles).  A valid step (p < planes[c]) of layer lambda = pm - 1
//      - [c == 0] - p + l has the key ((lambda + 1) << 16 | (c > 0) << 12
//      | l << 6 | c): valid keys are distinct and order as (lambda, c >
//      0, l, c).  For a pair (c', l') the plane of layer lambda is t = pm
//      - 1 - [c' == 0] + l' - lambda, so the valid steps below the step's
//      key are, summed over the C * L pairs, planes[c'] - clamp(t + 1, 0,
//      planes[c']) of smaller layer, plus 1 where 0 <= t < planes[c'] and
//      (c' > 0, l', c') < (c > 0, l, c).  An invalid step's rank is V (the
//      valid steps) plus the invalid steps before it, a closed form of
//      the planes too.  No compares of keys.  This is
//      torch.argsort(stable=True) of the keys with the invalid ones tied
//      at 2^30.
//   3. Hand-over.  Each block writes its rows' level sums (from the fold)
//      and puts its steps at their ranks straight into block 0's shared
//      memory, a peer's through distributed shared memory, then arrives
//      (release, cluster scope) on block 0's mbarrier and exits after its
//      second walk; block 0 waits on it (acquire).  One cluster barrier at
//      the start orders block 0's barrier's initialisation before the
//      peers' writes.  No level sum or rank passes through device memory.
//   4. Block 0, a step or two a thread: nRef, and the carry chain over
//      runs of consecutive steps in schedule order: a valid step maps
//      carry -> a * carry + b with a in {0, 1} (nRef > 0: (0, 0); nS > 0:
//      (0, trailZ); else (1, nZ)), an invalid one is (1, 0).  Maps compose,
//      so each thread composes its run, one block scan of the maps (and
//      of the steps' chunk counts, for the unit bases) gives each run's
//      carry in, and a walk writes carry_in, refrun_val and refrun_ok and
//      keeps each step's token count.
//   5. A second block scan, of the pair-aligned counts and of the
//      refinement bits, gives the step bases, T, the injection sites (a
//      step's base plus its aligned count: the next base, T - 1 for the
//      last) and the refinement-bit prefixes, written in schedule order
//      and at each step's (c, l, p) slot, and ubase_sched, each step's
//      exclusive sum of its level's chunk count in schedule order (the
//      first unit of kernel A's unit tables, ops/units.py).
// Block 0 also counts the root band (a warp a channel) before its level
// sums.  Sums wrap in 32 bits, as the plain version's int32 sums do.
//
// Bound: neither bytes nor operations.  At 4K the tables in and the
// leaves out are about 0.33 MB (0.1 us at 3.35 TB/s) and the sort about
// 7,000 pair terms; the work is a few dependent phases, each a pass over
// the frame's rows or steps with a barrier between: latency, not
// throughput.  The design cuts the launches to one, spreads the level
// sums and the sort over the cluster's SMs, and keeps the chain to
// log2(1024) + 2 steps deep.  The levels' tables sit in shared memory;
// the chunk tables come through the read-only path, so their loads need
// not wait for the stores between them.
#include "common.cuh"

#include <cooperative_groups.h>
#include <limits.h>

namespace cg = cooperative_groups;

constexpr int PMAX = 29;                 // ops/plane_stats.py
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STEPS = 2048;          // ops/schedule.py
constexpr int MAX_PER = MAX_STEPS / THREADS;
constexpr int MAX_C = 32;
constexpr int MAX_L = 64;                // the key's level field
constexpr int MAX_CLUSTER = 8;
// Rows a block: ceil(C * L / K), C * L <= MAX_STEPS / PMAX = 70.
constexpr int MAX_ROWS = MAX_STEPS / PMAX;
// Shares a block: one or more a row, 32 in proportion, so at most its
// rows plus 32.
constexpr int MAX_TASKS = MAX_ROWS + WARPS;
constexpr unsigned FULL = 0xffffffffu;

// The outputs, in ops/schedule.py's _INT_OUTS + _BOOL_OUTS order.
enum Out {
  O_HEAD, O_ROOT_CNT, O_ROOT_BASE, O_PLANES_BASE, O_CARRY_END, O_NS,
  O_NREF, O_STEP_BASE, O_STEP_END, O_INJ_POS, O_REFPFX, O_CARRY_IN,
  O_REFRUN_VAL, O_ORDER, O_BASE_SCHED, O_NS_SCHED, O_CIN_SCHED,
  O_UBASE_SCHED, O_NZ_CK, O_SCAR, O_ZCAR, O_REFRUN_OK, O_VALID,
  O_VALID_SCHED, O_COUNT
};

// The outputs' byte offsets in the wrapper's allocation, by value.
struct Offsets {
  int64_t at[O_COUNT];
};

struct Args {
  const int* planes;
  const int* nS_ck;
  const int* lastS_ck;
  const int* z0_ck;
  const int* zup_ck;
  const int* root;
  int64_t root_frame, root_ch;
  const int* real;
  const int* lcb;
  const int* lnc;
  int pix0, C, L, nchunk, K;
  int tasks;  // the shares a block holds: its most rows plus WARPS
  int nframes;
  void* out[O_COUNT];
  __device__ int* i(int k) const { return (int*)out[k]; }
  __device__ bool* b(int k) const { return (bool*)out[k]; }
};

// Dynamic shared memory of a block at S steps and ``tasks`` shares: the
// step tables (the level sums nS, nZ, trailZ, the order, the ranks) and
// the shares' partial sums (5) and bases (2).
__host__ __device__ constexpr size_t smem_bytes(int S, int tasks) {
  return (size_t)(5 * S + 7 * tasks * 32) * sizeof(int);
}

// Built with -DDWT_STAMPS (tools/schedule_stamps.py), thread 0 of each of
// the first MAX_CLUSTER blocks (frame 0's cluster first) stamps the
// global timer at the ends of the phases.
#ifdef DWT_STAMPS
__device__ unsigned long long g_stamps[MAX_CLUSTER][16];
#define STAMP(k)                                                       \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < MAX_CLUSTER) {                \
      unsigned long long t_;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));           \
      g_stamps[blockIdx.x][k] = t_;                                    \
    }                                                                  \
  } while (0)
extern "C" int dwt_schedule_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

// The cluster barrier's arrival orders nothing but block 0's mbarrier
// initialisation, which its own fence publishes: relaxed, so that it
// does not wait for the block's earlier stores as a release would.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Three scanned words: (a, b) a carry map or two sums, c a sum.
struct Tri {
  unsigned a, b, c;
};

// op(e, x): the earlier e followed by x.  MapSum composes carry maps
// carry -> a ? carry + b : b in (a, b) and adds c; Sum adds all three.
struct MapSum {
  __device__ Tri operator()(const Tri& e, const Tri& x) const {
    return {e.a & x.a, x.a ? e.b + x.b : x.b, e.c + x.c};
  }
};
struct Sum {
  __device__ Tri operator()(const Tri& e, const Tri& x) const {
    return {e.a + x.a, e.b + x.b, e.c + x.c};
  }
};

__device__ __forceinline__ Tri shfl_up(const Tri& x, int d) {
  return {__shfl_up_sync(FULL, x.a, d), __shfl_up_sync(FULL, x.b, d),
          __shfl_up_sync(FULL, x.c, d)};
}

// Block-wide exclusive scan of each thread's x in thread order, from the
// identity id; total gets the block's sum.  Every thread calls it; it ends
// behind a barrier.
template <class Op>
__device__ __forceinline__ Tri block_scan(Tri x, Op op, Tri id, Tri* s_w,
                                          Tri& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  Tri v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Tri o = shfl_up(v, d);
    if (lane >= d) v = op(o, v);
  }
  Tri e = shfl_up(v, 1);
  if (lane == 0) e = id;
  if (lane == 31) s_w[w] = v;
  __syncthreads();
  if (w == 0) {
    Tri y = s_w[lane];  // WARPS == 32
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Tri o = shfl_up(y, d);
      if (lane >= d) y = op(o, y);
    }
    Tri p = shfl_up(y, 1);
    if (lane == 0) p = id;
    __syncwarp();
    s_w[lane] = p;
    if (lane == 31) s_w[WARPS] = y;
  }
  __syncthreads();
  const Tri out = op(s_w[w], e);
  total = s_w[WARPS];
  __syncthreads();
  return out;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(THREADS, 1)
    schedule_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) int sm[];
  __shared__ int s_planes[MAX_C], s_vbefore[MAX_C];
  __shared__ int s_rcnt[MAX_C], s_rtok[MAX_C];
  __shared__ int s_trow[MAX_TASKS], s_tshare[MAX_TASKS];
  __shared__ int s_rW[MAX_ROWS], s_rt0[MAX_ROWS], s_pair[MAX_ROWS];
  __shared__ int s_lcb[MAX_L], s_lnc[MAX_L], s_real[MAX_L];
  __shared__ int s_pm, s_V, s_base0, s_ntask;
  __shared__ Tri s_w[WARPS + 1];
  __shared__ __align__(8) unsigned long long s_bar;  // block 0's: the peers'

  cg::cluster_group cl = cg::this_cluster();
  const int K = A.K, rank = (int)cl.block_rank();
  const int f = blockIdx.x / K;
  const int C = A.C, L = A.L, CL = C * L, S = CL * PMAX;
  const int nchunk = A.nchunk;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t fs = (int64_t)f * S;
  // Block 0's step tables: the level sums at each step's (c, l, p) index
  // (each block writes its rows') and the order (each block puts its
  // steps at their ranks).  A block's own ranks, at its steps' indices.
  int* s_nS = sm;
  int* s_nZ = sm + S;
  int* s_tz = sm + 2 * S;
  int* s_ord = sm + 3 * S;
  int* s_rank = sm + 4 * S;
  const int TS = A.tasks * 32;  // a component of the shares' tables
  unsigned* s_part = (unsigned*)(sm + 5 * S);  // [5][tasks][32]
  unsigned* s_sb = s_part + 5 * TS;  // [2][tasks][32]
  const int r0 = rank * CL / K, r1 = (rank + 1) * CL / K;
  STAMP(0);

  if (rank == 0 && tid == 0 && K > 1) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(&s_bar)), "r"(K - 1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Warp 0: the shares of this block's rows, a row a lane.
  if (w == 0) {
    const int nr = r1 - r0;
    int64_t Wb = 0;
    for (int j = lane; j < nr; j += 32) Wb += __ldg(A.lnc + (r0 + j) % L);
    for (int d = 16; d; d >>= 1) Wb += __shfl_xor_sync(FULL, Wb, d);
    int t = 0;  // the shares of the rows before this round's
    for (int j0 = 0; j0 < nr; j0 += 32) {
      const int j = j0 + lane;
      int W = 0;
      if (j < nr) {
        const int kn = __ldg(A.lnc + (r0 + j) % L);
        W = Wb > 0 ? (int)(WARPS * (int64_t)kn / Wb) : 1;
        W = max(1, min(W, kn));
      }
      int incl = W;
      for (int d = 1; d < 32; d <<= 1) {
        const int q = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += q;
      }
      if (j < nr) {
        const int t0 = t + incl - W;
        s_rW[j] = W;
        s_rt0[j] = t0;
        for (int k = 0; k < W; ++k) {
          s_trow[t0 + k] = j;
          s_tshare[t0 + k] = k;
        }
      }
      t += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) s_ntask = t;
  }
  // Warp 1: the planes (clamped to the step grid), planes_max, the valid
  // steps before each channel's and in all.  Warp 2: the levels' tables
  // and the (c', l') pairs of the sort.
  if (w == 1) {
    const int pl = lane < C ? __ldg(A.planes + (int64_t)f * C + lane)
                            : INT_MIN;
    const int pc = lane < C ? min(max(pl, 0), PMAX) : 0;
    int mx = pl;
    for (int d = 16; d; d >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, d));
    int incl = pc;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane < C) {
      s_planes[lane] = pc;
      s_vbefore[lane] = L * (incl - pc);
    }
    if (lane == 31) s_V = L * incl;
    if (lane == 0) s_pm = mx;
  }
  if (w == 2) {
    for (int l = lane; l < L; l += 32) {
      s_lcb[l] = __ldg(A.lcb + l);
      s_lnc[l] = __ldg(A.lnc + l);
      s_real[l] = __ldg(A.real + l);
    }
    for (int q = lane; q < CL; q += 32) s_pair[q] = (q / L) << 8 | q % L;
  }
  __syncthreads();
  STAMP(1);
  // Block 0's barrier is ready: the peers may write into its shared
  // memory once this barrier phase completes.
  cluster_arrive_relaxed();

  if (rank == 0) {
    // The root band's counts, a warp a channel.
    const int pix0 = A.pix0;
    for (int c = w; c < C; c += WARPS) {
      const int* rp = A.root + f * A.root_frame + c * A.root_ch;
      int mx = INT_MIN;
      unsigned nnz = 0;
      for (int i = lane; i < pix0; i += 32) {
        const int x = __ldg(rp + i);
        mx = max(mx, (int)(x < 0 ? 0u - (unsigned)x : (unsigned)x));
        nnz += x != 0;
      }
      for (int d = 16; d; d >>= 1) {
        mx = max(mx, __shfl_xor_sync(FULL, mx, d));
        nnz += __shfl_xor_sync(FULL, nnz, d);
      }
      if (lane == 0) {
        const int cnt = mx > 0 ? 32 - __clz(mx) : 0;  // 1 + ilog2
        s_rcnt[c] = cnt;
        s_rtok[c] = (int)(1u + (cnt > 0 ? (unsigned)pix0 + nnz : 0u));
      }
    }
  }
  // 2. The sort in closed form: each block ranks its own rows' steps, T
  // lanes a step (as many as the block's threads allow, up to 32), each
  // lane on every T-th (c', l') pair, the lanes' sums added by shuffles.
  {
    const int n0 = r0 * PMAX, ns = (r1 - r0) * PMAX;
    int T = 1;
    while (T < 32 && 2 * T * ns <= THREADS) T <<= 1;
    const int pm = s_pm, V = s_V, LP = L * PMAX, sub = lane & (T - 1);
    for (int k0 = w * (32 / T); k0 < ns; k0 += THREADS / T) {
      const int k = k0 + lane / T;
      const int i = n0 + min(k, ns - 1);
      const int c = i / LP, l = (i / PMAX) % L, p = i % PMAX;
      const int Pc = s_planes[c];
      const bool v = p < Pc;
      int part = 0;
      if (v && k < ns) {
        const int lam = pm - 1 - (c == 0) - p + l;
        const int sec = c > 0;
        for (int q = sub; q < CL; q += T) {
          const int c2 = s_pair[q] >> 8, l2 = s_pair[q] & 255;
          const int P2 = s_planes[c2], sec2 = c2 > 0;
          const int t = pm - 1 - (c2 == 0) + l2 - lam;
          const bool less = sec2 != sec ? sec2 < sec
                                        : (l2 != l ? l2 < l : c2 < c);
          part += P2 - min(max(t + 1, 0), P2);
          part += (t >= 0) & (t < P2) & less;
        }
      }
      for (int d = T >> 1; d; d >>= 1) part += __shfl_xor_sync(FULL, part, d);
      if (sub == 0 && k < ns) {
        s_rank[i] = v ? part : V + i - (s_vbefore[c] + l * Pc + min(p, Pc));
        A.b(O_VALID)[fs + i] = v;
      }
    }
  }

  STAMP(2);
  // 1. The level sums: each share's walk.
  const int ntask = s_ntask;
  const bool on = lane < PMAX;
  for (int t = w; t < ntask; t += WARPS) {
    const int j = s_trow[t], W = s_rW[j], sh = s_tshare[t];
    const int r = r0 + j, l = r % L;
    const int64_t crow = ((int64_t)f * C + r / L) * nchunk;
    const int kb = s_lcb[l], kn = s_lnc[l];
    const int k0 = kb + (int)((int64_t)kn * sh / W);
    const int k1 = kb + (int)((int64_t)kn * (sh + 1) / W);
    int* nZ_ck = A.i(O_NZ_CK);
    unsigned sS = 0, sZ = 0, acc = 0, cnt = 0, zloc = 0;
    int m = INT_MIN;
    // The inputs come through the read-only path, their loads free of the
    // stores of nZ_ck, each chunk's four words a turn ahead.
    int s1 = 0, ls1 = INT_MIN;
    unsigned zu1 = 0u, z01 = 0u;
    if (k0 < k1) {
      const int64_t e = (crow + k0) * PMAX + lane;
      s1 = on ? __ldg(A.nS_ck + e) : 0;
      ls1 = on ? __ldg(A.lastS_ck + e) : INT_MIN;
      zu1 = on ? (unsigned)__ldg(A.zup_ck + e) : 0u;
      z01 = (unsigned)__ldg(A.z0_ck + crow + k0);
    }
    for (int k = k0; k < k1; ++k) {
      const int64_t e = (crow + k) * PMAX + lane;
      const int s = s1, ls = ls1;
      const unsigned zu = zu1, z0 = z01;
      if (k + 1 < k1) {
        const int64_t en = e + PMAX;
        s1 = on ? __ldg(A.nS_ck + en) : 0;
        ls1 = on ? __ldg(A.lastS_ck + en) : INT_MIN;
        zu1 = on ? (unsigned)__ldg(A.zup_ck + en) : 0u;
        z01 = (unsigned)__ldg(A.z0_ck + crow + k + 1);
      }
      unsigned incl = (unsigned)s;
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned q = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += q;
      }
      const unsigned nz = z0 + incl - (unsigned)s;
      if (on) {
        nZ_ck[e] = (int)nz;
        const unsigned val = zloc + zu;
        if (ls > m) {
          m = ls;
          acc = val;
          cnt = 1;
        } else if (ls == m) {
          acc += val;
          cnt += 1;
        }
        sS += (unsigned)s;
        sZ += nz;
        zloc += nz;
      }
    }
    unsigned* q = s_part + t * 32 + lane;
    q[0] = sS;
    q[TS] = sZ;
    q[2 * TS] = (unsigned)m;
    q[3 * TS] = acc;
    q[4 * TS] = cnt;
  }
  __syncthreads();
  // 3. Hand-over: this block writes its level sums and puts its steps at
  // their ranks straight into block 0's shared memory (a peer's through
  // distributed shared memory, once block 0's barrier is ready).
  STAMP(3);
  cluster_wait();
  STAMP(4);
  int* dst = rank == 0 ? sm : cl.map_shared_rank(sm, 0);
  // The fold, a warp a row.
  for (int j = w; j < r1 - r0; j += WARPS) {
    if (on) {
      const int t0 = s_rt0[j], W = s_rW[j];
      unsigned Sb = 0, Zb = 0, ACC = 0;
      int M = INT_MIN;
      for (int t = t0; t < t0 + W; ++t) {
        const unsigned* q = s_part + t * 32 + lane;
        s_sb[t * 32 + lane] = Sb;
        s_sb[TS + t * 32 + lane] = Zb;
        const int mj = (int)q[2 * TS];
        const unsigned aj = q[3 * TS] + q[4 * TS] * Zb;
        if (mj > M) {
          M = mj;
          ACC = aj;
        } else if (mj == M) {
          ACC += aj;
        }
        Sb += q[0];
        Zb += q[TS];
      }
      const int i = (r0 + j) * PMAX + lane;  // the step's (c, l, p) index
      dst[i] = (int)Sb;
      dst[S + i] = (int)Zb;
      dst[2 * S + i] = (int)(Zb - (M >= 0 ? ACC : 0u));
      A.i(O_NS)[fs + i] = (int)Sb;
    }
  }
  for (int i = r0 * PMAX + tid; i < r1 * PMAX; i += THREADS)
    dst[3 * S + s_rank[i]] = i;
  if (rank > 0) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  __syncthreads();
  STAMP(5);
  if (rank > 0 && tid == 0) {
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(smem_addr(&s_bar)), "r"(0));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
                 "[%0];" :: "r"(remote) : "memory");
  }
  // The second walk of each share: scar_ck and zcar_ck, each chunk's
  // nZ_ck made again by the shuffle scan (not read back).
  {
    int* scar = A.i(O_SCAR);
    int* zcar = A.i(O_ZCAR);
    for (int t = w; t < ntask; t += WARPS) {
      const int j = s_trow[t], W = s_rW[j], sh = s_tshare[t];
      const int r = r0 + j, l = r % L;
      const int64_t crow = ((int64_t)f * C + r / L) * nchunk;
      const int kb = s_lcb[l], kn = s_lnc[l];
      const int k0 = kb + (int)((int64_t)kn * sh / W);
      const int k1 = kb + (int)((int64_t)kn * (sh + 1) / W);
      unsigned sc = on ? s_sb[t * 32 + lane] : 0u;
      unsigned zc = on ? s_sb[TS + t * 32 + lane] : 0u;
      int s1 = 0;
      unsigned z01 = 0u;
      if (k0 < k1) {
        s1 = on ? __ldg(A.nS_ck + (crow + k0) * PMAX + lane) : 0;
        z01 = (unsigned)__ldg(A.z0_ck + crow + k0);
      }
      for (int k = k0; k < k1; ++k) {
        const int64_t e = (crow + k) * PMAX + lane;
        const int s = s1;
        const unsigned z0 = z01;
        if (k + 1 < k1) {
          s1 = on ? __ldg(A.nS_ck + e + PMAX) : 0;
          z01 = (unsigned)__ldg(A.z0_ck + crow + k + 1);
        }
        unsigned incl = (unsigned)s;
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned q = __shfl_up_sync(FULL, incl, d);
          if (lane >= d) incl += q;
        }
        if (on) {
          scar[e] = (int)sc;
          zcar[e] = (int)zc;
        }
        sc += (unsigned)s;
        zc += z0 + incl - (unsigned)s;
      }
    }
  }
  STAMP(6);
  if (rank > 0) return;

  // Block 0: every peer's writes have landed.
  if (K > 1) {
    unsigned done;
    do {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], 0;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(smem_addr(&s_bar)) : "memory");
    } while (!done);
  }
  __syncthreads();
  STAMP(7);
  // The root band's totals.
  if (tid == 0) {
    unsigned base = 0;
    for (int c = 0; c < C; ++c) {
      A.i(O_ROOT_CNT)[(int64_t)f * C + c] = s_rcnt[c];
      A.i(O_ROOT_BASE)[(int64_t)f * C + c] = (int)base;
      base += (unsigned)s_rtok[c];
    }
    A.i(O_PLANES_BASE)[f] = (int)base;
    const int b0 = (int)(base + (unsigned)C);
    s_base0 = (b0 + 1) / 2 * 2;
  }

  // 4. The carry chain and the unit bases over each thread's run; nRef
  // of each step as the run reaches it.
  const int pm = s_pm, V = s_V;
  const int per = (S + THREADS - 1) / THREADS;
  const int s0 = min(tid * per, S), s1 = min(s0 + per, S);
  int nref[MAX_PER];
  Tri x = {1u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = s0 + j;
    nref[j] = 0;
    if (s < s1) {
      const int i = s_ord[s], l = (i / PMAX) % L;
      const int nS = s_nS[i];
      nref[j] = i % PMAX < pm ? (int)((unsigned)s_real[l]
                                      - (unsigned)s_nZ[i] - (unsigned)nS)
                              : 0;
      Tri y = {1u, 0u, (unsigned)s_lnc[l]};
      if (s < V) {
        if (nref[j] > 0) {
          y.a = 0;
        } else if (nS > 0) {
          y.a = 0;
          y.b = (unsigned)s_tz[i];
        } else {
          y.b = (unsigned)s_nZ[i];
        }
      }
      x = MapSum()(x, y);
    }
  }
  Tri tot;
  const Tri pre = block_scan(x, MapSum(), Tri{1u, 0u, 0u}, s_w, tot);
  STAMP(8);
  const unsigned carry0 = pm == 0 ? (unsigned)s_real[0] : 0u;
  unsigned carry = pre.a ? carry0 + pre.b : pre.b;
  int cnt[MAX_PER];
  Tri sums = {0u, 0u, 0u};  // aligned counts, refinement bits
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = s0 + j;
    cnt[j] = 0;
    if (s < s1) {
      const int i = s_ord[s];
      const bool v = s < V;
      const int nS = s_nS[i], nRef = nref[j];
      const unsigned rv = nS > 0 ? (unsigned)s_tz[i]
                                 : carry + (unsigned)s_nZ[i];
      const bool rro = v && nRef > 0 && (int)rv > 0;
      A.i(O_NREF)[fs + i] = nRef;
      A.i(O_CARRY_IN)[fs + i] = (int)carry;
      A.i(O_REFRUN_VAL)[fs + i] = (int)rv;
      A.b(O_REFRUN_OK)[fs + i] = rro;
      A.i(O_CIN_SCHED)[fs + s] = (int)carry;
      if (v) carry = nRef > 0 ? 0u : rv;
      const int cs = v ? 2 * nS + (int)rro : 0;
      cnt[j] = cs;
      sums.a += (unsigned)((cs + 1) / 2 * 2);
      sums.b += v ? (unsigned)nRef : 0u;
    }
  }

  // 5. Bases, T, injection sites, refinement-bit prefixes, unit bases.
  Tri ttot;
  const Tri pb = block_scan(sums, Sum(), Tri{0u, 0u, 0u}, s_w, ttot);
  STAMP(9);
  unsigned base = (unsigned)s_base0 + pb.a, pref = pb.b, ub = pre.c;
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = s0 + j;
    if (s < s1) {
      const int i = s_ord[s];
      const bool v = s < V;
      const int cs = cnt[j];
      const unsigned al = (unsigned)((cs + 1) / 2 * 2);
      A.i(O_STEP_BASE)[fs + i] = (int)base;
      A.i(O_STEP_END)[fs + i] = (int)(base + (unsigned)cs);
      A.i(O_INJ_POS)[fs + i] = (int)(base + al);
      A.i(O_REFPFX)[fs + i] = (int)pref;
      A.i(O_ORDER)[fs + s] = i;
      A.i(O_BASE_SCHED)[fs + s] = (int)base;
      A.i(O_NS_SCHED)[fs + s] = v ? s_nS[i] : 0;
      A.i(O_UBASE_SCHED)[fs + s] = (int)ub;
      A.b(O_VALID_SCHED)[fs + s] = v;
      base += al;
      if (v) pref += (unsigned)nref[j];
      ub += (unsigned)s_lnc[(i / PMAX) % L];
    }
  }
  if (tid == 0) {
    A.i(O_HEAD)[f] = pm;
    A.i(O_HEAD)[A.nframes + f] = (int)((unsigned)s_base0 + ttot.a + 1u);
    A.i(O_CARRY_END)[f] = (int)(tot.a ? carry0 + tot.b : tot.b);
  }
  STAMP(10);
}

extern "C" int dwt_schedule(
    const void* planes, const void* nS_ck, const void* lastS_ck,
    const void* z0_ck, const void* zup_ck, const void* root,
    int64_t root_frame, int64_t root_ch, int64_t pix0, const void* real,
    const void* lcb, const void* lnc, int64_t nframes, int64_t C, int64_t L,
    int64_t nchunk, void* arena, Offsets offsets, void* stream) {
  if (nframes < 0 || C < 1 || C > MAX_C || L < 1 || L > MAX_L || nchunk < 1
      || pix0 < 1 || pix0 > 0x7fffffff || C * L * PMAX > MAX_STEPS
      || nchunk > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (nframes == 0) return 0;
  const int K = (int)(C * L < MAX_CLUSTER ? C * L : MAX_CLUSTER);
  if (nframes * K > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  // The shared memory past 48 KB, once a device.
  static bool ready[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(schedule_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(MAX_STEPS, MAX_TASKS));
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  Args A;
  A.planes = (const int*)planes;
  A.nS_ck = (const int*)nS_ck;
  A.lastS_ck = (const int*)lastS_ck;
  A.z0_ck = (const int*)z0_ck;
  A.zup_ck = (const int*)zup_ck;
  A.root = (const int*)root;
  A.root_frame = root_frame;
  A.root_ch = root_ch;
  A.real = (const int*)real;
  A.lcb = (const int*)lcb;
  A.lnc = (const int*)lnc;
  A.pix0 = (int)pix0;
  A.C = (int)C;
  A.L = (int)L;
  A.nchunk = (int)nchunk;
  A.K = K;
  A.tasks = (int)((C * L + K - 1) / K) + WARPS;
  A.nframes = (int)nframes;
  for (int k = 0; k < O_COUNT; ++k)
    A.out[k] = (char*)arena + offsets.at[k];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nframes * K));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes((int)(C * L * PMAX), A.tasks);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, schedule_kernel, A);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
