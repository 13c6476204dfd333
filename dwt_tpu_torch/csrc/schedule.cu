// Stage 1's level sums, step order and zero-run carry chain (kernel 14).
//
// No TPU kernel to replace: the JAX package computes all of it as XLA in
// dwt_tpu/codec/encoder.py:_stats_from_lin (the level reductions of
// _plane_stats, :273-289; the stable argsort of the schedule keys, :391;
// the carry chain as a lax.scan, :404-414; the token bases).  The plain
// PyTorch version (ops/schedule.py:schedule_plain) is about 60 eager
// launches of level sums, the argsort, gathers and scatters; before this
// kernel the encoder walked the chain in Python on the host, between a
// device-to-host and a host-to-device copy.
//
// Input: the plane statistics' chunk tables of N frames of C channels,
// (N, C, nchunk, PMAX) nS_ck, lastS_ck, zup_ck and (N, C, nchunk) z0_ck,
// the (N, C) planes, the (N, C, pix0) root band (rows of unit stride at
// strides root_frame, root_ch), and per level its real element count,
// first chunk and chunk count.  Output: every stats leaf (ops/schedule.py
// OUT_KEYS), at the pointers of enum Out.
//
// level_sums_kernel, a block a (frame, channel, level) of W warps: warp w
// walks a contiguous share of the level's chunks, lane p < PMAX on plane
// p, so a chunk's planes are one 116-byte read.  A chunk's nZ_ck is z0 plus
// the warp's exclusive shuffle scan of its nS over the planes.  Each warp
// keeps its share's sums of nS and nZ, the largest lastS, and over the
// chunks that hold it the count and the sum of (zeros before the chunk in
// the share + zup).  Warp 0 then folds the shares in order: the level's
// nS, nZ and trailZ = nZ - (the folded sum, each share's count times the
// zeros of the shares before it added), 0 subtracted when the largest
// lastS is negative, as the plain version's sum over the chunks whose
// lastS equals the level's (>= 0).  Each warp then walks its share again
// and writes scar_ck and zcar_ck, the level-exclusive cumsums of nS_ck and
// nZ_ck, from its share's base.
//
// schedule_kernel, a block a frame of 256 threads, after it on the same
// stream.  The frame's S = C * L * PMAX steps sit in shared memory (7
// int32 tables of S); thread t owns the steps [t * per, (t + 1) * per),
// per = ceil(S / 256) <= 8, and each pass below is a walk of those runs
// with a block-wide exclusive scan (shuffles, then a warp over the warps'
// totals) between walks:
//   1. the root band: a warp a channel reduces max |x| and the nonzeros;
//      root counts, bases and planes_base.
//   2. nRef, validity (p < planes[c]) and the schedule key of each step;
//      a scan of the valid flags gives each valid step its place in a
//      compacted list and each invalid step its rank, V + (invalid steps
//      before it).
//   3. the sort: a valid step's rank is the count of valid keys below
//      its own (valid keys are distinct; equal keys would rank by index),
//      V^2 compares out of shared memory, not S^2; ranks give order.  This
//      is torch.argsort(stable=True) of the keys with the invalid ones
//      tied at 2^30.
//   4. the carry chain: a valid step maps carry -> a * carry + b with a
//      in {0, 1} (nRef > 0: (0, 0); nS > 0: (0, trailZ); else (1, nZ)),
//      an invalid one is (1, 0).  Maps compose, so each thread composes
//      its run, a scan of the maps gives each run's carry in, and a
//      second walk writes carry_in, refrun_val and refrun_ok and keeps
//      each step's token count.
//   5. a scan of the pair-aligned counts and of the refinement bits gives
//      the step bases, T, the injection sites (a step's base plus its
//      aligned count: the next base, T - 1 for the last) and the
//      refinement-bit prefixes, written in schedule order and at each
//      step's (c, l, p) slot.
// Sums wrap in 32 bits, as the plain version's int32 sums do.
//
// Bound: neither bytes nor operations.  At 4K the tables in and the
// leaves out are about 0.45 MB (0.14 us at 3.35 TB/s); the work is a few
// dependent phases, each a pass over S <= 2,048 steps out of shared memory
// with a barrier between: latency, not throughput.  The chain's depth is
// S steps sequentially; the scan makes it log2(256) + per steps.
#include "common.cuh"

#include <limits.h>

constexpr int PMAX = 29;                 // ops/plane_stats.py
constexpr int SCHED_THREADS = 256;
constexpr int SCHED_WARPS = SCHED_THREADS / 32;
constexpr int MAX_STEPS = 2048;          // ops/schedule.py
constexpr int MAX_PER = MAX_STEPS / SCHED_THREADS;
constexpr int MAX_C = 32;
constexpr int MAX_WARPS = 32;
constexpr int SCHED_TABLES = 7;          // shared int32 tables of S
constexpr unsigned FULL = 0xffffffffu;

// The output pointers, in ops/schedule.py's _INT_OUTS + _BOOL_OUTS order.
enum Out {
  O_HEAD, O_ROOT_CNT, O_ROOT_BASE, O_PLANES_BASE, O_CARRY_END, O_NS,
  O_NREF, O_STEP_BASE, O_STEP_END, O_INJ_POS, O_REFPFX, O_CARRY_IN,
  O_REFRUN_VAL, O_ORDER, O_BASE_SCHED, O_NS_SCHED, O_CIN_SCHED, O_NZ_LV,
  O_TZ_LV, O_NZ_CK, O_SCAR, O_ZCAR, O_REFRUN_OK, O_VALID, O_VALID_SCHED,
  O_COUNT
};

struct Outs {
  void* p[O_COUNT];
  __device__ int* i(int k) const { return (int*)p[k]; }
  __device__ bool* b(int k) const { return (bool*)p[k]; }
};

__global__ void level_sums_kernel(
    const int* __restrict__ nS_ck, const int* __restrict__ lastS_ck,
    const int* __restrict__ z0_ck, const int* __restrict__ zup_ck,
    const int* __restrict__ lcb, const int* __restrict__ lnc, int L,
    int nchunk, Outs o) {
  __shared__ unsigned s_part[5][MAX_WARPS][32];
  __shared__ unsigned s_base[2][MAX_WARPS][32];
  const int64_t rl = blockIdx.x;  // (frame * C + c) * L + l
  const int l = (int)(rl % L);
  const int64_t r = rl / L;       // the (frame, channel) row
  const int W = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool on = lane < PMAX;
  const int kb = lcb[l], kn = lnc[l];
  const int k0 = kb + (int)((int64_t)kn * w / W);
  const int k1 = kb + (int)((int64_t)kn * (w + 1) / W);
  int* nZ_ck = o.i(O_NZ_CK);

  unsigned sS = 0, sZ = 0, acc = 0, cnt = 0, zloc = 0;
  int m = INT_MIN;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int64_t row = r * nchunk + k;
    const int64_t e = row * PMAX + lane;
    const int s = on ? nS_ck[e] : 0;
    const int ls = on ? lastS_ck[e] : INT_MIN;
    const unsigned zu = on ? (unsigned)zup_ck[e] : 0u;
    const unsigned z0 = (unsigned)z0_ck[row];
    unsigned incl = (unsigned)s;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += t;
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
  s_part[0][w][lane] = sS;
  s_part[1][w][lane] = sZ;
  s_part[2][w][lane] = (unsigned)m;
  s_part[3][w][lane] = acc;
  s_part[4][w][lane] = cnt;
  __syncthreads();
  if (w == 0 && on) {
    unsigned Sb = 0, Zb = 0, ACC = 0;
    int M = INT_MIN;
    for (int j = 0; j < W; ++j) {
      s_base[0][j][lane] = Sb;
      s_base[1][j][lane] = Zb;
      const int mj = (int)s_part[2][j][lane];
      const unsigned aj = s_part[3][j][lane] + s_part[4][j][lane] * Zb;
      if (mj > M) {
        M = mj;
        ACC = aj;
      } else if (mj == M) {
        ACC += aj;
      }
      Sb += s_part[0][j][lane];
      Zb += s_part[1][j][lane];
    }
    const int64_t at = rl * PMAX + lane;  // (frame, c, l, p)
    o.i(O_NS)[at] = (int)Sb;
    o.i(O_NZ_LV)[at] = (int)Zb;
    o.i(O_TZ_LV)[at] = (int)(Zb - (M >= 0 ? ACC : 0u));
  }
  __syncthreads();
  if (on) {
    unsigned sc = s_base[0][w][lane], zc = s_base[1][w][lane];
    int* scar = o.i(O_SCAR);
    int* zcar = o.i(O_ZCAR);
    for (int k = k0; k < k1; ++k) {
      const int64_t e = (r * nchunk + k) * PMAX + lane;
      scar[e] = (int)sc;
      zcar[e] = (int)zc;
      sc += (unsigned)nS_ck[e];
      zc += (unsigned)nZ_ck[e];
    }
  }
}

// (a, b) pairs under a scan: Sum adds both; Map composes carry maps
// carry -> a ? carry + b : b (a in {0, 1}).  op(ea, eb, a, b) makes (a, b)
// the earlier pair (ea, eb) followed by (a, b).
struct Sum {
  __device__ void operator()(unsigned ea, unsigned eb, unsigned& a,
                             unsigned& b) const {
    a += ea;
    b += eb;
  }
};
struct Map {
  __device__ void operator()(unsigned ea, unsigned eb, unsigned& a,
                             unsigned& b) const {
    b = a ? eb + b : b;
    a = ea & a;
  }
};

// Block-wide exclusive scan of each thread's (a, b) in thread order, with
// identity (ia, ib); (ta, tb) gets the block's total.  Every thread calls
// it; it ends behind a barrier.
template <class Op>
__device__ __forceinline__ void block_scan(unsigned& a, unsigned& b, Op op,
                                           unsigned ia, unsigned ib,
                                           unsigned* s_a, unsigned* s_b,
                                           unsigned& ta, unsigned& tb) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned xa = a, xb = b;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned oa = __shfl_up_sync(FULL, xa, d);
    const unsigned ob = __shfl_up_sync(FULL, xb, d);
    if (lane >= d) op(oa, ob, xa, xb);
  }
  unsigned ea = __shfl_up_sync(FULL, xa, 1), eb = __shfl_up_sync(FULL, xb, 1);
  if (lane == 0) {
    ea = ia;
    eb = ib;
  }
  if (lane == 31) {
    s_a[w] = xa;
    s_b[w] = xb;
  }
  __syncthreads();
  if (w == 0) {
    unsigned va = lane < SCHED_WARPS ? s_a[lane] : ia;
    unsigned vb = lane < SCHED_WARPS ? s_b[lane] : ib;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned oa = __shfl_up_sync(FULL, va, d);
      const unsigned ob = __shfl_up_sync(FULL, vb, d);
      if (lane >= d) op(oa, ob, va, vb);
    }
    unsigned pa = __shfl_up_sync(FULL, va, 1), pb = __shfl_up_sync(FULL, vb, 1);
    if (lane == 0) {
      pa = ia;
      pb = ib;
    }
    __syncwarp();
    if (lane < SCHED_WARPS) {
      s_a[lane] = pa;
      s_b[lane] = pb;
    }
    if (lane == 31) {
      s_a[SCHED_WARPS] = va;
      s_b[SCHED_WARPS] = vb;
    }
  }
  __syncthreads();
  op(s_a[w], s_b[w], ea, eb);
  a = ea;
  b = eb;
  ta = s_a[SCHED_WARPS];
  tb = s_b[SCHED_WARPS];
  __syncthreads();
}

__device__ __forceinline__ int step_key(int c, int l, int p, int pm) {
  const int layers = c == 0 ? pm - 2 - p + l : pm - 1 - p + l;
  return (int)(((unsigned)(layers + 1) << 16) | ((unsigned)(c > 0) << 12)
               | ((unsigned)l << 6) | (unsigned)c);
}

__global__ void __launch_bounds__(SCHED_THREADS) schedule_kernel(
    const int* __restrict__ planes, const int* __restrict__ root,
    int64_t root_frame, int64_t root_ch, int pix0,
    const int* __restrict__ real, int nframes, int C, int L, Outs o) {
  extern __shared__ int sm[];
  const int S = C * L * PMAX;
  int* s_vkey = sm;          // valid keys, compacted in index order
  int* s_vidx = sm + S;      // their step indices
  int* s_ord = sm + 2 * S;   // order: step index at each rank
  int* s_nS = sm + 3 * S;    // per step, at its (c, l, p) index
  int* s_nZ = sm + 4 * S;
  int* s_tz = sm + 5 * S;
  int* s_nRef = sm + 6 * S;
  __shared__ int s_planes[MAX_C], s_rcnt[MAX_C], s_rtok[MAX_C];
  __shared__ int s_pm, s_base0;
  __shared__ unsigned s_a[SCHED_WARPS + 1], s_b[SCHED_WARPS + 1];

  const int f = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int64_t fs = (int64_t)f * S;
  const int per = (S + SCHED_THREADS - 1) / SCHED_THREADS;
  const int s0 = min(tid * per, S), s1 = min(s0 + per, S);

  // 1. planes, planes_max and the root band's counts.
  if (w == 0) {
    const int pl = lane < C ? planes[(int64_t)f * C + lane] : INT_MIN;
    if (lane < C) s_planes[lane] = pl;
    int mx = pl;
    for (int d = 16; d; d >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, d));
    if (lane == 0) s_pm = mx;
  }
  for (int c = w; c < C; c += SCHED_WARPS) {
    const int* rp = root + f * root_frame + c * root_ch;
    int mx = INT_MIN;
    unsigned nnz = 0;
    for (int i = lane; i < pix0; i += 32) {
      const int x = rp[i];
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
  __syncthreads();
  if (tid == 0) {
    unsigned base = 0;
    for (int c = 0; c < C; ++c) {
      o.i(O_ROOT_CNT)[(int64_t)f * C + c] = s_rcnt[c];
      o.i(O_ROOT_BASE)[(int64_t)f * C + c] = (int)base;
      base += (unsigned)s_rtok[c];
    }
    o.i(O_PLANES_BASE)[f] = (int)base;
    const int b0 = (int)(base + (unsigned)C);
    s_base0 = (b0 + 1) / 2 * 2;
  }

  // 2. nRef, validity and keys; the valid steps' places.
  const int pm = s_pm;  // written before the barrier above
  const int LP = L * PMAX;
  unsigned nv = 0;
  for (int i = s0; i < s1; ++i) {
    const int c = i / LP, l = (i / PMAX) % L, p = i % PMAX;
    const int nS = o.i(O_NS)[fs + i];
    const int nZ = o.i(O_NZ_LV)[fs + i];
    const int nRef = p < pm ? (int)((unsigned)real[l] - (unsigned)nZ
                                    - (unsigned)nS) : 0;
    const bool v = p < s_planes[c];
    s_nS[i] = nS;
    s_nZ[i] = nZ;
    s_tz[i] = o.i(O_TZ_LV)[fs + i];
    s_nRef[i] = nRef;
    o.i(O_NREF)[fs + i] = nRef;
    o.b(O_VALID)[fs + i] = v;
    nv += v;
  }
  unsigned vb = 0, V, unused;
  block_scan(nv, vb, Sum(), 0u, 0u, s_a, s_b, V, unused);
  unsigned vp = nv;  // valid steps before this run
  for (int i = s0; i < s1; ++i) {
    const int c = i / LP, l = (i / PMAX) % L, p = i % PMAX;
    if (p < s_planes[c]) {
      s_vkey[vp] = step_key(c, l, p, pm);
      s_vidx[vp] = i;
      ++vp;
    } else {
      s_ord[(int)V + (i - (int)vp)] = i;
    }
  }
  __syncthreads();

  // 3. ranks of the valid keys.
  for (int j = tid; j < (int)V; j += SCHED_THREADS) {
    const int k = s_vkey[j];
    int r = 0;
    for (int q = 0; q < (int)V; ++q) {
      const int kq = s_vkey[q];
      r += (kq < k) | ((kq == k) & (q < j));
    }
    s_ord[r] = s_vidx[j];
  }
  __syncthreads();

  // 4. the carry chain.
  const unsigned carry0 = pm == 0 ? (unsigned)real[0] : 0u;
  unsigned A = 1, B = 0;
  for (int s = s0; s < s1; ++s) {
    const int i = s_ord[s];
    unsigned a = 1, b = 0;
    if (s < (int)V) {
      if (s_nRef[i] > 0) {
        a = 0;
      } else if (s_nS[i] > 0) {
        a = 0;
        b = (unsigned)s_tz[i];
      } else {
        b = (unsigned)s_nZ[i];
      }
    }
    Map()(A, B, a, b);
    A = a;
    B = b;
  }
  unsigned TA, TB;
  block_scan(A, B, Map(), 1u, 0u, s_a, s_b, TA, TB);
  unsigned carry = A ? carry0 + B : B;
  int cnt[MAX_PER];
  unsigned al_sum = 0, ref_sum = 0;
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = s0 + j;
    cnt[j] = 0;
    if (s < s1) {
      const int i = s_ord[s];
      const bool v = s < (int)V;
      const int nS = s_nS[i], nRef = s_nRef[i];
      const unsigned rv = nS > 0 ? (unsigned)s_tz[i]
                                 : carry + (unsigned)s_nZ[i];
      const bool rro = v && nRef > 0 && (int)rv > 0;
      o.i(O_CARRY_IN)[fs + i] = (int)carry;
      o.i(O_REFRUN_VAL)[fs + i] = (int)rv;
      o.b(O_REFRUN_OK)[fs + i] = rro;
      o.i(O_CIN_SCHED)[fs + s] = (int)carry;
      if (v) carry = nRef > 0 ? 0u : rv;
      const int cs = v ? 2 * nS + (int)rro : 0;
      cnt[j] = cs;
      al_sum += (unsigned)((cs + 1) / 2 * 2);
      ref_sum += v ? (unsigned)nRef : 0u;
    }
  }

  // 5. bases, T, injection sites and refinement-bit prefixes.
  unsigned T_al, T_ref;
  block_scan(al_sum, ref_sum, Sum(), 0u, 0u, s_a, s_b, T_al, T_ref);
  unsigned base = (unsigned)s_base0 + al_sum, pref = ref_sum;
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = s0 + j;
    if (s < s1) {
      const int i = s_ord[s];
      const bool v = s < (int)V;
      const int cs = cnt[j];
      const unsigned al = (unsigned)((cs + 1) / 2 * 2);
      o.i(O_STEP_BASE)[fs + i] = (int)base;
      o.i(O_STEP_END)[fs + i] = (int)(base + (unsigned)cs);
      o.i(O_INJ_POS)[fs + i] = (int)(base + al);
      o.i(O_REFPFX)[fs + i] = (int)pref;
      o.i(O_ORDER)[fs + s] = i;
      o.i(O_BASE_SCHED)[fs + s] = (int)base;
      o.i(O_NS_SCHED)[fs + s] = v ? s_nS[i] : 0;
      o.b(O_VALID_SCHED)[fs + s] = v;
      base += al;
      if (v) pref += (unsigned)s_nRef[i];
    }
  }
  if (tid == 0) {
    o.i(O_HEAD)[f] = pm;
    o.i(O_HEAD)[nframes + f] = (int)((unsigned)s_base0 + T_al + 1u);
    o.i(O_CARRY_END)[f] = (int)(TA ? carry0 + TB : TB);
  }
}

extern "C" int dwt_schedule(
    const void* planes, const void* nS_ck, const void* lastS_ck,
    const void* z0_ck, const void* zup_ck, const void* root,
    int64_t root_frame, int64_t root_ch, int64_t pix0, const void* real,
    const void* lcb, const void* lnc, int64_t nframes, int64_t C, int64_t L,
    int64_t nchunk, int64_t warps, void* const* outs, void* stream) {
  if (nframes < 0 || C < 1 || C > MAX_C || L < 1 || nchunk < 1
      || pix0 < 1 || pix0 > 0x7fffffff || warps < 1 || warps > MAX_WARPS
      || C * L * PMAX > MAX_STEPS || nchunk > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (nframes == 0) return 0;
  const int64_t blocks = nframes * C * L;
  if (blocks > 0x7fffffff || nframes > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  Outs o;
  for (int k = 0; k < O_COUNT; ++k) o.p[k] = outs[k];
  cudaStream_t st = (cudaStream_t)stream;
  level_sums_kernel<<<(unsigned)blocks, (unsigned)(32 * warps), 0, st>>>(
      (const int*)nS_ck, (const int*)lastS_ck, (const int*)z0_ck,
      (const int*)zup_ck, (const int*)lcb, (const int*)lnc, (int)L,
      (int)nchunk, o);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)SCHED_TABLES * C * L * PMAX * sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(schedule_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  schedule_kernel<<<(unsigned)nframes, SCHED_THREADS, smem, st>>>(
      (const int*)planes, (const int*)root, root_frame, root_ch, (int)pix0,
      (const int*)real, (int)nframes, (int)C, (int)L, o);
  return (int)cudaGetLastError();
}
