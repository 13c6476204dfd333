// Kernel A's unit tables (kernel 15).
//
// No TPU kernel to replace: the JAX package computes them as XLA
// (dwt_tpu/codec/encoder.py:_unit_common and _kernel_a_meta), about 30
// eager launches in the plain PyTorch version (ops/units.py:
// unit_tables_plain: a searchsorted of every unit in the schedule's unit
// bases, a dozen gathers, a stack and a scatter for the inverse table).
//
// Input: stage 1's (N, S) order and valid_sched, (N, C, L, PMAX)
// step_base and (N, C, nchunk, PMAX) nS_ck, scar_ck and zcar_ck (the
// level-exclusive cumsums over the chunks of nS_ck and nZ_ck, which stage
// 1's level walk writes), the levels' chunk counts and first chunks and
// the chunks' starts and lengths.  Output, for the U = C * PMAX * nchunk
// units of each frame in stream order: the (N, U) columns elem, elen, p,
// flat_step, flat_ck (int32) and valid (bool), kernel A's (N * U, 8) meta
// rows, and the inverse table (N * C * nchunk, PMAX): table[f * U +
// flat_ck] = f * U + u.
//
// units_kernel: `parts` blocks a frame of 256 threads.  Each block first
// stages the frame's order and the exclusive sum over the schedule of each
// step's chunk count (its level's) in shared memory: each thread sums a
// run of at most 8 steps, one block-wide shuffle scan, a second walk of
// the run.  Then each thread takes every (parts * 256)-th unit of the
// frame from its block's offset, finds its step by a binary search of the
// staged sums (the last at most u, as searchsorted(right) - 1), and writes
// its columns, its 32-byte meta row as two 16-byte stores and its table
// slot.  Neighbouring units of a step are neighbouring chunks of one (c,
// l, p): the gathers from the chunk tables stride PMAX ints, in L2 (stage
// 1 wrote them just before).
//
// Bound: bytes, but small ones.  At 4K it reads about 0.19 MB and writes
// 0.67 MB (U = 11,832 units of 57 bytes): 0.26 us at 3.35 TB/s.  Its time
// is the launch and two dependent phases (the staged scan, then the
// units), each a few hundred nanoseconds of latency.
#include "common.cuh"

constexpr int PMAX = 29;              // ops/plane_stats.py
constexpr int UNIT_THREADS = 256;
constexpr int UNIT_WARPS = UNIT_THREADS / 32;
constexpr int MAX_STEPS = 2048;       // ops/schedule.py
constexpr int MAX_PER = MAX_STEPS / UNIT_THREADS;
constexpr int SUBA = 1024;            // ops/compact.py
constexpr int64_t WTOK_BIG = 65536 + 256;
constexpr unsigned FULL = 0xffffffffu;

// The output pointers, in ops/units.py's OUT_KEYS order.
enum Out { O_ELEM, O_ELEN, O_P, O_FLAT_STEP, O_FLAT_CK, O_VALID, O_META,
           O_TABLE, O_COUNT };

struct Outs {
  void* p[O_COUNT];
};

__global__ void __launch_bounds__(UNIT_THREADS) units_kernel(
    const int* __restrict__ order, const bool* __restrict__ valid_sched,
    const int* __restrict__ step_base, const int* __restrict__ nS_ck,
    const int* __restrict__ scar, const int* __restrict__ zcar,
    const int* __restrict__ lnc, const int* __restrict__ lcb,
    const int* __restrict__ ch_start, const int* __restrict__ ch_len, int C,
    int L, int nchunk, int64_t n, int64_t pairbuf, int parts, Outs o) {
  __shared__ int s_ord[MAX_STEPS];
  __shared__ int s_ub[MAX_STEPS];
  __shared__ unsigned s_warp[UNIT_WARPS];
  const int S = C * L * PMAX;
  const int U = C * PMAX * nchunk;
  const int f = blockIdx.x / parts, part = blockIdx.x % parts;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t fs = (int64_t)f * S, fu = (int64_t)f * U;

  // The frame's unit bases: exclusive sums of the steps' chunk counts.
  const int per = (S + UNIT_THREADS - 1) / UNIT_THREADS;
  const int s0 = min(tid * per, S), s1 = min(s0 + per, S);
  int ups[MAX_PER];
  unsigned run = 0;
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = s0 + j;
    ups[j] = 0;
    if (s < s1) {
      const int ord = order[fs + s];
      s_ord[s] = ord;
      ups[j] = lnc[(ord / PMAX) % L];
      run += (unsigned)ups[j];
    }
  }
  unsigned incl = run;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  unsigned before = incl - run;
  for (int k = 0; k < w; ++k) before += s_warp[k];
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = s0 + j;
    if (s < s1) {
      s_ub[s] = (int)before;
      before += (unsigned)ups[j];
    }
  }
  __syncthreads();

  const int wsmax = (int)((pairbuf - WTOK_BIG) / 128 * 128);
  int* elem_o = (int*)o.p[O_ELEM] + fu;
  int* elen_o = (int*)o.p[O_ELEN] + fu;
  int* p_o = (int*)o.p[O_P] + fu;
  int* step_o = (int*)o.p[O_FLAT_STEP] + fu;
  int* ck_o = (int*)o.p[O_FLAT_CK] + fu;
  bool* valid_o = (bool*)o.p[O_VALID] + fu;
  int4* meta = (int4*)o.p[O_META];
  int* table = (int*)o.p[O_TABLE];
  const int LP = L * PMAX;
  for (int u = part * UNIT_THREADS + tid; u < U;
       u += parts * UNIT_THREADS) {
    int lo = 0, hi = S;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_ub[mid] <= u) lo = mid; else hi = mid;
    }
    const int ord = s_ord[lo];
    const int c = ord / LP, l = (ord / PMAX) % L, p = ord % PMAX;
    const int chunk = lcb[l] + (u - s_ub[lo]);
    const int elem = (int)(c * n + ch_start[chunk]);
    const int elen = ch_len[chunk];
    const int fck = (c * nchunk + chunk) * PMAX + p;
    const bool v = valid_sched[fs + lo];
    const int u_pair0 = (step_base[fs + ord] >> 1) + scar[fu + fck];
    const int ws = min(max(u_pair0 & ~127, 0), wsmax);
    elem_o[u] = elem;
    elen_o[u] = elen;
    p_o[u] = p;
    step_o[u] = ord;
    ck_o[u] = fck;
    valid_o[u] = v;
    int4* row = meta + 2 * (fu + u);
    row[0] = make_int4((int)((elem + f * C * n) / SUBA), elen, p,
                       (int)(ws + f * pairbuf));
    row[1] = make_int4(u_pair0 - ws, zcar[fu + fck],
                       v ? nS_ck[fu + fck] : 0, 0);
    table[fu + fck] = (int)(fu + u);
  }
}

extern "C" int dwt_unit_tables(
    const void* order, const void* valid_sched, const void* step_base,
    const void* nS_ck, const void* scar, const void* zcar, const void* lnc,
    const void* lcb, const void* ch_start, const void* ch_len,
    int64_t nframes, int64_t C, int64_t L, int64_t nchunk, int64_t n,
    int64_t padded_T, int64_t parts, void* const* outs, void* stream) {
  if (nframes < 0 || C < 1 || L < 1 || nchunk < 1 || n < 0 || padded_T < 0
      || parts < 1 || C * L * PMAX > MAX_STEPS
      || nframes * C * nchunk * PMAX >= 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (nframes == 0) return 0;
  const int64_t blocks = nframes * parts;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  Outs o;
  for (int k = 0; k < O_COUNT; ++k) o.p[k] = outs[k];
  units_kernel<<<(unsigned)blocks, UNIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)order, (const bool*)valid_sched, (const int*)step_base,
      (const int*)nS_ck, (const int*)scar, (const int*)zcar,
      (const int*)lnc, (const int*)lcb, (const int*)ch_start,
      (const int*)ch_len, (int)C, (int)L, (int)nchunk, n,
      padded_T / 2 + WTOK_BIG + 256, (int)parts, o);
  return (int)cudaGetLastError();
}
