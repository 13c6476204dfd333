// Kernel A's unit tables (kernel 15).
//
// No TPU kernel to replace: the JAX package computes them as XLA
// (dwt_tpu/codec/encoder.py:_unit_common and _kernel_a_meta), about 30
// eager launches in the plain PyTorch version (ops/units.py:
// unit_tables_plain: a searchsorted of every unit in the schedule's unit
// bases, a dozen gathers, a stack and a scatter for the inverse table).
//
// Input: stage 1's (N, S) order, ubase_sched (each step's first unit:
// the exclusive sum over the schedule of the steps' chunk counts, which
// kernel 14 writes) and valid_sched, (N, C, L, PMAX) step_base and (N, C,
// nchunk, PMAX) nS_ck, scar_ck and zcar_ck (the level-exclusive cumsums
// over the chunks of nS_ck and nZ_ck, which kernel 14's level walk
// writes), the levels' first chunks and the chunks' starts and lengths.
// Output, for the U = C * PMAX * nchunk units of each frame in stream
// order: the (N, U) columns elem, elen, p, flat_step, flat_ck (int32) and
// valid (bool), kernel A's (N * U, 8) meta rows, and the inverse table
// (N * C * nchunk, PMAX): table[f * U + flat_ck] = f * U + u; each at its
// byte offset (enum Out) in the wrapper's one allocation.
//
// units_kernel: ceil(U / 256) blocks a frame of 256 threads, one unit a
// thread.  Each block stages the frame's ubase_sched and order rows in
// shared memory: thread 0 issues one bulk copy (TMA, cp.async.bulk onto
// an mbarrier) a row of the row's whole 16-byte words, and the few ints
// of the row before and after them come by plain loads.  Then each thread
// finds its unit's step by a binary search of the staged bases (the last
// at most u, as searchsorted(right) - 1), and writes its columns, its
// 32-byte meta row as two 16-byte stores and its table slot.
// Neighbouring units of a step are neighbouring chunks of one (c, l, p):
// the gathers from the chunk tables stride PMAX ints, in L2 (stage 1
// wrote them just before).
//
// Bound: bytes, but small ones.  At 4K it reads about 0.19 MB and writes
// 0.67 MB (U = 11,832 units of 57 bytes): 0.26 us at 3.35 TB/s.  Its time
// is the launch, the staging copy and the search and stores, a few
// hundred nanoseconds of latency each; 47 blocks a 4K frame spread them
// over as many SMs.
#include "common.cuh"

constexpr int PMAX = 29;              // ops/plane_stats.py
constexpr int UNIT_THREADS = 256;
constexpr int MAX_STEPS = 2048;       // ops/schedule.py
constexpr int SUBA = 1024;            // ops/compact.py
constexpr int64_t WTOK_BIG = 65536 + 256;
// A staged row: S ints after a head of up to 3, so its 16-byte words
// land on 16-byte words of the buffer.
constexpr int ROW = MAX_STEPS + 4;

// The outputs, in ops/units.py's OUT_KEYS order.
enum Out { O_ELEM, O_ELEN, O_P, O_FLAT_STEP, O_FLAT_CK, O_VALID, O_META,
           O_TABLE, O_COUNT };

// The outputs' byte offsets in the wrapper's allocation, by value.
struct Offsets {
  int64_t at[O_COUNT];
};

struct Args {
  const int* order;
  const int* ubase;
  const bool* valid_sched;
  const int* step_base;
  const int* nS_ck;
  const int* scar;
  const int* zcar;
  const int* lcb;
  const int* ch_start;
  const int* ch_len;
  int64_t n, pairbuf;
  int C, L, nchunk, S, U, blocks;  // blocks a frame
  void* out[O_COUNT];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Stages row ``src`` of S ints into ``dst``, its int j at dst[head + j]
// with head = (src mod 16) / 4: thread 0 plans the bulk copy of the row's
// whole 16-byte words (returned in ``bytes``, 0 for none, from ``from``
// to ``to``), every thread loads its share of the ints outside them.
__device__ __forceinline__ int stage_plan(int* dst, const int* src, int S,
                                          unsigned& bytes, uintptr_t& from,
                                          int*& to) {
  const uintptr_t a = (uintptr_t)src, e = a + 4 * (uintptr_t)S;
  const uintptr_t lo = (a + 15) & ~(uintptr_t)15, hi = e & ~(uintptr_t)15;
  const int head = (int)((a & 15) >> 2);
  const bool bulk = hi > lo;
  bytes = bulk ? (unsigned)(hi - lo) : 0u;
  from = lo;
  to = dst + head + (int)((lo - a) >> 2);
  for (int j = threadIdx.x; j < S; j += UNIT_THREADS) {
    const uintptr_t p = a + 4 * (uintptr_t)j;
    if (!bulk || p < lo || p >= hi) dst[head + j] = src[j];
  }
  return head;
}

__global__ void __launch_bounds__(UNIT_THREADS) units_kernel(
    const __grid_constant__ Args A) {
  __shared__ __align__(16) int s_ub[ROW];
  __shared__ __align__(16) int s_ord[ROW];
  __shared__ __align__(8) unsigned long long bar;
  const int S = A.S, U = A.U;
  const int f = blockIdx.x / A.blocks, part = blockIdx.x % A.blocks;
  const int tid = threadIdx.x;
  const int64_t fs = (int64_t)f * S, fu = (int64_t)f * U;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  unsigned nb[2];
  uintptr_t from[2];
  int* to[2];
  const int hu = stage_plan(s_ub, A.ubase + fs, S, nb[0], from[0], to[0]);
  const int ho = stage_plan(s_ord, A.order + fs, S, nb[1], from[1], to[1]);
  if (tid == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
        :: "r"(smem_addr(&bar)), "r"(nb[0] + nb[1]) : "memory");
    for (int k = 0; k < 2; ++k)
      if (nb[k])
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];"
            :: "r"(smem_addr(to[k])), "l"(from[k]), "r"(nb[k]),
               "r"(smem_addr(&bar))
            : "memory");
  }
  __syncthreads();  // the plain loads
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(&bar)) : "memory");
  } while (!done);

  const int u = part * UNIT_THREADS + tid;
  if (u >= U) return;
  const int* ub = s_ub + hu;
  int lo = 0, hi = S;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (ub[mid] <= u) lo = mid; else hi = mid;
  }
  const int ord = s_ord[ho + lo];
  const int L = A.L, nchunk = A.nchunk, LP = L * PMAX;
  const int c = ord / LP, l = (ord / PMAX) % L, p = ord % PMAX;
  const int chunk = A.lcb[l] + (u - ub[lo]);
  const int elem = (int)(c * A.n + A.ch_start[chunk]);
  const int elen = A.ch_len[chunk];
  const int fck = (c * nchunk + chunk) * PMAX + p;
  const bool v = A.valid_sched[fs + lo];
  const int u_pair0 = (A.step_base[fs + ord] >> 1) + A.scar[fu + fck];
  const int wsmax = (int)((A.pairbuf - WTOK_BIG) / 128 * 128);
  const int ws = min(max(u_pair0 & ~127, 0), wsmax);
  ((int*)A.out[O_ELEM])[fu + u] = elem;
  ((int*)A.out[O_ELEN])[fu + u] = elen;
  ((int*)A.out[O_P])[fu + u] = p;
  ((int*)A.out[O_FLAT_STEP])[fu + u] = ord;
  ((int*)A.out[O_FLAT_CK])[fu + u] = fck;
  ((bool*)A.out[O_VALID])[fu + u] = v;
  int4* row = (int4*)A.out[O_META] + 2 * (fu + u);
  row[0] = make_int4((int)((elem + f * A.C * A.n) / SUBA), elen, p,
                     (int)(ws + f * A.pairbuf));
  row[1] = make_int4(u_pair0 - ws, A.zcar[fu + fck],
                     v ? A.nS_ck[fu + fck] : 0, 0);
  ((int*)A.out[O_TABLE])[fu + fck] = (int)(fu + u);
}

extern "C" int dwt_unit_tables(
    const void* order, const void* ubase, const void* valid_sched,
    const void* step_base, const void* nS_ck, const void* scar,
    const void* zcar, const void* lcb, const void* ch_start,
    const void* ch_len, int64_t nframes, int64_t C, int64_t L,
    int64_t nchunk, int64_t n, int64_t padded_T, void* arena,
    Offsets offsets, void* stream) {
  if (nframes < 0 || C < 1 || L < 1 || nchunk < 1 || n < 0 || padded_T < 0
      || C * L * PMAX > MAX_STEPS
      || nframes * C * nchunk * PMAX >= 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (nframes == 0) return 0;
  const int U = (int)(C * PMAX * nchunk);
  const int64_t per = (U + UNIT_THREADS - 1) / UNIT_THREADS;
  if (nframes * per > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  Args A;
  A.order = (const int*)order;
  A.ubase = (const int*)ubase;
  A.valid_sched = (const bool*)valid_sched;
  A.step_base = (const int*)step_base;
  A.nS_ck = (const int*)nS_ck;
  A.scar = (const int*)scar;
  A.zcar = (const int*)zcar;
  A.lcb = (const int*)lcb;
  A.ch_start = (const int*)ch_start;
  A.ch_len = (const int*)ch_len;
  A.n = n;
  A.pairbuf = padded_T / 2 + WTOK_BIG + 256;
  A.C = (int)C;
  A.L = (int)L;
  A.nchunk = (int)nchunk;
  A.S = (int)(C * L * PMAX);
  A.U = U;
  A.blocks = (int)per;
  for (int k = 0; k < O_COUNT; ++k)
    A.out[k] = (char*)arena + offsets.at[k];
  units_kernel<<<(unsigned)(nframes * per), UNIT_THREADS, 0,
                 (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
