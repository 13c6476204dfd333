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
// bits nref and clamped injection sites (N, S); stage 1's step_end,
// refpfx and step_base (N, S), planes (N, C), planes_max (N), and the
// chunk tables nS_ck and nZ_ck (N, C, nchunk, PMAX); kernel 15's unit
// columns elem, elen, p, flat_step, flat_ck and valid (N, U), U = C *
// nchunk * PMAX; the pyramid's chunk validity counts and the levels'
// first chunks (ascending: the levels partition the chunks in order).
// Output, each at its byte offset (enum Out) in the wrapper's one
// allocation:
//
// * refstart (N, S): off[end] - inj_le_end + refpfx, with end = step_end
//   clamped to [0, T - 1] and inj_le_end the sum of nref[t] over the steps
//   t whose site is at most end;
// * kernel B's meta (N * U, 8): the element row (elem + f * C * n) / SUBB,
//   the length, the plane, the word window ws + f * nwords, the unit's
//   first refinement bit less 32 * ws, 0, its refinement bits (0 for an
//   invalid step) and 0, where the first bit is refstart[flat_step] plus
//   rcar[flat_ck], rcar the level-exclusive scan over the chunks of
//   nR_ck = [p < planes_max] (ch_valid - nS_ck - nZ_ck), and ws is its
//   word's 128-aligned floor clamped to [0, wsmax];
// * head: the pack kernel's order flag (zeroed here), then bits_parts
//   (N, K), the chunk sums summed in groups of 512 and nref in groups of
//   8, then layer_ends (N, LMAX): for each layer k the least start bit
//   off[step_base] of a step of a later layer whose plane is below its
//   channel's planes, capped by the frame's int32 total of bits_parts.
//
// All arithmetic is int32 with wrapping adds, as the JAX package's.
//
// emit_steps_kernel: a block a frame, NT threads (a power of two from 64
// to 1,024, NP = 2 * NT >= S).  The (site, nref) pairs of the frame's
// steps are sorted by site as 64-bit keys, padded to NP with all ones,
// by a bitonic network in shared memory (log2(NP) (log2(NP) + 1) / 2
// stages of NT compare-exchanges), then the nrefs are scanned in that
// order: inj_le_end of a step is the scan at the last key whose site is
// at most its end, found by a binary search.  S log^2 S work where the
// plain version's where-sum is S^2.  Then warps sum the token parts,
// threads the step parts, and the layer ends come from a shared atomic
// minimum a layer bucket and a suffix minimum.
//
// emit_meta_kernel: one unit a thread over the N * U units, each reading
// its columns and refstart at its step (in L2: the first launch wrote it
// just before) and writing its 32-byte row as two 16-byte stores.  Its
// rcar is the sum of nR_ck over the chunks of its chunk's level before
// it (the level found by a binary search of the levels' first chunks):
// the lanes of a warp are mostly consecutive chunks of one (c, p)
// column, so each step of that loop is one broadcast load a table for
// the warp, and nothing is stored inside it, so the loads pipeline.  (A
// thread a column walking the chunks and storing each prefix took 0.046
// ms at 4K, its 97-chunk level one L2 round trip a chunk.)
//
// Bound: bytes, a few hundred kB a 4K frame (0.0002 ms at 3.35 TB/s);
// the two launches' latency is the time.
#include "common.cuh"

constexpr int PMAX = 29;              // ops/plane_stats.py
constexpr int MAX_STEPS = 2048;       // ops/schedule.py
constexpr int LMAX = 64;              // codec/emit.py
constexpr int SUBB_SHIFT = 10;        // ops/compact.py: SUBB = 1024
constexpr int PART_CHUNKS = 512;      // chunk sums a token part
constexpr int PART_STEPS = 8;         // steps a refinement part
constexpr int BIGBIT = 0x7fffffff;
constexpr int META_THREADS = 256;

// The outputs, in ops/emit_tables.py's _layout order.
enum Out { O_REFSTART, O_META, O_HEAD, O_COUNT };

// The outputs' byte offsets in the wrapper's allocation, by value.
struct Offsets {
  int64_t at[O_COUNT];
};

// The inputs are read-only for both launches, and the outputs never
// alias them: loads may be reordered freely.
struct Args {
  const int* __restrict__ off;
  const int* __restrict__ chunks;
  const int* __restrict__ nref;
  const int* __restrict__ site;
  const int* __restrict__ step_end;
  const int* __restrict__ refpfx;
  const int* __restrict__ step_base;
  const int* __restrict__ planes;
  const int* __restrict__ planes_max;
  const int* __restrict__ nS_ck;
  const int* __restrict__ nZ_ck;
  const int* __restrict__ elem;
  const int* __restrict__ elen;
  const int* __restrict__ p;
  const int* __restrict__ flat_step;
  const int* __restrict__ flat_ck;
  const bool* __restrict__ valid;
  const int* __restrict__ ch_valid;
  const int* __restrict__ lcb;
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
    v = wrap_add(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__global__ void __launch_bounds__(1024) emit_steps_kernel(
    const __grid_constant__ Args A) {
  extern __shared__ __align__(16) unsigned long long s_key[];  // NP keys
  int* s_scan = (int*)(s_key + 2 * blockDim.x);                 // NP ints
  __shared__ int s_min[LMAX + 1];
  __shared__ int s_warp[32];
  __shared__ unsigned s_tot;
  const int NT = blockDim.x, NP = 2 * NT, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = NT >> 5;
  const int S = A.S, L = A.L, C = A.C;
  const int64_t f = blockIdx.x, fs = f * S, T = A.T;
  const int* off = A.off + f * T;

  for (int k = tid; k <= LMAX; k += NT) s_min[k] = BIGBIT;
  if (tid == 0) s_tot = 0u;
  if (f == 0 && tid == 0) A.head[0] = 0;  // the pack kernel's order flag
  for (int i = tid; i < NP; i += NT)
    s_key[i] = i < S ? ((unsigned long long)(unsigned)A.site[fs + i] << 32
                        | (unsigned)A.nref[fs + i])
                     : ~0ull;
  __syncthreads();

  // The bitonic network: thread t exchanges the pair (i, i + j), i being
  // t with a zero bit inserted at j, ascending where bit k of i is 0.
  for (int k = 2; k <= NP; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * tid - (tid & (j - 1));
      const unsigned long long a = s_key[i], b = s_key[i + j];
      if ((a > b) == ((i & k) == 0)) {
        s_key[i] = b;
        s_key[i + j] = a;
      }
      __syncthreads();
    }
  }

  // Inclusive scan of the nrefs in site order, two keys a thread.
  const int v0 = 2 * tid < S ? (int)(unsigned)s_key[2 * tid] : 0;
  const int v1 = 2 * tid + 1 < S ? (int)(unsigned)s_key[2 * tid + 1] : 0;
  int x = wrap_add(v0, v1);
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = wrap_add(x, y);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarp ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = wrap_add(w, y);
    }
    if (lane < nwarp) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = wrap_sub(wrap_add(x, warp ? s_warp[warp - 1] : 0),
                              wrap_add(v0, v1));
  s_scan[2 * tid] = wrap_add(before, v0);
  s_scan[2 * tid + 1] = wrap_add(before, wrap_add(v0, v1));
  __syncthreads();

  const int pm = A.planes_max[f];
  for (int s = tid; s < S; s += NT) {
    // refstart: the keys with site <= end are the first cnt.
    const int end = min(max(A.step_end[fs + s], 0), (int)(T - 1));
    int lo = 0, hi = S;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((unsigned)(s_key[mid] >> 32) <= (unsigned)end) lo = mid + 1;
      else hi = mid;
    }
    const int inj = lo ? s_scan[lo - 1] : 0;
    A.refstart[fs + s] = wrap_add(wrap_sub(off[end], inj), A.refpfx[fs + s]);

    // The step's layer bucket, where its plane is below its channel's.
    const int c = s / (L * PMAX), l = (s / PMAX) % L, p = s % PMAX;
    if (p < A.planes[f * C + c]) {
      const int layer = (c == 0 ? pm - 2 : pm - 1) - p + l;
      const int b = min(max(layer, -1) + 1, LMAX);
      const int base = min(max(A.step_base[fs + s], 0), (int)(T - 1));
      atomicMin(&s_min[b], off[base]);
    }
  }

  // bits_parts: a warp a token part, a thread a refinement part.
  int* parts = A.head + 1 + f * A.K;
  for (int j = warp; j < A.KT; j += nwarp) {
    int v = 0;
    const int c0 = j * PART_CHUNKS, c1 = min(c0 + PART_CHUNKS, A.NC);
    for (int i = c0 + lane; i < c1; i += 32)
      v = wrap_add(v, A.chunks[f * A.NC + i]);
    v = warp_sum(v);
    if (lane == 0) {
      parts[j] = v;
      atomicAdd(&s_tot, (unsigned)v);
    }
  }
  for (int j = tid; j < A.K - A.KT; j += NT) {
    int v = 0;
    const int t1 = min((j + 1) * PART_STEPS, S);
    for (int t = j * PART_STEPS; t < t1; ++t) v = wrap_add(v, A.nref[fs + t]);
    parts[A.KT + j] = v;
    atomicAdd(&s_tot, (unsigned)v);
  }
  __syncthreads();

  int* ends = A.head + 1 + A.nframes * A.K + f * LMAX;
  for (int k = tid; k < LMAX; k += NT) {
    int e = BIGBIT;
    for (int b = k + 1; b <= LMAX; ++b) e = min(e, s_min[b]);
    ends[k] = min(e, (int)s_tot);
  }
}

__global__ void __launch_bounds__(META_THREADS) emit_meta_kernel(
    const __grid_constant__ Args A) {
  const int64_t total = A.nframes * A.U;
  for (int64_t i = blockIdx.x * (int64_t)META_THREADS + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * META_THREADS) {
    const int64_t f = i / A.U, fu = f * A.U;
    const int fck = A.flat_ck[i];
    const int p = fck % PMAX, k = (fck / PMAX) % A.nchunk;
    const bool live = p < A.planes_max[f];
    // rcar: nR_ck summed over the chunks of k's level before k; k's level
    // is the last whose first chunk is at most k.
    int lo = 0, hi = A.L;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (A.lcb[mid] <= k) lo = mid;
      else hi = mid;
    }
    const int* nS = A.nS_ck + fu + (fck - k * PMAX);  // the (c, p) column
    const int* nZ = A.nZ_ck + fu + (fck - k * PMAX);
    int rcar = 0;
    if (live) {
#pragma unroll 8
      for (int kk = A.lcb[lo]; kk < k; ++kk)
        rcar = wrap_add(rcar, wrap_sub(wrap_sub(A.ch_valid[kk],
                                                nS[kk * PMAX]),
                                       nZ[kk * PMAX]));
    }
    const int bit0 = wrap_add(A.refstart[f * A.S + A.flat_step[i]], rcar);
    const int nR = live ? wrap_sub(wrap_sub(A.ch_valid[k], nS[k * PMAX]),
                                   nZ[k * PMAX])
                        : 0;
    const int ws = min(max((bit0 >> 5) & ~127, 0), A.wsmax);
    const int row = (int)((unsigned)A.elem[i] + (unsigned)(f * A.cn));
    int4* out = A.meta + 2 * i;
    out[0] = make_int4(row >> SUBB_SHIFT, A.elen[i], A.p[i],
                       wrap_add(ws, (int)(f * A.nwords)));
    out[1] = make_int4(wrap_sub(bit0, (int)(32u * (unsigned)ws)), 0,
                       A.valid[i] ? nR : 0, 0);
  }
}

// Threads a block of emit_steps_kernel at S steps: a power of two, at
// least 64 and S / 2, at most 1,024 (ops/emit_tables.py: steps_threads).
static int steps_threads(int S) {
  int nt = 64;
  while (2 * nt < S) nt <<= 1;
  return nt;
}

extern "C" int dwt_emit_tables(
    const void* off, const void* chunks, const void* nref, const void* site,
    const void* step_end, const void* refpfx, const void* step_base,
    const void* planes, const void* planes_max, const void* nS_ck,
    const void* nZ_ck, const void* elem, const void* elen, const void* p,
    const void* flat_step, const void* flat_ck, const void* valid,
    const void* ch_valid, const void* lcb, int64_t nframes,
    int64_t T, int64_t NC, int64_t C, int64_t L, int64_t nchunk, int64_t n,
    int64_t nwords, int64_t wsmax, void* arena, Offsets offsets,
    void* stream) {
  const int64_t S = C * L * PMAX;
  if (nframes < 0 || T < 1 || NC < 1 || C < 1 || L < 1 || nchunk < 1
      || n < 0 || S > MAX_STEPS || nwords < 0 || wsmax > 0x7fffffff
      || wsmax < -0x7fffffff || nframes * C * nchunk * PMAX >= 0x7fffffff
      || nframes * T >= ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  if (nframes == 0) return 0;
  Args A;
  A.off = (const int*)off;
  A.chunks = (const int*)chunks;
  A.nref = (const int*)nref;
  A.site = (const int*)site;
  A.step_end = (const int*)step_end;
  A.refpfx = (const int*)refpfx;
  A.step_base = (const int*)step_base;
  A.planes = (const int*)planes;
  A.planes_max = (const int*)planes_max;
  A.nS_ck = (const int*)nS_ck;
  A.nZ_ck = (const int*)nZ_ck;
  A.elem = (const int*)elem;
  A.elen = (const int*)elen;
  A.p = (const int*)p;
  A.flat_step = (const int*)flat_step;
  A.flat_ck = (const int*)flat_ck;
  A.valid = (const bool*)valid;
  A.ch_valid = (const int*)ch_valid;
  A.lcb = (const int*)lcb;
  A.nframes = nframes;
  A.T = T;
  A.nwords = nwords;
  A.cn = C * n;
  A.S = (int)S;
  A.C = (int)C;
  A.L = (int)L;
  A.nchunk = (int)nchunk;
  A.U = (int)(C * nchunk * PMAX);
  A.NC = (int)NC;
  A.KT = (int)((NC + PART_CHUNKS - 1) / PART_CHUNKS);
  A.K = A.KT + (int)((S + PART_STEPS - 1) / PART_STEPS);
  A.wsmax = (int)wsmax;
  char* base = (char*)arena;
  A.refstart = (int*)(base + offsets.at[O_REFSTART]);
  A.meta = (int4*)(base + offsets.at[O_META]);
  A.head = (int*)(base + offsets.at[O_HEAD]);
  if (nframes > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int nt = steps_threads((int)S);
  const size_t smem = (size_t)2 * nt * (sizeof(unsigned long long) + 4);
  cudaStream_t st = (cudaStream_t)stream;
  emit_steps_kernel<<<(unsigned)nframes, nt, smem, st>>>(A);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  emit_meta_kernel<<<grid_for(nframes * A.U, META_THREADS), META_THREADS, 0,
                     st>>>(A);
  return (int)cudaGetLastError();
}
