// The encoder's token finisher (kernel 12) and packed elements (kernel 13).
//
// No TPU kernel to replace: the JAX package computes both as XLA
// (dwt_tpu/codec/encoder.py:_finish_tokens and _packed_elems), fused into
// its stage-2 program on the TPU.  The plain PyTorch versions
// (ops/finish.py:finish_tokens_plain, packed_elems_plain) run them as about
// 50 eager launches: two argsort, cummax and searchsorted fills, a
// scatter_add, three interleaving stacks and three copies that add a spare
// slot a row, then a dozen small scatters; and eight passes for the packed
// elements.  At 4K that moves about 5.5 GB where the work needs 0.56 GB.
//
// Kernel 12, the token finisher.  Input: kernel A's (N, npair) int32 pairs
// ((zero-prefix << 1) | sign at each newly significant element's pair
// rank), rows of unit stride at row stride pair_row; the (N, S)
// schedule-ordered step tables base, nS, cin (int32) and valid (bool), each
// at its own row stride (stage 1's cin is a slice of a wider table); the
// (N, C, pix0) root band at strides root_frame, root_ch; the per-frame
// tables of stage 1.  Output: the (N, 2 npair) token values, raw bit
// counts (int32) and VLI flags (bool), contiguous.
//
// finish_dense_kernel writes every slot.  Pair p of frame f lies in the
// last step j whose clamped pair base min(base_j / 2, npair - 1) is at most
// p: both base and base / 2 + nS are nondecreasing within a frame (the
// wrapper's docstring says why), so that step's values are the maxima that
// the plain version's scatter-max fills take at p, and a table out of that
// order traps.  Slot 2p holds the run value zp - zp[p-1] + the zero carries
// of every step whose clamped base is p (zp alone at a step's first pair)
// when p < base_j / 2 + nS_j, else zp; slot 2p + 1 the sign.  Raw counts
// are 0 and 1 (in a step) and the VLI flags 1 (in a step) and 0.
//   A block stages its frame's table in shared memory once (clamped pair
// base, pair base, pair end, and an inclusive int32 sum of the carries) and
// then takes every bx-th tile of TILE pairs of the frame, bx blocks a
// frame (about 1,024 blocks in all).  A
// thread reads PAIRS pairs as one 16-byte word, finds its step by a binary
// search (and a second one on the rare pair where a step starts, for the
// carries of the steps that tie there), and writes 8 values and 8 raw
// counts as two 16-byte words each and 8 flags as one 8-byte word.
//
// finish_special_kernel then runs one block a frame, after the dense pass
// on the same stream: the root counts, the root magnitudes with their raw
// counts (a block scan of the nonzero root values gives their ranks), the
// root signs, the plane counts, the ref-run tokens and the flush at T - 1,
// in the JAX package's order, each phase behind a barrier, so that a later
// write wins where two land on one slot (a ref-run token can sit at
// T - 1).  A masked token is not written.
//
// Kernel 13, the packed elements: packed_elems_kernel reads each (frame,
// channel) row's detail part of lin in place (n elements after the root
// pad) and the (n,) pad mask, and writes |c| | sign << 30 where valid and
// -1 elsewhere, then the tail of E elements -1: 16 bytes a thread, a block
// row of blocks a (frame, channel) row, no division by n.
//
// Bound: bytes, for both.  At 4K kernel 12 reads 62,914,560 B of pairs
// and writes 283,115,520 B (9 bytes a slot): 0.103 ms at 3.35 TB/s.
// Kernel 13 reads 102 MB of coefficients and 8.5 MB of mask and writes
// 103 MB: 0.064 ms.  Every access is a 16-byte (mask: 4-byte, flags:
// 8-byte) word, neighbouring threads on neighbouring words.  Offsets are
// int64: N * padded_T may pass 2^31.
#include "common.cuh"

constexpr int THREADS = 256;
constexpr int PAIRS = 4;                  // pairs a thread (ops/finish.py)
constexpr int TILE = THREADS * PAIRS;     // pairs a tile
constexpr int SPECIAL_THREADS = 256;
constexpr int WARPS = SPECIAL_THREADS / 32;
constexpr int PACK_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// Row strides, in elements, of the (N, S) step tables.
struct StepRows {
  int64_t base, ns, cin, valid;
};

// Index of the first of s_key[lo, hi) greater than x (hi when none).
__device__ __forceinline__ int upper(const int* s_key, int lo, int hi,
                                     int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_key[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Index of the first of s_key[lo, hi) not less than x (hi when none).
__device__ __forceinline__ int lower(const int* s_key, int lo, int hi,
                                     int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_key[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Inclusive sum of v over the block's threads (THREADS of them); every
// thread gets its own, and *total the block's.  Unsigned: int32 sums wrap
// as the plain version's scatter_add does.
template <int NT>
__device__ __forceinline__ unsigned block_incl(unsigned v, unsigned* warp_sum,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sum[w] = v;
  __syncthreads();
  if (w == 0) {
    unsigned s = lane < NT / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += u;
    }
    if (lane < NT / 32) warp_sum[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += warp_sum[w - 1];
  *total = warp_sum[NT / 32 - 1];
  __syncthreads();  // warp_sum is free again
  return v;
}

__global__ void __launch_bounds__(THREADS, 4) finish_dense_kernel(
    const int* __restrict__ pairs, int64_t pair_row,
    const int* __restrict__ base, const int* __restrict__ nS,
    const int* __restrict__ cin, const unsigned char* __restrict__ valid,
    StepRows rows, int S, int64_t npair, int bx,
    int* __restrict__ val,
    int* __restrict__ raw, unsigned char* __restrict__ vli) {
  extern __shared__ int smem[];
  int* s_pos = smem;           // clamped pair base of each step
  int* s_sb = smem + S;        // pair base
  int* s_se = smem + 2 * S;    // pair base + nS
  unsigned* s_cum = (unsigned*)(smem + 3 * S);  // inclusive carry sums
  __shared__ unsigned warp_sum[THREADS / 32];

  const int64_t f = blockIdx.x / bx;  // bx blocks a frame
  const int* b = base + f * rows.base;
  const int* ns = nS + f * rows.ns;
  const int* ci = cin + f * rows.cin;
  const unsigned char* va = valid + f * rows.valid;
  // Stage the table: a thread a run of consecutive steps, so the carry sums
  // are one block scan of the runs' totals.
  const int per = (S + THREADS - 1) / THREADS;
  const int j0 = min(S, (int)threadIdx.x * per), j1 = min(S, j0 + per);
  unsigned run = 0;
  for (int j = j0; j < j1; ++j) {
    const int bp = b[j] >> 1;
    s_sb[j] = bp;
    s_pos[j] = bp < 0 ? 0 : (bp >= npair ? (int)(npair - 1) : bp);
    s_se[j] = (int)((unsigned)bp + (unsigned)ns[j]);
    run += (va[j] && ns[j] > 0) ? (unsigned)ci[j] : 0u;
    s_cum[j] = run;
  }
  unsigned total;
  const unsigned excl = block_incl<THREADS>(run, warp_sum, &total) - run;
  for (int j = j0; j < j1; ++j) s_cum[j] += excl;
  __syncthreads();
  // The order the fills rely on (a table only the card sees).
  for (int j = max(j0, 1); j < j1; ++j)
    if (b[j] < b[j - 1] || s_se[j] < s_se[j - 1]) __trap();

  const int* prow = pairs + f * pair_row;
  int* vrow = val + f * 2 * npair;
  int* rrow = raw + f * 2 * npair;
  unsigned char* frow = vli + f * 2 * npair;
  const int64_t tiles = (npair + TILE - 1) / TILE;
  for (int64_t t = blockIdx.x % bx; t < tiles; t += bx) {
    const int64_t p0 = t * TILE + (int64_t)threadIdx.x * PAIRS;
    if (p0 >= npair) continue;
    const int4 pw = *(const int4*)(prow + p0);
    const int pv[PAIRS] = {pw.x, pw.y, pw.z, pw.w};
    int zprev = p0 > 0 ? prow[p0 - 1] >> 1 : 0;
    int k = upper(s_pos, 0, S, (int)p0) - 1;  // last step at or before p0
    int ov[2 * PAIRS], orw[2 * PAIRS];
    unsigned flags0 = 0, flags1 = 0;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = (int)p0 + i;
      if (k + 1 < S && s_pos[k + 1] <= p) k = upper(s_pos, k + 1, S, p) - 1;
      int sb = 0, se = 0;
      unsigned cadd = 0;
      if (k >= 0) {
        sb = max(s_sb[k], 0);
        se = max(s_se[k], 0);
        if (s_pos[k] == p) {  // steps start here: the sum of their carries
          const int lo = lower(s_pos, 0, k, p);
          cadd = s_cum[k] - (lo > 0 ? s_cum[lo - 1] : 0u);
        }
      }
      const int zp = pv[i] >> 1, sg = pv[i] & 1;
      const bool in_sig = p < se;
      const unsigned runval =
          (unsigned)zp - (p == sb ? 0u : (unsigned)zprev) + cadd;
      ov[2 * i] = in_sig ? (int)runval : zp;
      ov[2 * i + 1] = sg;
      orw[2 * i] = 0;
      orw[2 * i + 1] = in_sig;
      if (i < 2) flags0 |= (unsigned)in_sig << (16 * i);
      else flags1 |= (unsigned)in_sig << (16 * (i - 2));
      zprev = zp;
    }
    const int64_t s0 = 2 * p0;
    int4* vo = (int4*)(vrow + s0);
    int4* ro = (int4*)(rrow + s0);
    vo[0] = make_int4(ov[0], ov[1], ov[2], ov[3]);
    vo[1] = make_int4(ov[4], ov[5], ov[6], ov[7]);
    ro[0] = make_int4(orw[0], orw[1], orw[2], orw[3]);
    ro[1] = make_int4(orw[4], orw[5], orw[6], orw[7]);
    *(uint2*)(frow + s0) = make_uint2(flags0, flags1);
  }
}

__global__ void __launch_bounds__(SPECIAL_THREADS) finish_special_kernel(
    const int* __restrict__ root, int64_t root_frame, int64_t root_ch,
    int pix0, int C, const int* __restrict__ root_cnt,
    const int* __restrict__ root_base, const int* __restrict__ planes_base,
    const int* __restrict__ planes, const unsigned char* __restrict__ rr_ok,
    const int* __restrict__ step_base, const int* __restrict__ step_nS,
    const int* __restrict__ rr_val, int G, const int* __restrict__ T,
    const int* __restrict__ carry_end, int* __restrict__ val,
    int* __restrict__ raw, unsigned char* __restrict__ vli,
    int64_t padded_T) {
  __shared__ unsigned warp_sum[WARPS];
  const int64_t f = blockIdx.x;
  int* v = val + f * padded_T;
  int* r = raw + f * padded_T;
  unsigned char* fl = vli + f * padded_T;
  const int tid = threadIdx.x;
  auto inside = [&](int64_t s) { return s >= 0 && s < padded_T; };

  // 1. root counts
  for (int c = tid; c < C; c += SPECIAL_THREADS) {
    const int64_t s = root_base[f * C + c];
    if (inside(s)) { v[s] = root_cnt[f * C + c]; fl[s] = 1; }
  }
  __syncthreads();
  // 2. root magnitudes and their raw counts, then 3. root signs: pass 2
  // writes each coefficient's magnitude at root_base + 1 + i + (nonzeros
  // before i), pass 3 the sign of a nonzero one after it.
  for (int pass = 2; pass <= 3; ++pass) {
    for (int c = 0; c < C; ++c) {
      const int cnt = root_cnt[f * C + c];
      if (cnt <= 0) continue;  // the same for every thread
      const int* x = root + f * root_frame + c * root_ch;
      const int rb = root_base[f * C + c];
      unsigned before = 0;
      for (int i0 = 0; i0 < pix0; i0 += SPECIAL_THREADS) {
        const int i = i0 + tid;
        const int xi = i < pix0 ? x[i] : 0;
        unsigned total;
        const unsigned nz = xi != 0;
        const unsigned rank =
            before + block_incl<SPECIAL_THREADS>(nz, warp_sum, &total) - nz;
        before += total;
        if (i >= pix0) continue;
        const int64_t s = (int64_t)rb + 1 + i + rank;
        if (pass == 2 && inside(s)) {
          v[s] = xi < 0 ? (int)(0u - (unsigned)xi) : xi;
          r[s] = cnt;
        }
        if (pass == 3 && xi != 0 && inside(s + 1)) {
          v[s + 1] = xi < 0;
          r[s + 1] = 1;
        }
      }
    }
    __syncthreads();
  }
  // 4. plane counts
  for (int c = tid; c < C; c += SPECIAL_THREADS) {
    const int64_t s = (int64_t)planes_base[f] + c;
    if (inside(s)) { v[s] = planes[f * C + c]; fl[s] = 1; }
  }
  __syncthreads();
  // 5. ref-run tokens
  for (int g = tid; g < G; g += SPECIAL_THREADS) {
    const int64_t k = f * G + g;
    if (!rr_ok[k]) continue;
    const int64_t s = (int64_t)step_base[k] + 2 * (int64_t)step_nS[k];
    if (inside(s)) { v[s] = rr_val[k]; fl[s] = 1; }
  }
  __syncthreads();
  // 6. the flush
  if (tid == 0) {
    const int64_t s = (int64_t)T[f] - 1;
    if (inside(s)) { v[s] = carry_end[f]; fl[s] = 1; }
  }
}

__global__ void __launch_bounds__(PACK_THREADS) packed_elems_kernel(
    const int* __restrict__ lin, int64_t lin_frame, int64_t lin_ch, int C,
    int64_t root_pad, int64_t n, const unsigned char* __restrict__ valid,
    int64_t rows, int64_t tail, int* __restrict__ out) {
  const int64_t row = blockIdx.x;  // a (frame, channel) row; `rows`: the tail
  const int64_t step = (int64_t)gridDim.y * PACK_THREADS * 4;
  int* o = out + row * n;
  if (row == rows) {
    for (int64_t j = ((int64_t)blockIdx.y * PACK_THREADS + threadIdx.x) * 4;
         j < tail; j += step)
      *(int4*)(o + j) = make_int4(-1, -1, -1, -1);
    return;
  }
  const int* x = lin + (row / C) * lin_frame + (row % C) * lin_ch + root_pad;
  for (int64_t j = ((int64_t)blockIdx.y * PACK_THREADS + threadIdx.x) * 4;
       j < n; j += step) {
    const int4 w = *(const int4*)(x + j);
    const unsigned ok = *(const unsigned*)(valid + j);
    const int e[4] = {w.x, w.y, w.z, w.w};
    int q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned mag = e[i] < 0 ? 0u - (unsigned)e[i] : (unsigned)e[i];
      q[i] = (ok >> (8 * i)) & 0xff
                 ? (int)(mag | ((unsigned)(e[i] < 0) << 30)) : -1;
    }
    *(int4*)(o + j) = make_int4(q[0], q[1], q[2], q[3]);
  }
}

// pairs (N, npair) at row stride pair_row and the (N, S) step tables at row
// strides base_row, ns_row, cin_row, valid_row -> the dense pass over every
// slot; then the special tokens, a block a frame.
extern "C" int dwt_finish_tokens(
    const void* pairs, int64_t pair_row, const void* base, int64_t base_row,
    const void* nS, int64_t ns_row, const void* cin, int64_t cin_row,
    const void* valid, int64_t valid_row, int64_t S, const void* root,
    int64_t root_frame, int64_t root_ch, int64_t pix0, int64_t C,
    const void* root_cnt, const void* root_base, const void* planes_base,
    const void* planes, const void* rr_ok, const void* step_base,
    const void* step_nS, const void* rr_val, int64_t G, const void* T,
    const void* carry_end, void* val, void* raw, void* vli, int64_t nframes,
    int64_t padded_T, void* stream) {
  if (nframes < 0 || padded_T < 0 || padded_T % (2 * PAIRS) || S < 0
      || pair_row % PAIRS || pix0 < 0 || C < 0 || G < 0
      || pix0 > 0x7fffffff || C > 0x7fffffff || G > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (nframes == 0 || padded_T == 0) return 0;
  const int64_t npair = padded_T / 2;
  const size_t smem = (size_t)S * 4 * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      finish_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (npair + TILE - 1) / TILE;
  // About 1,024 blocks in all (8 an SM of 132), each staging its frame's
  // table once for its tiles.
  int64_t bx = (1024 + nframes - 1) / nframes;
  if (bx > tiles) bx = tiles;
  if (nframes * bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  finish_dense_kernel<<<(unsigned)(nframes * bx), THREADS, smem,
                        (cudaStream_t)stream>>>(
      (const int*)pairs, pair_row, (const int*)base, (const int*)nS,
      (const int*)cin, (const unsigned char*)valid,
      StepRows{base_row, ns_row, cin_row, valid_row}, (int)S, npair, (int)bx,
      (int*)val, (int*)raw, (unsigned char*)vli);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_special_kernel<<<(unsigned)nframes, SPECIAL_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int*)root, root_frame, root_ch, (int)pix0, (int)C,
      (const int*)root_cnt, (const int*)root_base, (const int*)planes_base,
      (const int*)planes, (const unsigned char*)rr_ok, (const int*)step_base,
      (const int*)step_nS, (const int*)rr_val, (int)G, (const int*)T,
      (const int*)carry_end, (int*)val, (int*)raw, (unsigned char*)vli,
      padded_T);
  return (int)cudaGetLastError();
}

// lin (N, C, nlin) at strides lin_frame, lin_ch, valid (n,) -> out
// (N * C * n + tail) int32.
extern "C" int dwt_packed_elems(const void* lin, int64_t lin_frame,
                                int64_t lin_ch, int64_t nframes, int64_t C,
                                int64_t root_pad, int64_t n,
                                const void* valid, int64_t tail, void* out,
                                void* stream) {
  if (nframes < 0 || C < 1 || C > 0x7fffffff || n < 0 || n % 4 || tail < 0
      || tail % 4 || root_pad % 4 || lin_frame % 4 || lin_ch % 4)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = nframes * C;
  if (rows + 1 > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  int64_t by = ((n > tail ? n : tail) / 4 + PACK_THREADS - 1) / PACK_THREADS;
  if (by > 65535) by = 65535;
  if (by < 1) by = 1;
  packed_elems_kernel<<<dim3((unsigned)(rows + 1), (unsigned)by),
                        PACK_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)lin, lin_frame, lin_ch, (int)C, root_pad, n,
      (const unsigned char*)valid, rows, tail, (int*)out);
  return (int)cudaGetLastError();
}
