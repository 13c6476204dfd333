// The encoder's codeword pieces: each token's bit length, final-stream bit
// offset, word index and <= 3 uint32 word pieces for N frames' token
// arrays, and the per-2048-slot sums of the lengths, in one launch.
//
// No TPU kernel to replace: the JAX package runs
// dwt_tpu/codec/encoder.py:_codeword_contribs as XLA in uint32 (and its
// first level of _bit_partials), one compiled program on the TPU.  The
// plain PyTorch version (ops/codeword.py:codeword_pieces_plain) makes the
// same passes eagerly, in int64: some 70 launches over the (N, T) slots.
//
// Input: val, raw, vli and ord, the (N, T) int32 token values, raw bit
// counts, bool VLI flags and int32 VLI orders, read in place (rows of unit
// stride, each array at its own row stride: the token finisher's arrays
// keep a spare slot after each frame); site and nref, the (N, S) int32
// injection sites and refinement-bit counts of the frames' steps.  For a
// VLI token of value v at order s, k = max(0, ilog2(v + 2^s) - s) (int32,
// as the JAX package's _vli_k) and the codeword is k zeros, a 1 and s + k
// payload bits, 2k + s + 1 bits as (lo, hi) uint32 halves; another token
// is raw[t] bits of v.  inject[t] sums nref over the steps whose site,
// clamped to [0, T], is t (site T is dropped).  Output: off = incl - nbits,
// incl the inclusive int32 scan (wrapping) of nbits + inject along the
// row; widx = (off >> 5) + f * nwords; c0 = lo << sh, c1 = lo >> 1 >>
// (31 - sh) | hi << sh, c2 = hi >> 1 >> (31 - sh) with sh = off & 31, all
// (N, T) int32; and chunks, (N, ceil(T / 2048)), the sums of nbits over
// each 2048 slots of a row.
//
// Bound: bytes.  A slot's 13 bytes read once (4 + 4 + 1 + 4) and its 20
// written once; a few integer operations a slot.
//
// codeword_kernel: one CUDA block a tile of TILE consecutive slots of one
// frame, tiles numbered by an atomic ticket (a tile's predecessors are
// then resident or done).  Each thread loads ITEMS slots striped across
// the block (coalesced whatever the row's alignment), keeps each slot's
// (lo, hi) and length in registers, and stores the lengths in shared
// memory, a row of ITEMS a thread padded by one word (conflict-free in
// both directions).  The block walks its frame's (S) step table once and
// adds the refinement bits of the sites in its tile with shared atomics
// (no (N, T + 1) zero fill and scatter).  Each thread then scans its own
// row, the warps' totals give the tile's aggregate, and one warp runs a
// single-pass decoupled look-back (Merrill and Garland; LightScan) over
// its predecessors' 64-bit status words (a kind and a 32-bit sum, release
// and acquire), 32 at a time, until a tile's inclusive sum; the frame's
// first tile publishes its inclusive sum at once, so no sum crosses
// frames.  The inclusive offsets go back through shared memory, and each
// slot's five words leave striped, each written once.  The tile is two
// chunks of 2048 slots, whose length sums the warps reduce.
//
// The status words and the ticket live in a scratch the wrapper zeroes
// once a device and stream; the block that finishes last clears them for
// the next call.  Offsets are int64: N * T may pass 2^31.
#include "common.cuh"

constexpr int THREADS = 256;            // threads a tile
constexpr int ITEMS = 16;               // slots a thread
constexpr int TILE = THREADS * ITEMS;   // slots a tile
constexpr int CHUNK = 2048;             // slots a chunk sum
constexpr int ROW = ITEMS + 1;          // shared words a thread's row
constexpr int WARPS = THREADS / 32;
static_assert(TILE == 2 * CHUNK, "a tile is two chunks");
// A tile's status: its kind in the high word (0: not published), its sum
// in the low word.
constexpr unsigned long long AGG = 1ull << 32, INC = 2ull << 32;

__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// Slot x of the tile in shared memory: thread x / ITEMS's row.
__device__ __forceinline__ int at(int x) {
  return (x / ITEMS) * ROW + x % ITEMS;
}

struct Shared {
  unsigned len[THREADS * ROW];  // lengths + injections, then inclusive sums
  unsigned wsum[WARPS];         // each warp's total
  unsigned csum[2][WARPS];      // each warp's length sums of both chunks
  unsigned ticket;
  unsigned excl;                // the tile's exclusive prefix
  int last;                     // this block finished last
};

__global__ void __launch_bounds__(THREADS, 2) codeword_kernel(
    const int* __restrict__ val, int64_t val_row,
    const int* __restrict__ raw, int64_t raw_row,
    const unsigned char* __restrict__ vli, int64_t vli_row,
    const int* __restrict__ ord, int64_t ord_row,
    const int* __restrict__ site, const int* __restrict__ nref, int S,
    int* __restrict__ off, int* __restrict__ widx, int* __restrict__ c0,
    int* __restrict__ c1, int* __restrict__ c2, int* __restrict__ chunks,
    int64_t T, int tiles_per_frame, int64_t nchunk, int64_t nwords,
    unsigned* __restrict__ ctr, unsigned long long* __restrict__ status) {
  __shared__ Shared sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) sh.ticket = atomicAdd(&ctr[0], 1u);
  __syncthreads();
  const unsigned tile = sh.ticket;
  const int64_t f = tile / tiles_per_frame;
  const int j = (int)(tile % tiles_per_frame);
  const int64_t t0 = (int64_t)j * TILE;
  const int n = T - t0 < TILE ? (int)(T - t0) : TILE;  // slots here

  // 1. Each slot's length and codeword halves, striped.
  const int* vr = val + f * val_row + t0;
  const int* rr = raw + f * raw_row + t0;
  const unsigned char* fr = vli + f * vli_row + t0;
  const int* orr = ord + f * ord_row + t0;
  unsigned lo[ITEMS], hi[ITEMS], nb[ITEMS];
  unsigned cs0 = 0, cs1 = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int x = i * THREADS + t;
    int v = 0, r = 0, s = 0;
    bool isv = false;
    if (x < n) {
      v = __ldg(vr + x);
      r = __ldg(rr + x);
      isv = __ldg(fr + x) != 0;
      s = __ldg(orr + x);
    }
    lo[i] = (unsigned)v;
    hi[i] = 0;
    nb[i] = (unsigned)r;
    if (isv) {
      const int u = (int)((unsigned)v + (1u << s));
      const int k = max(31 - __clz(u) - s, 0);
      const unsigned payload = (unsigned)v - ((1u << (s + k)) - (1u << s));
      lo[i] = (1u << k) | (payload << (k + 1));
      hi[i] = payload >> (31 - k);
      nb[i] = (unsigned)(2 * k + s + 1);
    }
    sh.len[at(x)] = nb[i];
    if (i < ITEMS / 2) cs0 += nb[i]; else cs1 += nb[i];
  }
  __syncthreads();

  // 2. The refinement bits injected at the tile's sites.
  const int* fs = site + f * S;
  const int* fn = nref + f * S;
  for (int q = t; q < S; q += THREADS) {
    const int64_t g = __ldg(fs + q);
    const int64_t p = (g < 0 ? 0 : g > T ? T : g) - t0;  // clamped, in tile
    if (p >= 0 && p < n)
      atomicAdd(&sh.len[at((int)p)], (unsigned)__ldg(fn + q));
  }
  __syncthreads();

  // 3. Each thread scans its row; the warps' totals give the tile's.
  unsigned acc[ITEMS];
  unsigned run = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    run += sh.len[t * ROW + i];
    acc[i] = run;
  }
  unsigned inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(~0u, inc, d);
    if (lane >= d) inc += y;
  }
  cs0 = warp_sum(cs0);
  cs1 = warp_sum(cs1);
  if (lane == 31) sh.wsum[warp] = inc;
  if (lane == 0) {
    sh.csum[0][warp] = cs0;
    sh.csum[1][warp] = cs1;
  }
  __syncthreads();
  unsigned wpre = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const unsigned ws = sh.wsum[w];
    wpre += w < warp ? ws : 0u;
    agg += ws;
  }
  const unsigned tpre = wpre + inc - run;  // the thread's prefix in the tile
  if (t < 2 && t * CHUNK < n) {
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += sh.csum[t][w];
    chunks[f * nchunk + 2 * (int64_t)j + t] = (int)c;
  }

  // 4. Warp 0: the tile's status and the look-back.
  if (warp == 0) {
    unsigned long long* mine = status + tile;
    unsigned excl = 0;
    if (j == 0) {
      if (lane == 0) st_release64(mine, INC | agg);
    } else {
      if (lane == 0) st_release64(mine, AGG | agg);
      const int64_t first = (int64_t)tile - j;  // the frame's first tile
      for (int64_t q0 = (int64_t)tile - 1;; q0 -= 32) {
        const int64_t q = q0 - lane;
        unsigned long long st = INC;  // before the frame: an inclusive 0
        if (q >= first)
          while (((st = ld_acquire64(status + q)) >> 32) == 0) __nanosleep(32);
        const unsigned incm = __ballot_sync(~0u, (st >> 32) == 2);
        const int stop = incm ? __ffs(incm) - 1 : 31;
        excl += warp_sum(lane <= stop ? (unsigned)st : 0u);
        if (incm) break;
      }
      if (lane == 0) st_release64(mine, INC | (excl + agg));
    }
    if (lane == 0) sh.excl = excl;
  }
  __syncthreads();

  // 5. The inclusive sums back, then each slot's words out, striped.
  const unsigned base = sh.excl + tpre;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) sh.len[t * ROW + i] = base + acc[i];
  __syncthreads();
  const int64_t ob = f * T + t0;
  const unsigned fw = (unsigned)(f * nwords);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int x = i * THREADS + t;
    if (x < n) {
      const int o = (int)(sh.len[at(x)] - nb[i]);
      const unsigned s = (unsigned)o & 31u, sc = 31u - s;
      off[ob + x] = o;
      widx[ob + x] = (int)((unsigned)(o >> 5) + fw);
      c0[ob + x] = (int)(lo[i] << s);
      c1[ob + x] = (int)(((lo[i] >> 1) >> sc) | (hi[i] << s));
      c2[ob + x] = (int)((hi[i] >> 1) >> sc);
    }
  }

  // 6. The block that finishes last clears the statuses and counters.
  if (t == 0) {
    __threadfence();
    sh.last = atomicAdd(&ctr[1], 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (sh.last) {
    for (unsigned i = t; i < gridDim.x; i += THREADS) status[i] = 0;
    if (t == 0) {
      ctr[0] = 0;
      ctr[1] = 0;
    }
  }
}

// val, raw, ord (N, T) int32 and vli (N, T) bool, each at its row stride;
// site, nref (N, S) int32 -> off, widx, c0, c1, c2 (N, T) int32 and
// chunks (N, ceil(T / 2048)) int32; scratch: 16 + 8 * cap zeroed bytes
// (two counters and an 8-byte status a tile), cap >= the tiles.
extern "C" int dwt_codeword_pieces(
    const void* val, int64_t val_row, const void* raw, int64_t raw_row,
    const void* vli, int64_t vli_row, const void* ord, int64_t ord_row,
    const void* site, const void* nref, int64_t S, void* off, void* widx,
    void* c0, void* c1, void* c2, void* chunks, int64_t nframes, int64_t T,
    int64_t nwords, void* scratch, int64_t cap, void* stream) {
  if (nframes < 0 || T < 0 || S < 0 || cap < 0 || nwords < 0)
    return (int)cudaErrorInvalidValue;
  if (nframes == 0 || T == 0) return 0;
  const int64_t per = (T + TILE - 1) / TILE;
  const int64_t tiles = nframes * per;
  if (tiles > cap || per > 0x7fffffff || S > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  unsigned char* s = (unsigned char*)scratch;
  codeword_kernel<<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)val, val_row, (const int*)raw, raw_row,
      (const unsigned char*)vli, vli_row, (const int*)ord, ord_row,
      (const int*)site, (const int*)nref, (int)S, (int*)off, (int*)widx,
      (int*)c0, (int*)c1, (int*)c2, (int*)chunks, T, (int)per,
      (T + CHUNK - 1) / CHUNK, nwords, (unsigned*)s,
      (unsigned long long*)(s + 16));
  return (int)cudaGetLastError();
}
