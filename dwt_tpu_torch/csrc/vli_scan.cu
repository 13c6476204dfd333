// The encoder's adaptive-VLI order scan (vli.h:67-84): the order state
// entering every token of N frames' token arrays, in one launch.
//
// No TPU kernel to replace: the JAX package runs the whole of
// dwt_tpu/codec/encoder.py:_vli_orders as XLA (the transition parameters
// of _vli_ab, a lax.scan over each block's tokens and an associative_scan
// over the blocks' transition maps), one compiled program on the TPU.
// The plain PyTorch version (ops/vli_scan.py:vli_orders_plain) makes the
// same passes eagerly: _vli_ab, a transpose, two loops of 128 steps, a
// Hillis-Steele composition and a transpose back.
//
// Input: val, the (N, T) int32 token values, and vli, the (N, T) bool
// flags of the tokens that are VLI values, both read in place (rows of
// unit stride, each row at its own stride: the token finisher's arrays
// keep a spare slot after each frame).  A VLI token of value v has
// A = ilog2(v) (0 for v < 1) and B = ceil_log2(2^(A+1) - v) (in int32,
// as tokens.py:_vli_ab computes it: 2 << 30 wraps), and takes order s to
// clamp(max(s, A + (s >= B)) - 2, 0, 30); another token leaves it.
// Output: the (N, T) int32 orders, each token's order before its own
// transition; every frame starts in order 0.
//
// Bound: bytes, each token's 5 bytes read once and its 4-byte order
// written once.  Every transition is non-decreasing in s, so every
// composed map is too: once a walk gives f(0) == f(30), the map is a
// constant and the exit order no longer depends on the entry order.  On
// encoder tokens that happens within a few dozen tokens.  So:
//
// vli_orders_kernel: one CUDA block a tile of TILE consecutive tokens of
// one frame, tiles numbered by an atomic ticket (a tile's predecessors are
// then resident or done).  The block reads the tile's values and flags
// once (16-byte words where the rows allow), computes each token's
// (A, B, VLI) as a 16-bit word in registers, and stores the tile in
// shared memory, one row of SPAN tokens a thread, rows padded by 16 bytes
// so that a warp's 16-byte reads of eight rows hit distinct banks (no
// transpose in device memory).  Each thread walks its row with two states
// a 32-bit word, f(0) and f(30), one DPX max of three 16-bit pairs
// (__vimax3_u16x2) a token; from the first 8-token chunk entered with
// f(0) == f(30) on, it writes each token's order over its parameter.  A
// row that never collapses with a VLI token in it walks again with its
// map at all 31 orders (16 words); a row without one is the identity.
// The block composes its rows into the tile's aggregate: a constant is
// published at once as the tile's inclusive order, which cuts the chain;
// otherwise the identity or the 31-byte map, and then a single-pass
// decoupled look-back (Merrill and Garland) by one warp over the
// predecessors' status words (release and acquire, the maps composed by
// shuffles) gives the tile's entry order, and its inclusive one is
// published.  Rows whose entry comes from a constant row earlier in the
// tile replay their first chunks while the look-back runs; the others
// after it.  Last, the orders leave as int32, 16 bytes a thread.
//
// The status words and ticket live in a scratch the wrapper zeroes once
// a device and stream; the block that finishes last clears them for the
// next call.  Offsets are int64: N * T may pass 2^31.
#include "common.cuh"

constexpr int THREADS = 128;          // threads a tile
constexpr int SPAN = 128;             // tokens a thread's row
constexpr int CHUNK = 8;              // tokens a 16-byte shared word
constexpr int TILE = THREADS * SPAN;  // tokens a tile
constexpr int ROW = SPAN / CHUNK + 1; // 16-byte words a row: one of pad
constexpr int UNROLL = 8;             // loads a thread keeps in flight
constexpr unsigned VLI = 1u << 11;    // a token's word: A | B << 5 | VLI
constexpr unsigned IDENT = 32u << 5;  // a token that is no VLI value
// Tile status kinds, in bits 0-1 (0: not published); an inclusive order
// in bits 2-6.
constexpr unsigned INC = 1, AGG_ID = 2, AGG_MAP = 3;

// A token's word from its value and flag (tokens.py:_vli_ab less its +1
// bias: 0 there is IDENT here).
__device__ __forceinline__ unsigned token_word(int v, bool vli) {
  if (!vli) return IDENT;
  const int a = v >= 1 ? 31 - __clz(v) : 0;
  const int rem = (int)((2u << a) - (unsigned)v);
  const int b = rem <= 1 ? 0 : 32 - __clz(rem - 1);
  return (unsigned)a | (unsigned)b << 5 | VLI;
}

// One token (its word in both 16-bit halves of w2) on two orders a word:
// s -> max(s, a + (s >= b), d) - d with d = 2 for a VLI token (the max
// with 2 is the clamp at 0) and, for another, a = 0, b = 32, d = 0: the
// identity.  Orders stay below 32, so a + (s >= b) <= 32 and the result
// <= 30: the clamp at 30 never binds.  s >= b is the top bit of
// (s | 0x8000) - b in each half (no borrow crosses halves).
__device__ __forceinline__ unsigned step(unsigned m, unsigned w2) {
  const unsigned aa = w2 & 0x001F001Fu;
  const unsigned bb = (w2 >> 5) & 0x003F003Fu;
  const unsigned dd = (w2 >> 10) & 0x00020002u;
  const unsigned ge = (((m | 0x80008000u) - bb) >> 15) & 0x00010001u;
  return __vimax3_u16x2(m, aa + ge, dd) - dd;
}

// The low and the high token word of a shared 32-bit word, in both halves.
__device__ __forceinline__ unsigned lo2(unsigned q) {
  return __byte_perm(q, 0, 0x1010);
}
__device__ __forceinline__ unsigned hi2(unsigned q) {
  return __byte_perm(q, 0, 0x3232);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

struct Tile {
  uint4 rows[THREADS * ROW];             // token words, then orders
  unsigned char maps[THREADS][32];       // general rows' maps
  unsigned char agg[32];                 // a map on its way to or from L2
  unsigned char cval[THREADS];           // constant rows' exit orders
  unsigned cmask[THREADS / 32];          // rows whose map is a constant
  unsigned gmask[THREADS / 32];          // rows with a general map
  unsigned ticket;
  int entry;                             // the tile's entry order
  int last;                              // this block finished last
};

// Applies the general maps of rows [from, to) to s, in row order.
__device__ __forceinline__ int through(const Tile& sh, int s, int from,
                                       int to) {
  for (int w = from >> 5; w <= (to - 1) >> 5 && from < to; ++w) {
    unsigned m = sh.gmask[w];
    if (w == from >> 5) m &= ~0u << (from & 31);
    if (w == (to - 1) >> 5) m &= ~0u >> (31 - ((to - 1) & 31));
    while (m) {
      s = sh.maps[w * 32 + __ffs(m) - 1][s];
      m &= m - 1;
    }
  }
  return s;
}

// The last row below t whose map is a constant, or -1.
__device__ __forceinline__ int last_const(const Tile& sh, int t) {
  for (int w = (t - 1) >> 5; w >= 0 && t > 0; --w) {
    unsigned m = sh.cmask[w];
    if (w == (t - 1) >> 5) m &= ~0u >> (31 - ((t - 1) & 31));
    if (m) return w * 32 + 31 - __clz(m);
  }
  return -1;
}

// Replays the first ``chunks`` chunks of a row from order s, writing each
// token's order over its word.
__device__ __forceinline__ void replay(uint4* row, int chunks, int s) {
  unsigned m = (unsigned)s * 0x00010001u;
  for (int c = 0; c < chunks; ++c) {
    const uint4 q = row[c];
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
    unsigned o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned a = m & 0xFFFFu;
      m = step(m, lo2(w[k]));
      o[k] = a | (m & 0xFFFFu) << 16;
      m = step(m, hi2(w[k]));
    }
    row[c] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

__global__ void __launch_bounds__(THREADS) vli_orders_kernel(
    const int* __restrict__ val, int64_t val_row,
    const unsigned char* __restrict__ vli, int64_t vli_row,
    int* __restrict__ out, int64_t T, int tiles_per_frame, int vec,
    unsigned* __restrict__ ctr, unsigned* __restrict__ status,
    uint4* __restrict__ tile_maps) {
  __shared__ Tile sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) sh.ticket = atomicAdd(&ctr[0], 1u);
  __syncthreads();
  const unsigned tile = sh.ticket;
  const int64_t f = tile / tiles_per_frame;
  const int j = (int)(tile % tiles_per_frame);
  const int64_t t0 = (int64_t)j * TILE;
  const int n = T - t0 < TILE ? (int)(T - t0) : TILE;  // tokens here
  const int* vrow = val + f * val_row + t0;
  const unsigned char* frow = vli + f * vli_row + t0;
  int* orow = out + f * T + t0;
  unsigned short* words = (unsigned short*)sh.rows;  // token x: (x / SPAN)
                                                     // * ROW * 8 + x % SPAN

  // 1. Stage the tile's token words.
  if (vec & 1) {  // 16 bytes of values and 4 of flags: 4 tokens a load
    for (int i0 = 0; i0 < TILE / 4 / THREADS; i0 += UNROLL) {
      int4 v[UNROLL];
      unsigned fl[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int x = 4 * (t + THREADS * (i0 + u));
        v[u] = make_int4(0, 0, 0, 0);
        fl[u] = 0;
        if (x < n) {
          v[u] = __ldg((const int4*)(vrow + x));
          fl[u] = __ldg((const unsigned*)(frow + x));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int x = 4 * (t + THREADS * (i0 + u));
        const unsigned p0 = token_word(v[u].x, fl[u] & 0xFFu);
        const unsigned p1 = token_word(v[u].y, (fl[u] >> 8) & 0xFFu);
        const unsigned p2 = token_word(v[u].z, (fl[u] >> 16) & 0xFFu);
        const unsigned p3 = token_word(v[u].w, fl[u] >> 24);
        *(uint2*)(words + (x / SPAN) * ROW * CHUNK + x % SPAN) =
            make_uint2(p0 | p1 << 16, p2 | p3 << 16);
      }
    }
  } else {  // a token a load, any alignment
    for (int i0 = 0; i0 < SPAN; i0 += UNROLL) {
      int v[UNROLL];
      bool fl[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int x = t + THREADS * (i0 + u);
        v[u] = 0;
        fl[u] = false;
        if (x < n) {
          v[u] = __ldg(vrow + x);
          fl[u] = __ldg(frow + x) != 0;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int x = t + THREADS * (i0 + u);
        words[(x / SPAN) * ROW * CHUNK + x % SPAN] =
            (unsigned short)token_word(v[u], fl[u]);
      }
    }
  }
  __syncthreads();

  // 2. Walk the row with f(0) and f(30); orders from the first chunk
  // entered with a constant map on.
  uint4* row = sh.rows + t * ROW;
  unsigned m = 30u << 16;
  int known = 0;  // chunks before the constant suffix
  unsigned any = 0;
  for (int c = 0; c < SPAN / CHUNK; ++c) {
    const uint4 q = row[c];
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
    const bool fixed = (m & 0xFFFFu) == (m >> 16);
    known = fixed ? known : c + 1;
    unsigned o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned a = m & 0xFFFFu;
      m = step(m, lo2(w[k]));
      o[k] = a | (m & 0xFFFFu) << 16;
      m = step(m, hi2(w[k]));
      any |= w[k];
    }
    if (fixed) row[c] = make_uint4(o[0], o[1], o[2], o[3]);
  }
  const bool is_const = (m & 0xFFFFu) == (m >> 16);
  const bool general = !is_const && (any & (VLI | VLI << 16));
  if (is_const) sh.cval[t] = (unsigned char)m;
  if (general) {  // the row's map at all 31 orders, two a word
    unsigned mm[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) mm[k] = 0x00010000u + 0x00020002u * k;
    for (int c = 0; c < SPAN / CHUNK; ++c) {
      const uint4 q = row[c];
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned w2 = h ? hi2(w[k]) : lo2(w[k]);
#pragma unroll
          for (int s = 0; s < 16; ++s) mm[s] = step(mm[s], w2);
        }
      }
    }
    uint4* dst = (uint4*)sh.maps[t];
    unsigned b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      b[k] = __byte_perm(mm[2 * k], mm[2 * k + 1], 0x6420);
    dst[0] = make_uint4(b[0], b[1], b[2], b[3]);
    dst[1] = make_uint4(b[4], b[5], b[6], b[7]);
  }
  const unsigned cb = __ballot_sync(~0u, is_const);
  const unsigned gb = __ballot_sync(~0u, general);
  if (lane == 0) {
    sh.cmask[warp] = cb;
    sh.gmask[warp] = gb;
  }
  __syncthreads();

  // 3. Warp 0: the tile's aggregate, its status, the look-back.
  const int p = last_const(sh, t);
  if (warp == 0) {
    const int L = last_const(sh, THREADS);
    // F(lane): the tile's map at entry order ``lane`` (a constant when a
    // row's is).
    const int F = through(sh, L >= 0 ? sh.cval[L] : lane, L + 1, THREADS);
    const int F0 = __shfl_sync(~0u, F, 0), F30 = __shfl_sync(~0u, F, 30);
    unsigned* mine = status + tile;
    const bool inclusive = j == 0 || F0 == F30;
    if (inclusive) {
      if (lane == 0) st_release(mine, INC | (unsigned)F0 << 2);
    } else {
      const bool ident = __ballot_sync(~0u, F == lane) == ~0u;
      if (!ident) {
        sh.agg[lane] = (unsigned char)F;
        __syncwarp();
        if (lane == 0) {
          tile_maps[2 * (int64_t)tile] = ((const uint4*)sh.agg)[0];
          tile_maps[2 * (int64_t)tile + 1] = ((const uint4*)sh.agg)[1];
          __threadfence();
        }
        __syncwarp();
      }
      if (lane == 0) st_release(mine, ident ? AGG_ID : AGG_MAP);
    }
    // The entry order, which row 0 needs whatever the tile's aggregate.
    // H(lane): the order entering this tile from order ``lane`` entering
    // the oldest predecessor read so far.  The frame's first tile
    // publishes its inclusive order at once, so the walk ends there.
    int e = 0, H = lane;
    for (int64_t q = (int64_t)tile - 1; j > 0; --q) {
      unsigned st = 0;
      if (lane == 0) {
        while ((st = ld_acquire(status + q)) == 0) __nanosleep(32);
        if ((st & 3) == AGG_MAP) {
          ((uint4*)sh.agg)[0] = __ldcg(tile_maps + 2 * q);
          ((uint4*)sh.agg)[1] = __ldcg(tile_maps + 2 * q + 1);
        }
      }
      st = __shfl_sync(~0u, st, 0);
      __syncwarp();
      if ((st & 3) == INC) {
        e = __shfl_sync(~0u, H, (int)(st >> 2));
        break;
      }
      if ((st & 3) == AGG_MAP) H = __shfl_sync(~0u, H, sh.agg[lane]);
      __syncwarp();
    }
    if (!inclusive) {
      const int inc = __shfl_sync(~0u, F, e);
      if (lane == 0) st_release(mine, INC | (unsigned)inc << 2);
    }
    if (lane == 0) sh.entry = e;
  }

  // 4. Replay each row's first chunks from its entry order: rows after a
  // constant row at once, the others once the look-back is done.
  if (p >= 0 && t * SPAN < n)
    replay(row, known, through(sh, sh.cval[p], p + 1, t));
  __syncthreads();
  if (p < 0 && t * SPAN < n) replay(row, known, through(sh, sh.entry, 0, t));
  __syncthreads();

  // 5. The orders out, as int32.
  if (vec & 2) {  // T % 4 == 0: 16 bytes a store
    for (int x = 4 * t; x < n; x += 4 * THREADS) {
      const uint2 o = *(const uint2*)(words + (x / SPAN) * ROW * CHUNK +
                                      x % SPAN);
      *(int4*)(orow + x) = make_int4(o.x & 0xFFFF, o.x >> 16, o.y & 0xFFFF,
                                     o.y >> 16);
    }
  } else {
    for (int x = t; x < n; x += THREADS)
      orow[x] = words[(x / SPAN) * ROW * CHUNK + x % SPAN];
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

// val (N, T) int32 at row stride val_row, vli (N, T) bool at vli_row ->
// out (N, T) int32; scratch: 16 + 36 * cap zeroed bytes (two counters, a
// 32-byte map and a 4-byte status a tile), cap >= the tiles.  vec: bit 0,
// 16-byte loads (every row of both inputs 16-byte aligned); bit 1, 16-byte
// stores (T % 4 == 0).
extern "C" int dwt_vli_orders(const void* val, int64_t val_row,
                              const void* vli, int64_t vli_row, void* out,
                              int64_t nframes, int64_t T, void* scratch,
                              int64_t cap, int vec, void* stream) {
  if (nframes < 0 || T < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  if (nframes == 0 || T == 0) return 0;
  const int64_t per = (T + TILE - 1) / TILE;
  const int64_t tiles = nframes * per;
  if (tiles > cap || per > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  unsigned char* s = (unsigned char*)scratch;
  vli_orders_kernel<<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)val, val_row, (const unsigned char*)vli, vli_row,
      (int*)out, T, (int)per, vec, (unsigned*)s,
      (unsigned*)(s + 16 + 32 * cap), (uint4*)(s + 16));
  return (int)cudaGetLastError();
}
