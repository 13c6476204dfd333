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
// codeword_kernel: persistent blocks, as many as the card holds at once
// (the SMs times the blocks an SM takes), each looping over tiles of TILE
// consecutive slots of one frame (one chunk) taken by an atomic ticket, in
// increasing order.  A block holds its current tile and the next one.  At
// the top of a turn warp 0 issues the bulk copies (TMA, cp.async.bulk
// completing on the stage's mbarrier) of the next tile's four token rows
// into the other stage, one lane a row, so they are in flight while the
// current tile scans, looks back and stores.  A row is copied as the
// 16-byte window that covers it, [start rounded down, end rounded up),
// kept inside the storage: the token finisher's rows lie at stride
// padded_T and start on 16-byte words, but the kernel takes rows at any
// row stride (a view's rows, at stride T + 1 in the tests, start
// anywhere); bytes of the row outside the storage's whole 16-byte words
// come by plain loads.  The frame's (S) step table is staged the same
// way, into one buffer, only when the next tile is in another frame and
// only once the current tile's injections are in (warps 1 and up add them
// from it by shared atomics into a buffer of TILE words, which the store
// pass clears); a stage's barrier takes two arrivals, the rows' and the
// table's.
//
// A thread takes groups of 4 consecutive slots, striped across the block
// (ROUNDS of them, the tile's slots in order round by round): 16-byte
// shared loads (two, and a word select, where the row's head is not 16-
// byte aligned; bytes by a funnel shift for the flags).  Pass 1 sums each
// group's lengths and injections; a shuffle scan a round and the warps'
// totals give each group's prefix in the tile and the tile's aggregate.
// Warp 0 then runs a single-pass decoupled look-back (Merrill and
// Garland; LightScan) over the predecessors' 64-bit status words (a kind
// and a 32-bit sum, release and acquire), 32 a step, until an inclusive
// sum, waiting only on statuses nearer than the nearest inclusive one; a
// frame's first tile is inclusive at once, so no sum crosses frames.
// Meanwhile the other warps wait for the next tile's rows and publish its
// status (its lengths and the bits of its sites), so a tile's status
// never waits on a look-back of the block that holds it; the ticket of
// the tile after it is taken once the look-back is done.  Then warp 1
// carries the inclusive sum forward over the run of following tiles
// whose aggregates are published (any block may: a tile's inclusive sum
// is one value), so later look-backs find one close by.  Pass 2 reads the
// lengths and halves back from the stage (nothing a slot is held in
// registers across the look-back) and writes each output once, 16 bytes
// a thread where the output row is 16-byte aligned (padded_T a multiple
// of 4; always on the encoder's path).
//
// No deadlock: tickets are taken in increasing order, by running blocks
// only, and a block holds at most one tile it has not started, whose
// status its other warps publish as soon as its rows land.  The lowest
// tile whose inclusive sum is not yet published is either its block's
// current tile, whose look-back reads only lower tiles, all published,
// or its block's next tile, whose current tile is lower, hence past its
// look-back, and needs only the next tile's rows to move on; either way
// it gets published.
//
// The status words and the ticket live in a scratch the wrapper zeroes
// once a device and stream; the last persistent block to exit clears them
// for the next call.  Offsets are int64: N * T may pass 2^31.
#include "common.cuh"

constexpr int THREADS = 256;              // threads a block
constexpr int TILE = 2048;                // slots a tile
constexpr int CHUNK = 2048;               // slots a chunk sum
constexpr int GROUPS = TILE / 4;          // groups of 4 slots a tile
constexpr int ROUNDS = GROUPS / THREADS;  // groups a thread
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 3;             // blocks an SM: <= 80 registers
static_assert(TILE == CHUNK && ROUNDS * THREADS == GROUPS,
              "a tile is one chunk, whole groups a thread");
// Bytes of a staged row: an int32 row's window (a head of up to 12 bytes
// before the tile's first slot, up to 12 past its last) and the 16 bytes
// that a thread reads past its last group; the flag row's (a head of up
// to 15 bytes).  A stage holds the val, raw and ord rows, then the flags.
constexpr int WROW = 4 * TILE + 32;
constexpr int FROW = TILE + 48;
constexpr int STAGE = 3 * WROW + FROW;
constexpr int INJ = 4 * TILE;             // injected bits a slot
static_assert(WROW % 16 == 0 && FROW % 16 == 0, "16-byte rows");
// A tile's status: its kind in the high word (0: not published), its sum
// in the low word.
constexpr unsigned long long AGG = 1ull << 32, INC = 2ull << 32;

// Bytes of one staged step-table row of S int32 entries.
__host__ __device__ constexpr int table_row(int S) {
  return (4 * S + 24 + 15) & ~15;
}

// Dynamic shared memory of a block: two stages, the injections, the
// frame's sites and refinement-bit counts.
__host__ __device__ constexpr int smem_bytes(int S) {
  return 2 * STAGE + INJ + 2 * table_row(S);
}

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;"
               :: "r"(smem_addr(bar)) : "memory");
}

// One of a phase's two arrivals, which also expects ``bytes`` of bulk
// copies in the phase.
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Args {
  // val, raw, ord (int32) and the flags (bytes); their row strides in
  // elements; the first and past-the-last bytes of each one's storage.
  const unsigned char* in[4];
  int64_t row[4];
  uintptr_t lo[4], hi[4];
  // the (N, S) step tables and their storages
  const unsigned char* tab[2];
  uintptr_t tab_lo[2], tab_hi[2];
  int S;
  int* out[5];  // off, widx, c0, c1, c2
  int* chunks;
  int64_t T, nchunk, nwords;
  int per;         // tiles a frame
  unsigned tiles;  // tiles in all
  unsigned* ctr;   // the ticket, the blocks that exited
  unsigned long long* status;
};

struct Shared {
  unsigned long long bar[2];  // a stage's copies have landed
  unsigned tile[2];           // the ticket staged in each stage
  int head[2][4];             // each staged row's head, in bytes
  int tab_head[2];            // the staged step tables' heads
  unsigned wsum[ROUNDS][WARPS];
  unsigned nsum[WARPS];
  unsigned asum[WARPS];       // each warp's part of the next aggregate
  int early[2];               // the staged tile's status is published
  unsigned excl;              // the tile's exclusive prefix
  int last;                   // this block exited last
};

// A bulk copy of a staged row: ``bytes`` (0: none) from ``src`` to ``dst``.
struct Copy {
  unsigned char* dst;
  uintptr_t src;
  unsigned bytes;
};

// Stages bytes [s, s + n) of a row whose storage is [lo, hi) at dst, from
// the row's 16-byte word down: plans the bulk copy of its whole 16-byte
// words inside the storage into ``c`` and loads the bytes outside them
// plainly.  Returns the row's head, s - (s rounded down to 16).
__device__ __forceinline__ int stage_row(unsigned char* dst, uintptr_t s,
                                         uintptr_t n, uintptr_t lo,
                                         uintptr_t hi, Copy& c) {
  const uintptr_t e = s + n, base = s & ~(uintptr_t)15;
  const uintptr_t lo16 = (lo + 15) & ~(uintptr_t)15;
  const uintptr_t hi16 = hi & ~(uintptr_t)15;
  uintptr_t a = base > lo16 ? base : lo16;
  uintptr_t b = (e + 15) & ~(uintptr_t)15;
  if (b > hi16) b = hi16;
  if (b <= a) a = b = s;  // no whole word inside: every byte plain
  c = {dst + (a - base), a, (unsigned)(b - a)};
  for (uintptr_t p = s; p < e && p < a; ++p)
    dst[p - base] = *(const unsigned char*)p;
  for (uintptr_t p = b > s ? b : s; p < e; ++p)
    dst[p - base] = *(const unsigned char*)p;
  return (int)(s - base);
}

// Warp 0: stages tile ``tk``'s rows into stage ``st``, lane r row r:
// one of the two arrivals its barrier takes a use, with the rows' bulk
// bytes.
__device__ __forceinline__ void stage_rows(const Args& A, unsigned char* sm,
                                           Shared& sh, unsigned tk, int st) {
  const int lane = threadIdx.x & 31;
  Copy c = {};
  if (lane < 4) {
    const int64_t f = tk / A.per;
    const int64_t t0 = (int64_t)(tk % A.per) * TILE;
    const int64_t n = A.T - t0 < TILE ? A.T - t0 : TILE;
    const int es = lane < 3 ? 4 : 1;
    sh.head[st][lane] = stage_row(
        sm + st * STAGE + lane * WROW,
        (uintptr_t)(A.in[lane] + (f * A.row[lane] + t0) * es),
        (uintptr_t)(n * es), A.lo[lane], A.hi[lane], c);
  }
  const unsigned tx = warp_sum(c.bytes);
  if (lane == 0) {
    sh.tile[st] = tk;
    bar_expect(&sh.bar[st], tx);
  }
  __syncwarp();
  if (c.bytes) bulk_load(c.dst, c.src, c.bytes, &sh.bar[st]);
}

// Warp 0: the other arrival, with frame ``f``'s step table when ``table``
// (into the one table buffer, so only once the current tile's injections
// are in), lane r table r.
__device__ __forceinline__ void stage_table(const Args& A, unsigned char* sm,
                                            Shared& sh, int64_t f, int st,
                                            bool table) {
  const int lane = threadIdx.x & 31;
  Copy c = {};
  if (table && A.S > 0 && lane < 2)
    sh.tab_head[lane] = stage_row(
        sm + 2 * STAGE + INJ + lane * table_row(A.S),
        (uintptr_t)(A.tab[lane] + f * A.S * 4), (uintptr_t)A.S * 4,
        A.tab_lo[lane], A.tab_hi[lane], c);
  const unsigned tx = warp_sum(c.bytes);
  if (lane == 0) bar_expect(&sh.bar[st], tx);
  __syncwarp();
  if (c.bytes) bulk_load(c.dst, c.src, c.bytes, &sh.bar[st]);
}

// Slots 4g..4g+3 of a staged int32 row whose first slot is at byte head.
__device__ __forceinline__ int4 group4(const unsigned char* row, int head,
                                       int g) {
  const int4* q = (const int4*)row + g;
  const int4 a = q[0];
  if (head == 0) return a;
  const int4 b = q[1];
  if (head == 4) return make_int4(a.y, a.z, a.w, b.x);
  if (head == 8) return make_int4(a.z, a.w, b.x, b.y);
  return make_int4(a.w, b.x, b.y, b.z);
}

// The flag bytes of slots 4g..4g+3 of the staged flag row, slot c in
// byte c.
__device__ __forceinline__ unsigned flags4(const unsigned char* row,
                                           int head, int g) {
  const unsigned* w = (const unsigned*)row + (head >> 2) + g;
  const int sh = head & 3;
  return sh ? __funnelshift_r(w[0], w[1], 8 * sh) : w[0];
}

__device__ __forceinline__ int at(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned at(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// A slot's codeword: its length and (lo, hi) halves.
__device__ __forceinline__ unsigned code(int v, int r, bool isv, int s,
                                         unsigned& lo, unsigned& hi) {
  lo = (unsigned)v;
  hi = 0;
  if (!isv) return (unsigned)r;
  const int u = (int)((unsigned)v + (1u << s));
  const int k = max(31 - __clz(u) - s, 0);
  const unsigned payload = (unsigned)v - ((1u << (s + k)) - (1u << s));
  lo = (1u << k) | (payload << (k + 1));
  hi = payload >> (31 - k);
  return (unsigned)(2 * k + s + 1);
}

// A group's staged inputs; slots at or past n read as 0-bit raw tokens.
struct Group {
  int4 v, r, s;
  unsigned fl;
  __device__ __forceinline__ Group(const unsigned char* stg, const int* hd,
                                   int g, int n) {
    v = group4(stg, hd[0], g);
    r = group4(stg + WROW, hd[1], g);
    s = group4(stg + 2 * WROW, hd[2], g);
    fl = flags4(stg + 3 * WROW, hd[3], g);
    const int x = 4 * g;
    if (x + 3 >= n) {
      const int m = n - x;  // slots of the group in the tile
      v = make_int4(m > 0 ? v.x : 0, m > 1 ? v.y : 0, m > 2 ? v.z : 0, 0);
      r = make_int4(m > 0 ? r.x : 0, m > 1 ? r.y : 0, m > 2 ? r.z : 0, 0);
      s = make_int4(m > 0 ? s.x : 0, m > 1 ? s.y : 0, m > 2 ? s.z : 0, 0);
      fl &= m <= 0 ? 0u : (1u << (8 * m)) - 1u;
    }
  }
  __device__ __forceinline__ unsigned slot(int c, unsigned& lo,
                                           unsigned& hi) const {
    return code(at(v, c), at(r, c), ((fl >> (8 * c)) & 0xffu) != 0,
                at(s, c), lo, hi);
  }
};

// Warps 1 and up: tile ``tk``'s aggregate from its stage ``st`` (waited on
// as iteration ``it``) and the table, published as its status: inclusive
// for a frame's first tile, else an aggregate.
__device__ __forceinline__ void publish_next(const Args& A,
                                             const unsigned char* sm,
                                             Shared& sh, unsigned tk, int st,
                                             int it) {
  const int t = threadIdx.x - 32, lane = t & 31;
  const int64_t j = tk % A.per, t0 = j * TILE;
  const int n = A.T - t0 < TILE ? (int)(A.T - t0) : TILE;
  bar_wait(&sh.bar[st], (it >> 1) & 1);
  const unsigned char* stg = sm + st * STAGE;
  unsigned sum = 0, lo, hi;
  for (int g = t; g < GROUPS; g += THREADS - 32) {
    const Group grp(stg, sh.head[st], g, n);
#pragma unroll
    for (int c = 0; c < 4; ++c) sum += grp.slot(c, lo, hi);
  }
  const unsigned char* tb = sm + 2 * STAGE + INJ;
  const int* ts = (const int*)tb + (sh.tab_head[0] >> 2);
  const int* tn = (const int*)(tb + table_row(A.S)) + (sh.tab_head[1] >> 2);
  for (int q = t; q < A.S; q += THREADS - 32) {
    const int64_t g = ts[q];
    const int64_t p = (g < 0 ? 0 : g > A.T ? A.T : g) - t0;
    if (p >= 0 && p < n) sum += (unsigned)tn[q];
  }
  sum = warp_sum(sum);
  if (lane == 0) sh.asum[(t >> 5) + 1] = sum;
  asm volatile("bar.sync 1, %0;" :: "r"(THREADS - 32) : "memory");
  if (t == 0) {
    unsigned agg = 0;
#pragma unroll
    for (int w = 1; w < WARPS; ++w) agg += sh.asum[w];
    st_release64(A.status + tk, (j == 0 ? INC : AGG) | agg);
    sh.early[st] = 1;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    codeword_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ Shared sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint4* inj = (uint4*)(sm + 2 * STAGE);
  const int* tsite = (const int*)(sm + 2 * STAGE + INJ);
  const int* tnref = (const int*)(sm + 2 * STAGE + INJ + table_row(A.S));

  if (t == 0) {
    bar_init(&sh.bar[0]);
    bar_init(&sh.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int q = t; q < GROUPS; q += THREADS) inj[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // Warp 0: the frame whose table is staged; the ticket to stage next
  // (lane 0's, taken a turn ahead).
  int64_t tab_frame = -1;
  unsigned pending = 0;
  if (warp == 0) {
    unsigned tk = 0;
    if (lane == 0) {
      tk = atomicAdd(&A.ctr[0], 1u);
      sh.tile[0] = tk;
      sh.early[0] = 0;
    }
    tk = __shfl_sync(~0u, tk, 0);
    if (tk < A.tiles) {
      tab_frame = tk / A.per;
      stage_rows(A, sm, sh, tk, 0);
      stage_table(A, sm, sh, tab_frame, 0, true);
    }
    if (lane == 0) pending = atomicAdd(&A.ctr[0], 1u);
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    const int st = it & 1;
    const unsigned tile = sh.tile[st];
    if (tile >= A.tiles) break;
    const int64_t f = tile / A.per;
    const int j = (int)(tile % A.per);
    const int64_t t0 = (int64_t)j * TILE;
    const int n = A.T - t0 < TILE ? (int)(A.T - t0) : TILE;
    // The next tile's rows, in flight from here to its turn (the stage
    // is free: its last tile stored in the last turn).
    if (warp == 0) {
      pending = __shfl_sync(~0u, pending, 0);
      if (lane == 0) sh.tile[st ^ 1] = pending;
      if (pending < A.tiles) stage_rows(A, sm, sh, pending, st ^ 1);
    }
    bar_wait(&sh.bar[st], (it >> 1) & 1);

    // The refinement bits injected at the tile's sites, by warps 1 and up
    // (warp 0 has just staged the next rows).
    if (warp > 0) {
      const int* ts = tsite + (sh.tab_head[0] >> 2);
      const int* tn = tnref + (sh.tab_head[1] >> 2);
      unsigned* in1 = (unsigned*)inj;
      for (int q = t - 32; q < A.S; q += THREADS - 32) {
        const int64_t g = ts[q];
        const int64_t p = (g < 0 ? 0 : g > A.T ? A.T : g) - t0;
        if (p >= 0 && p < n) atomicAdd(&in1[p], (unsigned)tn[q]);
      }
    }
    __syncthreads();
    // Its frame's step table, if another, now that this tile's injections
    // are in.
    if (warp == 0 && pending < A.tiles) {
      const int64_t nf = pending / A.per;
      stage_table(A, sm, sh, nf, st ^ 1, nf != tab_frame);
      tab_frame = nf;
    }

    // Pass 1: each group's lengths and injections, and the chunk's
    // lengths.
    const unsigned char* stg = sm + st * STAGE;
    const int* hd = sh.head[st];
    unsigned part[ROUNDS], inc[ROUNDS], nsum = 0;
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      const int g = i * THREADS + t;
      const Group grp(stg, hd, g, n);
      const uint4 in4 = inj[g];
      unsigned sum = 0, lo, hi;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned nb = grp.slot(c, lo, hi);
        nsum += nb;
        sum += nb + at(in4, c);
      }
      part[i] = inc[i] = sum;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int i = 0; i < ROUNDS; ++i) {
        const unsigned y = __shfl_up_sync(~0u, inc[i], d);
        if (lane >= d) inc[i] += y;
      }
    }
    nsum = warp_sum(nsum);
    if (lane == 31) {
#pragma unroll
      for (int i = 0; i < ROUNDS; ++i) sh.wsum[i][warp] = inc[i];
    }
    if (lane == 0) sh.nsum[warp] = nsum;
    __syncthreads();
    unsigned pre[ROUNDS], agg = 0;  // each group's prefix in the tile
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      unsigned below = 0, all = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned ws = sh.wsum[i][w];
        below += w < warp ? ws : 0u;
        all += ws;
      }
      pre[i] = agg + below + inc[i] - part[i];
      agg += all;
    }
    if (t == 32) {
      unsigned c = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) c += sh.nsum[w];
      A.chunks[f * A.nchunk + j] = (int)c;
    }

    // Warp 0: the tile's status (unless published while the block's last
    // tile looked back) and the look-back.
    if (warp == 0) {
      unsigned long long* mine = A.status + tile;
      unsigned excl = 0;
      const bool early = sh.early[st];
      if (j == 0) {
        if (lane == 0 && !early) st_release64(mine, INC | agg);
      } else {
        if (lane == 0 && !early) st_release64(mine, AGG | agg);
        const int64_t first = (int64_t)tile - j;  // the frame's first tile
        for (int64_t q0 = (int64_t)tile - 1;; q0 -= 32) {
          const int64_t q = q0 - lane;
          unsigned long long s = INC;  // before the frame: an inclusive 0
          if (q >= first) s = ld_acquire64(A.status + q);
          int stop;  // the nearest inclusive status (32: none)
          for (;;) {  // until every status nearer than it is published
            const unsigned incm = __ballot_sync(~0u, (s >> 32) == 2);
            const unsigned none = __ballot_sync(~0u, (s >> 32) == 0);
            stop = incm ? __ffs(incm) - 1 : 32;
            if ((none ? __ffs(none) - 1 : 32) >= stop) break;
            __nanosleep(32);
            if ((s >> 32) == 0 && lane < stop) s = ld_acquire64(A.status + q);
          }
          excl += warp_sum(lane <= stop ? (unsigned)s : 0u);
          if (stop < 32) break;
        }
        if (lane == 0) st_release64(mine, INC | (excl + agg));
      }
      if (lane == 0) sh.excl = excl;
    } else {
      // The other warps: the next tile's aggregate (its lengths and the
      // refinement bits of its sites), published as soon as its rows land,
      // so that no tile's status waits on a look-back of the block that
      // holds it.
      const unsigned nt = sh.tile[st ^ 1];
      if (nt < A.tiles) publish_next(A, sm, sh, nt, st ^ 1, it + 1);
      else if (t == 32) sh.early[st ^ 1] = 0;
    }
    __syncthreads();
    const unsigned excl = sh.excl;
    // The ticket of the tile after the next, taken once this tile's
    // look-back is done: a tile whose ticket is held waits on no
    // look-back of its block (its aggregate is published in the next
    // turn, during this block's next look-back).
    if (t == 0) pending = atomicAdd(&A.ctr[0], 1u);  // used next turn
    // Warp 1: this tile's inclusive sum carried forward to the run of
    // following tiles of the frame whose aggregates are published (any
    // block may: a tile's inclusive sum is one value), so that a later
    // look-back finds an inclusive sum close by and waits on fewer tiles.
    if (warp == 1) {
      unsigned long long s = 0;
      if (j + 1 + lane < A.per) s = ld_acquire64(A.status + tile + 1 + lane);
      const unsigned other = __ballot_sync(~0u, (s >> 32) != 1);
      const int run = other ? __ffs(other) - 1 : 32;
      unsigned v = lane < run ? (unsigned)s : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(~0u, v, d);
        if (lane >= d) v += y;
      }
      if (lane < run)
        st_release64(A.status + tile + 1 + lane, INC | (excl + agg + v));
    }

    // Pass 2: the lengths and halves again from the stage, each slot's
    // words out; the injections cleared for the next tile.
    const unsigned fw = (unsigned)(f * A.nwords);
    const int64_t ob = f * A.T + t0;
    const bool vec = ((f * A.T) & 3) == 0;  // 16-byte output rows
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      const int g = i * THREADS + t, x = 4 * g;
      const uint4 in4 = inj[g];
      inj[g] = make_uint4(0, 0, 0, 0);
      if (x >= n) continue;
      const Group grp(stg, hd, g, n);
      unsigned run = excl + pre[i];
      int w[5][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unsigned lo, hi;
        const unsigned nb = grp.slot(c, lo, hi);
        const unsigned o = run + at(in4, c);
        run = o + nb;
        const unsigned s = o & 31u, sc = 31u - s;
        w[0][c] = (int)o;
        w[1][c] = (int)((unsigned)((int)o >> 5) + fw);
        w[2][c] = (int)(lo << s);
        w[3][c] = (int)(((lo >> 1) >> sc) | (hi << s));
        w[4][c] = (int)((hi >> 1) >> sc);
      }
      if (vec && x + 3 < n) {
#pragma unroll
        for (int k = 0; k < 5; ++k)
          *(int4*)(A.out[k] + ob + x) =
              make_int4(w[k][0], w[k][1], w[k][2], w[k][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (x + c < n) {
#pragma unroll
            for (int k = 0; k < 5; ++k) A.out[k][ob + x + c] = w[k][c];
          }
      }
    }
    __syncthreads();  // the stage and the injections free again
  }

  // The last block to exit clears the statuses and counters.
  if (t == 0) {
    __threadfence();
    sh.last = atomicAdd(&A.ctr[1], 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (sh.last) {
    for (unsigned i = t; i < A.tiles; i += THREADS) A.status[i] = 0;
    if (t == 0) {
      A.ctr[0] = 0;
      A.ctr[1] = 0;
    }
  }
}

// The launch plan on the current device for S steps a frame: its SMs, the
// blocks of codeword_kernel an SM holds at once, and a block's dynamic
// shared memory in bytes.
extern "C" int dwt_codeword_plan(int64_t S, int* sms, int* per_sm,
                                 int* smem) {
  if (S < 0 || S > 0x7fffffff / 8) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  *smem = smem_bytes((int)S);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(codeword_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, codeword_kernel,
                                                      THREADS, *smem);
  return (int)e;
}

// val, raw, ord (N, T) int32 and vli (N, T) bool, each at its row stride;
// site, nref (N, S) int32 -> off, widx, c0, c1, c2 (N, T) int32 and
// chunks (N, ceil(T / 2048)) int32.  bounds: 12 int64 on the host, the
// first and past-the-last byte of the storages of val, raw, ord, vli,
// site and nref.  grid: the persistent blocks, at most the tiles; scratch:
// 16 + 8 * cap zeroed bytes (two counters and an 8-byte status a tile),
// cap >= the tiles.
extern "C" int dwt_codeword_pieces(
    const void* val, int64_t val_row, const void* raw, int64_t raw_row,
    const void* vli, int64_t vli_row, const void* ord, int64_t ord_row,
    const void* site, const void* nref, int64_t S, void* off, void* widx,
    void* c0, void* c1, void* c2, void* chunks, int64_t nframes, int64_t T,
    int64_t nwords, const int64_t* bounds, int64_t grid, void* scratch,
    int64_t cap, void* stream) {
  if (nframes < 0 || T < 0 || S < 0 || cap < 0 || nwords < 0)
    return (int)cudaErrorInvalidValue;
  if (nframes == 0 || T == 0) return 0;
  const int64_t per = (T + TILE - 1) / TILE;
  const int64_t tiles = nframes * per;
  if (tiles > cap || per > 0x7fffffff || S > 0x7fffffff / 8 || grid < 1 ||
      grid > tiles)
    return (int)cudaErrorInvalidValue;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  Args A;
  const void* in[4] = {val, raw, ord, vli};
  const int64_t row[4] = {val_row, raw_row, ord_row, vli_row};
  for (int r = 0; r < 4; ++r) {
    A.in[r] = (const unsigned char*)in[r];
    A.row[r] = row[r];
    A.lo[r] = (uintptr_t)bounds[2 * r];
    A.hi[r] = (uintptr_t)bounds[2 * r + 1];
  }
  A.tab[0] = (const unsigned char*)site;
  A.tab[1] = (const unsigned char*)nref;
  for (int r = 0; r < 2; ++r) {
    A.tab_lo[r] = (uintptr_t)bounds[8 + 2 * r];
    A.tab_hi[r] = (uintptr_t)bounds[9 + 2 * r];
  }
  A.S = (int)S;
  void* out[5] = {off, widx, c0, c1, c2};
  for (int k = 0; k < 5; ++k) A.out[k] = (int*)out[k];
  A.chunks = (int*)chunks;
  A.T = T;
  A.nchunk = (T + CHUNK - 1) / CHUNK;
  A.nwords = nwords;
  A.per = (int)per;
  A.tiles = (unsigned)tiles;
  A.ctr = (unsigned*)scratch;
  A.status = (unsigned long long*)((unsigned char*)scratch + 16);
  const int smem = smem_bytes((int)S);
  cudaError_t e = cudaFuncSetAttribute(
      codeword_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  codeword_kernel<<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
