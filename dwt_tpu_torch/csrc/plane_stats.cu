// The encoder's plane statistics: per-chunk plane histograms,
// last-significant positions, zero counts and boundary-prefix zero counts
// of the linearized detail coefficients, and each row's top plane, in one
// launch.
//
// No TPU kernel to replace: the JAX package computes them as XLA
// (dwt_tpu/codec/encoder.py:_plane_stats, one-hot passes over the planes,
// fused into one program on the TPU).  The plain PyTorch version
// (ops/plane_stats.py:plane_stats_plain) makes the same one-hot passes
// eagerly: about 70 launches and some 13 GB of temporaries at 4K, where the
// statistics need to read the 102 MB of coefficients once.
//
// Input: lin, R rows of nlin int32 (a frame's channel a row), whose last n
// elements are the detail axis; valid, the (n,) pad mask; unit_chunk, the
// chunk of each UNIT-element unit of the detail axis (chunks are 1 to
// CHUNK_UNITS whole units, in order); chunk_base, the detail-axis start of
// each chunk's level segment.  An element's level-local index is its
// position less its chunk's base.  Its plane q is the top set bit of |x|
// (31 - clz), -1 for a valid zero.
//
// Output: nS (R, nchunk, 29) the count of valid elements at plane p;
// lastS (R, nchunk, 29) the largest level-local index at plane p (-1:
// none); z0 (R, nchunk) the valid zeros; zup (R, nchunk, 29) the valid
// elements with q < p at a level-local index <= lastS of the same chunk
// and plane; planes (R,) one more than the row's largest q (0 for a row of
// zeros), an integer atomic maximum into a table the wrapper zeroes.  A
// chunk's tables are written by the one block that owns it: the result
// does not depend on the order of the blocks.
//
// Bound: bytes, the coefficients read once (4 bytes an element) and the
// mask once (1 byte an element).  The first version (two launches) spent
// two thirds of its time in the boundary-prefix count, 29 compare-and-adds
// for each element (about 2 G integer operations at 4K), and wrote and
// read back an int8 copy of every element's plane (25 MB at 4K).  This
// design removes both:
//
// plane_stats_kernel: one CUDA block a chunk and row; a chunk's blocks
// are adjacent, so the rows after the first find its mask in L2.  The
// block stages the chunk's mask as bits in shared memory.  A warp takes a
// 512-element block (32 lanes x 16
// elements, 16-byte loads), computes q + 1 of each element as a byte (127
// for a pad) into the chunk's byte array in shared memory, and keeps the
// block's cumulative counts #{q < p} for p = 0..29: with the bytes packed
// four to a word, one subtract and mask (SWAR) compares four elements
// with p at once, and only the planes up to the block's largest q are
// counted (above it the count is the block's valid count).  Then a warp a
// plane finishes the chunk: nS from the counts' differences, the last
// block that holds plane p from them, lastS from that block's bytes, and
// zup as the counts of the blocks before it plus a recount of that one
// block's bytes up to lastS.  No element is compared with every plane,
// and nothing but the tables leaves the block.
#include "common.cuh"

constexpr int PMAX = 29;         // bitplanes of the format (ops/plane_stats.py)
constexpr int UNIT = 8192;       // elements a unit (codec/stage1.py: ALIGN)
constexpr int CHUNK_UNITS = 8;   // units a chunk at most (plane_stats.py)
constexpr int CHUNK_MAX = CHUNK_UNITS * UNIT;
constexpr int BLK = 512;         // elements a warp's block
constexpr int NB_MAX = CHUNK_MAX / BLK;
constexpr int NT = PMAX + 1;     // cumulative counts a block: #{q < p}, p <= 29
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned HI = 0x80808080u, ONES = 0x01010101u;
constexpr unsigned PAD_U = 127;  // q + 1 of a pad: no plane counts it
constexpr size_t SMEM = CHUNK_MAX + CHUNK_MAX / 8
                        + NB_MAX * NT * sizeof(unsigned short);

// Bytes of w with value < p + 1, as bit 7 of each byte (every byte < 128).
__device__ __forceinline__ unsigned below(unsigned w, int p) {
  return ~((w | HI) - (unsigned)(p + 1) * ONES) & HI;
}

// Bytes of w equal to v, as bit 7 of each byte (exact for every byte).
__device__ __forceinline__ unsigned equal(unsigned w, int v) {
  const unsigned x = w ^ ((unsigned)v * ONES);
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & HI;
}

// Bit 7 of the bytes of a lane's word k (elements 128k + 4 lane + 0..3)
// at positions up to `last` in the block.
__device__ __forceinline__ unsigned upto(int last, int k, int lane) {
  const int m = last - (128 * k + 4 * lane) + 1;  // bytes that count
  return m >= 4 ? HI : (m <= 0 ? 0u : HI & ((1u << (8 * m)) - 1));
}

__global__ void __launch_bounds__(THREADS) plane_stats_kernel(
    const int* __restrict__ lin, const unsigned char* __restrict__ valid,
    const int* __restrict__ unit_chunk, const int* __restrict__ chunk_base,
    int* __restrict__ nS, int* __restrict__ lastS, int* __restrict__ z0,
    int* __restrict__ zup, int* __restrict__ planes, unsigned rows,
    int64_t nlin, int64_t n, int nchunk, int nunits) {
  extern __shared__ __align__(16) unsigned char sm[];
  unsigned char* q1 = sm;                                 // q + 1, a byte each
  unsigned* vbits = (unsigned*)(sm + CHUNK_MAX);          // the mask, a bit each
  unsigned short* cnt = (unsigned short*)(vbits + CHUNK_MAX / 32);
  __shared__ int wmax[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (int)(blockIdx.x / rows);  // 32-bit: no 64-bit divide
  const int64_t row = blockIdx.x % rows;

  // The chunk's units: unit u's chunk is at most u and at least u / 8, so
  // they lie in [chunk, 8 chunk + 8); count those before it and up to it.
  int before = 0, upto_c = 0;
  const int wend = min(nunits, CHUNK_UNITS * chunk + CHUNK_UNITS);
  for (int u0 = chunk; u0 < wend; u0 += THREADS) {
    const int u = u0 + tid;
    const int c = u < wend ? __ldg(&unit_chunk[u]) : 0x7fffffff;
    before += __syncthreads_count(c < chunk);
    upto_c += __syncthreads_count(c <= chunk);
  }
  const int units = upto_c - before;
  // Not the tables' layout: the wrapper and dwt_plane_stats refuse the
  // layouts they can see (chunks of more than CHUNK_UNITS units).
  if (units < 1 || units > CHUNK_UNITS) __trap();
  const int64_t pos0 = (int64_t)(chunk + before) * UNIT;
  const int len = units * UNIT, nblk = len / BLK;
  const int first = (int)(pos0 - __ldg(&chunk_base[chunk]));  // its index

  // The mask, a bit an element.
  for (int k = tid; k < len / 32; k += THREADS) {
    const uint4* v = (const uint4*)(valid + pos0 + 32 * k);
    const uint4 a = __ldg(v), b = __ldg(v + 1);
    const unsigned wv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bits |= ((wv[i] >> (8 * j)) & 1u) << (4 * i + j);
    vbits[k] = bits;
  }
  __syncthreads();

  const int* x = lin + row * nlin + (nlin - n) + pos0;
  int qtop = -1;
  for (int b = warp; b < nblk; b += WARPS) {
    unsigned wq[4];
    int qmax = -1, nv = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = b * BLK + 128 * k + 4 * lane;
      const int4 xv = __ldg((const int4*)(x + e));
      const unsigned vb = (vbits[e >> 5] >> (e & 31)) & 0xfu;
      const int xs[4] = {xv.x, xv.y, xv.z, xv.w};
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // q + 1 (|INT_MIN| is no magnitude: a "zero", as in the plain
        // version, whose int32 abs leaves it negative).
        const unsigned mag = xs[j] < 0 ? 0u - (unsigned)xs[j]
                                       : (unsigned)xs[j];
        const int u = mag - 1u < 0x7fffffffu ? 32 - __clz(mag) : 0;
        const bool ok = (vb >> j) & 1u;
        word |= (ok ? (unsigned)u : PAD_U) << (8 * j);
        if (ok) qmax = max(qmax, u - 1);
      }
      nv += __popc(vb);
      wq[k] = word;
      ((unsigned*)q1)[e >> 2] = word;
    }
    const int m = __reduce_max_sync(FULL, qmax);  // the block's top plane
    const int valid_n = __reduce_add_sync(FULL, nv);
    unsigned short* cb = cnt + b * NT;
    const int top = min(m, PMAX);  // planes counted one by one
    for (int p = 0; p <= top; ++p) {
      int c = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) c += __popc(below(wq[k], p));
      c = __reduce_add_sync(FULL, c);
      if (lane == 0) cb[p] = (unsigned short)c;
    }
    if (lane > top && lane < NT) cb[lane] = (unsigned short)valid_n;
    qtop = max(qtop, m);
  }
  if (lane == 0) wmax[warp] = qtop;
  __syncthreads();

  int cm = -1;  // the chunk's top plane
#pragma unroll
  for (int w = 0; w < WARPS; ++w) cm = max(cm, wmax[w]);
  const int64_t ck = row * nchunk + chunk;
  if (tid == 0 && cm >= 0) atomicMax(&planes[row], cm + 1);
  // Task PMAX: the zeros; task p < PMAX: plane p.
  for (int p = warp; p <= PMAX; p += WARPS) {
    if (p == PMAX) {
      int z = 0;
      for (int b = lane; b < nblk; b += 32) z += cnt[b * NT];
      z = __reduce_add_sync(FULL, z);
      if (lane == 0) z0[ck] = z;
      continue;
    }
    int ns = 0, blast = -1;
    if (p <= cm)
      for (int b = lane; b < nblk; b += 32) {
        const int at = cnt[b * NT + p + 1] - cnt[b * NT + p];
        ns += at;
        if (at) blast = b;
      }
    ns = __reduce_add_sync(FULL, ns);
    blast = __reduce_max_sync(FULL, blast);
    int last = -1, zu = 0;
    if (blast >= 0) {  // the last block that holds plane p
      unsigned wq[4];
      int pos = -1;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wq[k] = ((const unsigned*)q1)[(blast * BLK + 128 * k) / 4 + lane];
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const unsigned eq = equal(wq[k], p + 1);
        if (pos < 0 && eq) pos = 128 * k + 4 * lane + (31 - __clz(eq)) / 8;
      }
      pos = __reduce_max_sync(FULL, pos);
      for (int b = lane; b < blast; b += 32) zu += cnt[b * NT + p];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        zu += __popc(below(wq[k], p) & upto(pos, k, lane));
      zu = __reduce_add_sync(FULL, zu);
      last = first + blast * BLK + pos;
    }
    if (lane == 0) {
      nS[ck * PMAX + p] = ns;
      lastS[ck * PMAX + p] = last;
      zup[ck * PMAX + p] = zu;
    }
  }
}

// lin (rows, nlin) int32, valid (n,) -> nS, lastS, zup (rows, nchunk, 29),
// z0 (rows, nchunk) and planes (rows,), which the caller has zeroed; a
// block a chunk and row.
extern "C" int dwt_plane_stats(const void* lin, const void* valid,
                               const void* unit_chunk, const void* chunk_base,
                               void* nS, void* lastS, void* z0, void* zup,
                               void* planes, int64_t rows, int64_t nlin,
                               int64_t n, int nchunk, void* stream) {
  if (rows < 0 || n < 0 || n % UNIT || nlin < n || nchunk < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nunits = n / UNIT;
  // Chunks of 1 to CHUNK_UNITS whole units: no more chunks than units and
  // no more units than CHUNK_UNITS a chunk.
  if (nchunk > nunits || nunits > (int64_t)CHUNK_UNITS * nchunk
      || nunits > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = nchunk * rows;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      plane_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  plane_stats_kernel<<<(unsigned)blocks, THREADS, SMEM,
                       (cudaStream_t)stream>>>(
      (const int*)lin, (const unsigned char*)valid, (const int*)unit_chunk,
      (const int*)chunk_base, (int*)nS, (int*)lastS, (int*)z0, (int*)zup,
      (int*)planes, (unsigned)rows, nlin, n, nchunk, (int)nunits);
  return (int)cudaGetLastError();
}
