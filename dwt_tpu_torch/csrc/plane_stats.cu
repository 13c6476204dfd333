// The encoder's plane statistics: per-chunk plane histograms,
// last-significant positions, zero counts and boundary-prefix zero counts
// of the linearized detail coefficients, and each row's top plane, in two
// launches.
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
// chunk of each UNIT-element unit of the detail axis (chunks are whole
// units: segments and chunks are multiples of 8192 elements); chunk_base,
// the detail-axis start of each chunk's level segment.  An element's
// level-local index is its position less its chunk's base.  Its plane q is
// the top set bit of |x| (31 - clz), -1 for a valid zero.
//
// Output, into tables the wrapper zeroes: nS (R, nchunk, 29) the count of
// valid elements at plane p; last1 (R, nchunk, 29) one more than the
// largest level-local index at plane p (0: none); z0 (R, nchunk) the valid
// zeros; zup (R, nchunk, 29) the valid elements with q < p at a level-local
// index <= last1 - 1 of the same chunk and plane; planes (R,) one more
// than the row's largest q (0 for a row of zeros).  Every sum and maximum
// is an integer atomic: the result does not depend on the order of the
// blocks.
//
// Bound: the coefficients read once (4 bytes an element) and the mask
// (1 byte an element), or the compares of the boundary-prefix count (an
// element and plane for each element of a chunk up to the chunk's last
// index at that plane) at the card's INT32 rate, whichever is larger for
// the data (chip_smoke.py reports both).
//
// 1. plane_hist_kernel: one CUDA block a unit of one row (32 elements a
//    thread, 16-byte loads).  A warp finds the lanes that share a plane
//    with __match_any_sync: the lowest adds their count to the block's
//    histogram in shared memory, the highest (the largest index: positions
//    rise with the lane) its index to the block's maximum.  It writes each
//    element's q as int8 (127 for a pad, which no plane counts) for pass 2,
//    and adds the block's tables into the chunk's.
// 2. plane_zup_kernel: the same blocks, after pass 1 has set every chunk's
//    last1.  Each thread keeps 29 counters and, for each of its elements,
//    adds 1 to plane p when q < p and the index is at most the chunk's
//    last index at p; a warp reduction and one atomic a plane follow.  A
//    unit that lies wholly past every plane's last index is skipped.
#include "common.cuh"

constexpr int PMAX = 29;     // bitplanes of the format (ops/plane_stats.py)
constexpr int UNIT = 8192;   // elements a block (codec/stage1.py: ALIGN)
constexpr int THREADS = 256;
constexpr int PAD_Q = 127;   // q of a pad element: no plane counts it
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int plane_of(int x, bool valid) {
  const int mag = x < 0 ? -x : x;  // INT_MIN stays negative: a "zero"
  return !valid ? PAD_Q : (mag > 0 ? 31 - __clz(mag) : -1);
}

// Row and unit of this CUDA block, the unit's chunk and its level base.
struct Unit {
  int64_t row;
  int64_t pos0;  // first detail-axis position
  int chunk, base;
  __device__ Unit(const int* unit_chunk, const int* chunk_base,
                  int64_t nunits) {
    row = blockIdx.x / nunits;
    const int64_t u = blockIdx.x % nunits;
    pos0 = u * UNIT;
    chunk = unit_chunk[u];
    base = chunk_base[chunk];
  }
};

__global__ void __launch_bounds__(THREADS) plane_hist_kernel(
    const int* __restrict__ lin, const unsigned char* __restrict__ valid,
    const int* __restrict__ unit_chunk, const int* __restrict__ chunk_base,
    signed char* __restrict__ q8, int* __restrict__ nS,
    int* __restrict__ last1, int* __restrict__ z0, int* __restrict__ planes,
    int64_t nlin, int64_t n, int nchunk) {
  __shared__ int hist[PMAX], last[PMAX], zeros, top;
  const Unit un(unit_chunk, chunk_base, n / UNIT);
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < PMAX) {
    hist[tid] = 0;
    last[tid] = -1;
  }
  if (tid == 0) {
    zeros = 0;
    top = -1;
  }
  __syncthreads();
  const int* x = lin + un.row * nlin + (nlin - n) + un.pos0;
  const unsigned char* v = valid + un.pos0;
  signed char* qo = q8 + un.row * n + un.pos0;
  int nz = 0, qmax = -1;
#pragma unroll 2
  for (int j = 0; j < UNIT / (4 * THREADS); ++j) {
    const int off = 4 * (j * THREADS + tid);
    const int4 xv = *(const int4*)(x + off);
    const uchar4 vv = *(const uchar4*)(v + off);
    const int q[4] = {plane_of(xv.x, vv.x), plane_of(xv.y, vv.y),
                      plane_of(xv.z, vv.z), plane_of(xv.w, vv.w)};
    *(char4*)(qo + off) = make_char4(q[0], q[1], q[2], q[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      nz += __popc(__ballot_sync(FULL, q[e] == -1));
      if (q[e] != PAD_Q) qmax = max(qmax, q[e]);
      const unsigned m = __match_any_sync(FULL, q[e]);
      if (q[e] >= 0 && q[e] < PMAX) {
        if (lane == __ffs(m) - 1) atomicAdd(&hist[q[e]], __popc(m));
        if (lane == 31 - __clz(m))
          atomicMax(&last[q[e]], (int)(un.pos0 + off + e - un.base));
      }
    }
  }
  qmax = __reduce_max_sync(FULL, qmax);
  if (lane == 0) {
    atomicAdd(&zeros, nz);  // every lane counted the warp's zeros
    atomicMax(&top, qmax);
  }
  __syncthreads();
  const int64_t cp = (un.row * nchunk + un.chunk) * PMAX;
  if (tid < PMAX) {
    if (hist[tid]) atomicAdd(&nS[cp + tid], hist[tid]);
    if (last[tid] >= 0) atomicMax(&last1[cp + tid], last[tid] + 1);
  } else if (tid == PMAX) {
    if (zeros) atomicAdd(&z0[un.row * nchunk + un.chunk], zeros);
  } else if (tid == PMAX + 1) {
    if (top >= 0) atomicMax(&planes[un.row], top + 1);
  }
}

__global__ void __launch_bounds__(THREADS) plane_zup_kernel(
    const signed char* __restrict__ q8, const int* __restrict__ unit_chunk,
    const int* __restrict__ chunk_base, const int* __restrict__ last1,
    int* __restrict__ zup, int64_t n, int nchunk) {
  __shared__ int acc[PMAX];
  const Unit un(unit_chunk, chunk_base, n / UNIT);
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t cp = (un.row * nchunk + un.chunk) * PMAX;
  const int first = (int)(un.pos0 - un.base);  // the unit's first index
  int lastp[PMAX], cnt[PMAX], lmax = -1;
#pragma unroll
  for (int p = 0; p < PMAX; ++p) {
    lastp[p] = __ldg(&last1[cp + p]) - 1;
    lmax = max(lmax, lastp[p]);
    cnt[p] = 0;
  }
  if (lmax < first) return;  // uniform: no element of the unit counts
  if (tid < PMAX) acc[tid] = 0;
  __syncthreads();
  const signed char* qi = q8 + un.row * n + un.pos0;
  for (int j = 0; j < UNIT / (16 * THREADS); ++j) {
    const int off = 16 * (j * THREADS + tid);
    const int4 raw = *(const int4*)(qi + off);
    const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int q = (signed char)(w[e >> 2] >> (8 * (e & 3)));
      const int idx = first + off + e;
#pragma unroll
      for (int p = 0; p < PMAX; ++p) cnt[p] += (q < p) & (idx <= lastp[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < PMAX; ++p) {
    const int s = __reduce_add_sync(FULL, cnt[p]);
    if (lane == 0 && s) atomicAdd(&acc[p], s);
  }
  __syncthreads();
  if (tid < PMAX && acc[tid]) atomicAdd(&zup[cp + tid], acc[tid]);
}

static int blocks(int64_t rows, int64_t n, unsigned* g) {
  if (rows < 0 || n < 0 || n % UNIT) return (int)cudaErrorInvalidValue;
  const int64_t b = rows * (n / UNIT);
  if (b > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  *g = (unsigned)b;
  return 0;
}

// lin (rows, nlin) int32, valid (n,) -> q8 (rows, n) int8 and the tables
// nS, last1 (rows, nchunk, 29), z0 (rows, nchunk), planes (rows,), which
// the caller has zeroed.
extern "C" int dwt_plane_hist(const void* lin, const void* valid,
                              const void* unit_chunk, const void* chunk_base,
                              void* q8, void* nS, void* last1, void* z0,
                              void* planes, int64_t rows, int64_t nlin,
                              int64_t n, int nchunk, void* stream) {
  unsigned g;
  if (const int rc = blocks(rows, n, &g)) return rc;
  if (nlin < n) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  plane_hist_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)lin, (const unsigned char*)valid, (const int*)unit_chunk,
      (const int*)chunk_base, (signed char*)q8, (int*)nS, (int*)last1,
      (int*)z0, (int*)planes, nlin, n, nchunk);
  return (int)cudaGetLastError();
}

// q8 (rows, n) and last1 -> zup (rows, nchunk, 29), zeroed by the caller.
extern "C" int dwt_plane_zup(const void* q8, const void* unit_chunk,
                             const void* chunk_base, const void* last1,
                             void* zup, int64_t rows, int64_t n, int nchunk,
                             void* stream) {
  unsigned g;
  if (const int rc = blocks(rows, n, &g)) return rc;
  if (g == 0) return 0;
  plane_zup_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
      (const signed char*)q8, (const int*)unit_chunk,
      (const int*)chunk_base, (const int*)last1, (int*)zup, n, nchunk);
  return (int)cudaGetLastError();
}
