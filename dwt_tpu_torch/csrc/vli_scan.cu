// The encoder's adaptive-VLI order scan (vli.h:67-84): the order state
// entering every token of N frames' token arrays, as three launches.
//
// No TPU kernel to replace: the JAX package runs the scan as XLA, a
// lax.scan over each block's tokens and an associative_scan over the
// blocks' transition maps (dwt_tpu/codec/encoder.py:745, _vli_orders),
// one compiled program on the TPU.  The plain PyTorch version
// (ops/vli_scan.py:vli_orders_plain) does the same passes eagerly: two
// loops of TB steps and a Hillis-Steele composition, about 2,000 launches
// a call.
//
// Input: x, the (TB, R) int32 transition parameters, R = N * nblk block
// columns (frame f's blocks are columns f*nblk .. f*nblk + nblk - 1), a
// token's +1-biased (a | b << 5), 0 for a token that is no VLI value.  An
// active token takes state s to clamp(max(s, a + (s >= b)) - 2, 0, 30).
// Output: the (TB, R) int8 orders, each token's state before its own
// transition; a frame's first block enters in state 0.
//
// Bound: bytes or operations, whichever is larger for the data (x read
// once, the orders written once, 5 bytes a token; and the maps' updates,
// 31 states for each active token).  The design reads x twice (126 MB at
// 4K each time, more than the 50 MB L2) and keeps the rest small: 32
// bytes a block column of maps, 32 a segment of aggregates.
//
// 1. vli_maps_kernel: one thread a block column, one CUDA block a segment
//    of SEG columns of one frame.  A thread walks its TB tokens (a warp
//    reads 32 consecutive words of a row: coalesced) with the column's
//    map of the 31 entry states in registers, two states a 32-bit word,
//    and writes it as 32 bytes.  The map's update is integer work, which
//    bounds this kernel: Hopper's DPX max of three 16-bit pairs
//    (__vimax3_u16x2) does max(s, a + (s >= b), 2) in one instruction,
//    where four states a word by the byte SIMD intrinsics (__vcmpgeu4,
//    __vmaxu4, __vsubus4) cost several instructions each on this card.
//    The segment's maps also go to shared memory, where one warp
//    composes them, lane e walking entry state e through the SEG maps:
//    the segment's aggregate map.
// 2. vli_entry_kernel: one CUDA block a frame walks the frame's segment
//    aggregates in order from state 0 (a chain of dependent shared-memory
//    reads, about 960 at 4K), staged through shared memory in chunks:
//    each segment's entry state.
// 3. vli_replay_kernel: one CUDA block a segment walks the segment's maps
//    from its entry state (one thread, shared memory), giving each block
//    column's entry state; then one thread a column replays its TB tokens
//    and writes each token's order (a warp writes 32 consecutive bytes).
//
// The work is O(R * 31) where a composition scan over the blocks is
// O(R * 31 * log R), and the launches are 3 whatever N and nblk are.
#include "common.cuh"

constexpr int SEG = 256;       // block columns a segment (threads a block)
constexpr int MAP = 32;        // bytes a map: 31 states and a spare lane
constexpr int ROWW = 9;        // words a shared map row (36 bytes: 9 is
                               // odd, so a warp's row writes miss no bank)
constexpr int CHUNK = 512;     // aggregates a frame walk stages at once
constexpr int ENTRY_THREADS = 256;
constexpr int UNROLL = 8;      // tokens whose loads are issued together

// One active token on two states a word (16-bit halves):
// max(s, a + (s >= b), 2) - 2.  States stay below 32, so a + (s >= b) <=
// 32 and the result <= 30: the clamp at 30 never binds.  s >= b is the
// top bit of (s | 0x8000) - b in each half (no borrow crosses halves).
__device__ __forceinline__ void step_map(unsigned (&m)[MAP / 2], int v) {
  if (v <= 0) return;
  const unsigned p = (unsigned)(v - 1);
  const unsigned aa = (p & 31u) * 0x00010001u;
  const unsigned bb = ((p >> 5) & 31u) * 0x00010001u;
#pragma unroll
  for (int k = 0; k < MAP / 2; ++k) {
    const unsigned ge = (((m[k] | 0x80008000u) - bb) >> 15) & 0x00010001u;
    m[k] = __vimax3_u16x2(m[k], aa + ge, 0x00020002u) - 0x00020002u;
  }
}

__device__ __forceinline__ int step_state(int s, int v) {
  if (v <= 0) return s;
  const unsigned p = (unsigned)(v - 1);
  const int a = (int)(p & 31u), b = (int)((p >> 5) & 31u);
  return min(max(max(s, a + (s >= b)) - 2, 0), 30);
}

// Frame f, segment j of CUDA block g; the segment's column count.
struct Seg {
  int64_t r0;  // first block column
  int cnt;
  __device__ Seg(int g, int nblk, int nseg) {
    const int f = g / nseg, j = g % nseg;
    r0 = (int64_t)f * nblk + (int64_t)j * SEG;
    cnt = min(SEG, nblk - j * SEG);
  }
};

__global__ void __launch_bounds__(SEG) vli_maps_kernel(
    const int* __restrict__ x, unsigned char* __restrict__ maps,
    unsigned char* __restrict__ agg, int tb, int64_t R, int nblk,
    int nseg) {
  __shared__ unsigned smap[SEG * ROWW];
  const Seg seg(blockIdx.x, nblk, nseg);
  const int i = threadIdx.x;
  if (i < seg.cnt) {
    const int64_t r = seg.r0 + i;
    unsigned m[MAP / 2];  // word k: states 2k (low half) and 2k + 1
#pragma unroll
    for (int k = 0; k < MAP / 2; ++k) m[k] = 0x00010000u + 0x00020002u * k;
    const int* col = x + r;
    int t = 0;
    for (; t + UNROLL <= tb; t += UNROLL) {
      int v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(col + (t + u) * R);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) step_map(m, v[u]);
    }
    for (; t < tb; ++t) step_map(m, __ldg(col + t * R));
    unsigned w[MAP / 4];  // a byte a state: the low bytes of two words
#pragma unroll
    for (int k = 0; k < MAP / 4; ++k)
      w[k] = __byte_perm(m[2 * k], m[2 * k + 1], 0x6420);
    uint4* dst = (uint4*)(maps + r * MAP);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
#pragma unroll
    for (int k = 0; k < MAP / 4; ++k) smap[i * ROWW + k] = w[k];
  }
  __syncthreads();
  if (i < MAP) {
    const unsigned char* sb = (const unsigned char*)smap;
    int s = i;
    for (int c = 0; c < seg.cnt; ++c) s = sb[c * ROWW * 4 + s];
    agg[(int64_t)blockIdx.x * MAP + i] = (unsigned char)s;
  }
}

__global__ void __launch_bounds__(ENTRY_THREADS) vli_entry_kernel(
    const unsigned char* __restrict__ agg,
    unsigned char* __restrict__ seg_in, int nseg) {
  __shared__ uint4 sagg[CHUNK * MAP / 16];
  const int64_t base = (int64_t)blockIdx.x * nseg;
  const uint4* src = (const uint4*)(agg + base * MAP);
  const unsigned char* sb = (const unsigned char*)sagg;
  int s = 0;  // thread 0's state entering the next segment
  for (int j0 = 0; j0 < nseg; j0 += CHUNK) {
    const int n = min(CHUNK, nseg - j0);
    for (int w = threadIdx.x; w < n * MAP / 16; w += ENTRY_THREADS)
      sagg[w] = src[(int64_t)j0 * MAP / 16 + w];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int c = 0; c < n; ++c) {
        seg_in[base + j0 + c] = (unsigned char)s;
        s = sb[c * MAP + s];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SEG) vli_replay_kernel(
    const int* __restrict__ x, const unsigned char* __restrict__ maps,
    const unsigned char* __restrict__ seg_in, signed char* __restrict__ out,
    int tb, int64_t R, int nblk, int nseg) {
  __shared__ uint4 smaps[SEG * MAP / 16];
  __shared__ unsigned char entry[SEG];
  const Seg seg(blockIdx.x, nblk, nseg);
  const int i = threadIdx.x;
  const uint4* src = (const uint4*)(maps + seg.r0 * MAP);
  for (int w = i; w < seg.cnt * MAP / 16; w += SEG) smaps[w] = src[w];
  __syncthreads();
  if (i == 0) {
    const unsigned char* sb = (const unsigned char*)smaps;
    int s = seg_in[blockIdx.x];
    for (int c = 0; c < seg.cnt; ++c) {
      entry[c] = (unsigned char)s;
      s = sb[c * MAP + s];
    }
  }
  __syncthreads();
  if (i >= seg.cnt) return;
  const int64_t r = seg.r0 + i;
  const int* col = x + r;
  signed char* o = out + r;
  int s = entry[i];
  int t = 0;
  for (; t + UNROLL <= tb; t += UNROLL) {
    int v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(col + (t + u) * R);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      o[(t + u) * R] = (signed char)s;
      s = step_state(s, v[u]);
    }
  }
  for (; t < tb; ++t) {
    o[t * R] = (signed char)s;
    s = step_state(s, __ldg(col + t * R));
  }
}

static inline int segments(int nblk) { return (nblk + SEG - 1) / SEG; }

static inline int64_t blocks(int64_t R, int nblk) {
  return R / nblk * segments(nblk);
}

// x (tb, R) int32 -> maps (R, 32) and agg (R / nblk * nseg, 32) uint8.
extern "C" int dwt_vli_maps(const void* x, void* maps, void* agg, int tb,
                            int64_t R, int nblk, void* stream) {
  if (nblk <= 0 || tb <= 0 || R % nblk) return (int)cudaErrorInvalidValue;
  const int64_t g = blocks(R, nblk);
  if (g == 0) return 0;
  if (g > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  vli_maps_kernel<<<(unsigned)g, SEG, 0, (cudaStream_t)stream>>>(
      (const int*)x, (unsigned char*)maps, (unsigned char*)agg, tb, R, nblk,
      segments(nblk));
  return (int)cudaGetLastError();
}

// agg (nframes * nseg, 32) -> seg_in (nframes * nseg,) uint8.
extern "C" int dwt_vli_entry(const void* agg, void* seg_in, int64_t nframes,
                             int nblk, void* stream) {
  if (nblk <= 0) return (int)cudaErrorInvalidValue;
  if (nframes == 0) return 0;
  if (nframes > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  vli_entry_kernel<<<(unsigned)nframes, ENTRY_THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const unsigned char*)agg, (unsigned char*)seg_in, segments(nblk));
  return (int)cudaGetLastError();
}

// x (tb, R) int32, maps, seg_in -> out (tb, R) int8.
extern "C" int dwt_vli_replay(const void* x, const void* maps,
                              const void* seg_in, void* out, int tb,
                              int64_t R, int nblk, void* stream) {
  if (nblk <= 0 || tb <= 0 || R % nblk) return (int)cudaErrorInvalidValue;
  const int64_t g = blocks(R, nblk);
  if (g == 0) return 0;
  if (g > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  vli_replay_kernel<<<(unsigned)g, SEG, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const unsigned char*)maps,
      (const unsigned char*)seg_in, (signed char*)out, tb, R, nblk,
      segments(nblk));
  return (int)cudaGetLastError();
}
