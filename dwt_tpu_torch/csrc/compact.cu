// Bitplane compaction kernels A and B.
//
// Both walk UNITS: one (schedule step, E-element chunk of the step's
// detail segment) per CUDA block, described by one row of an (U, 8) int32
// metadata table that the encoder builds (codec/tokens.py:_kernel_a_meta,
// codec/emit.py:_kernel_b_meta):
//   0: first element row (elements start at row * sub)   1: valid elements
//   2: plane p                                            3: window start
//   4: output offset from the window start                5: zero carry (A)
//   6: number of outputs (0: skip the unit)               7: unused
// Elements are packed as bits 0-29 |coeff|, bit 30 sign, -1 for padding.
// At plane p an element with magnitude bits sh = |coeff| >> p is a zero
// (sh == 0), newly significant (sh == 1) or refined (sh > 1).
//
// Replaces dwt_tpu/ops/pallas_compact.py:compact_tokens_pallas (_a_kernel)
// and scatter_refbits_pallas (_b_kernel).  Those place values with one-hot
// MXU matmuls inside windows that the sequential TPU grid read-modify-
// writes; here the blocks run in parallel and every output position is
// already known from a rank, so a block only needs the ranks: it walks its
// chunk in tiles of TILE elements, each tile one block-wide exclusive scan
// of the per-thread flag counts, with the running totals carried from tile
// to tile in registers.  A block stops as soon as it has placed its
// unit's count (meta col 6): only a unit's first col-6 outputs are
// written, and the elements after its last one are never read.  Outputs
// that fall outside the buffer are dropped.
//
// Bound: bytes.  Each tile reads TILE packed elements once (two 16-byte
// loads per thread); A writes one int32 per significant element, B does
// one atomicAdd per refined element whose plane bit is 1.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;  // consecutive elements per thread and tile
constexpr int TILE = THREADS * ITEMS;
constexpr int MAGMASK = (1 << 30) - 1;

// This thread's ITEMS elements of the tile starting at element t0 of the
// unit; -1 (padding) past the unit's valid length.
__device__ __forceinline__ void load_items(const int* __restrict__ el,
                                           int t0, int len, int v[ITEMS]) {
  const int i0 = t0 + threadIdx.x * ITEMS;
  if (i0 + ITEMS <= len) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(el + i0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(el + i0 + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      v[k] = i0 + k < len ? __ldg(el + i0 + k) : -1;
  }
}

// Kernel A: the j-th newly significant element of the unit gets the pair
// value (zero-prefix << 1) | sign at pair slot window + offset + j, where
// zero-prefix counts the zero elements before it (plus the carry).
__global__ void __launch_bounds__(THREADS)
compact_tokens_kernel(const int* __restrict__ vmag,
                      const int* __restrict__ meta, int* __restrict__ pairs,
                      int sub, int E, int64_t npairs) {
  __shared__ int warp_sums[32];
  const int* m = meta + 8 * (int64_t)blockIdx.x;
  const int nsig = m[6];
  if (nsig <= 0) return;
  const int* el = vmag + (int64_t)m[0] * sub;
  const int len = min(m[1], E), p = m[2];
  const int64_t base = (int64_t)m[3] + m[4];
  int placed = 0, zeros = m[5];
  for (int t0 = 0; t0 < len && placed < nsig; t0 += TILE) {
    int v[ITEMS];
    load_items(el, t0, len, v);
    int ns = 0, nz = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int sh = (v[k] & MAGMASK) >> p;
      ns += v[k] >= 0 && sh == 1;
      nz += v[k] >= 0 && sh == 0;
    }
    // Both counts in one scan: a tile holds < 2^16 of each.
    int total;
    const int pre = block_excl_scan(ns | (nz << 16), warp_sums, &total);
    int r = placed + (pre & 0xffff), z = zeros + (pre >> 16);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (v[k] < 0) continue;
      const int sh = (v[k] & MAGMASK) >> p;
      if (sh == 1) {
        const int64_t slot = base + r;
        if (r++ < nsig && slot >= 0 && slot < npairs)
          pairs[slot] = (z << 1) | ((v[k] >> 30) & 1);
      } else if (sh == 0) {
        ++z;
      }
    }
    placed += total & 0xffff;
    zeros += total >> 16;
  }
}

// Kernel B: the j-th refined element of the unit owns stream bit
// 32 * window + offset + j and adds its plane bit there.  The stream words
// already hold the token codewords, whose bits are disjoint from these, so
// the add is an OR; it is an add so that the kernel computes the TPU
// kernel's function (which adds) on any input.
__global__ void __launch_bounds__(THREADS)
scatter_refbits_kernel(const int* __restrict__ vmag,
                       const int* __restrict__ meta,
                       unsigned int* __restrict__ words, int sub, int E,
                       int64_t nwords) {
  __shared__ int warp_sums[32];
  const int* m = meta + 8 * (int64_t)blockIdx.x;
  const int nref = m[6];
  if (nref <= 0) return;
  const int* el = vmag + (int64_t)m[0] * sub;
  const int len = min(m[1], E), p = m[2];
  const int64_t bit0 = 32 * (int64_t)m[3] + m[4];
  int done = 0;
  for (int t0 = 0; t0 < len && done < nref; t0 += TILE) {
    int v[ITEMS];
    load_items(el, t0, len, v);
    int nr = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      nr += v[k] >= 0 && ((v[k] & MAGMASK) >> p) > 1;
    int total;
    int r = done + block_excl_scan(nr, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (v[k] < 0) continue;
      const int sh = (v[k] & MAGMASK) >> p;
      if (sh > 1) {
        const int64_t bit = bit0 + r;
        const int64_t w = bit >> 5;
        if (r++ < nref && (sh & 1) && w >= 0 && w < nwords)
          atomicAdd(words + w, 1u << (bit & 31));
      }
    }
    done += total;
  }
}

}  // namespace

extern "C" int dwt_compact_tokens(const void* vmag, const void* meta,
                                  void* pairs, int units, int sub, int E,
                                  int64_t npairs, void* stream) {
  if (units > 0)
    compact_tokens_kernel<<<units, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)vmag, (const int*)meta, (int*)pairs, sub, E, npairs);
  return (int)cudaGetLastError();
}

extern "C" int dwt_scatter_refbits(const void* vmag, const void* meta,
                                   void* words, int units, int sub, int E,
                                   int64_t nwords, void* stream) {
  if (units > 0)
    scatter_refbits_kernel<<<units, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)vmag, (const int*)meta, (unsigned int*)words, sub, E,
        nwords);
  return (int)cudaGetLastError();
}
