// Bitplane compaction kernels A and B.
//
// Both serve UNITS: one (schedule step, E-element chunk of the step's
// detail segment) each, described by one row of an (U, 8) int32
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
// writes; here every output position is known from a rank, so the kernels
// only need ranks.  Only a unit's first col-6 outputs are written, and
// outputs that fall outside the buffer are dropped.
//
// Kernel A is chunk-major.  The units of one chunk (one per plane, a row
// of the (G, P) unit table: slot q holds the meta row of plane q, or -1)
// share its elements, and an element's class at every plane follows from
// one key, its magnitude's bit length b: it is newly significant at plane
// b - 1 only and a zero at every plane >= b.  So a unit's rank of an
// element is the count of earlier elements with the same key, and its
// zero prefix the count of earlier elements with a smaller key.  Two
// launches over a static grid (G chunks x sub-ranges of SUBLEN elements):
//   count: each block reads its sub-range once and writes the histogram
//          of its keys (32 bins: 0 = zero magnitude, 1-30, 31 = padding),
//          and for each of its warps that of the warps before it;
//   place: each warp starts from the histograms of the sub-ranges before
//          its own (at most 15) and of the warps before it, reads its 32
//          elements at a time and ranks them by ballots of the key bits
//          (a 5-level descent gives each lane j the lanes with a key
//          below j), and writes each newly significant element of a live
//          unit at once.
// Each launch reads an element once for all the chunk's live planes.
// Both are bound by integer instructions more than by bytes: about 10 (a
// match) and 55 (the ballots) per element.
//
// Kernel B is chunk-major over the same table, keys and histograms.  An
// element of key b is refined exactly at the planes p < b - 1, so its
// rank in the unit of plane p is the count of earlier elements with a key
// in [p + 2, 30]: a suffix of the same histograms.  Launches over the
// same grid:
//   count:   as A's, on B's meta; the encoder skips it and hands B the
//            histograms of A's count launch (every group live for B has a
//            live A unit: an element refined at plane p is newly
//            significant at a plane above p of the same chunk and
//            channel, which the schedule puts earlier, so a cut that keeps
//            p keeps it; tests/test_torch_refbits_plan.py checks this on
//            lossless, capacity and tiled encodes);
//   scatter: each thread reads 16 consecutive elements once and, for
//            each of the chunk's live planes below the warp's largest key,
//            packs the plane bits of its refined elements into one word
//            (at most 16 consecutive stream bits, so at most two words);
//            a warp scan of the counts places them in the block's run of
//            that plane in shared memory; the words strictly inside a run
//            are then added to the stream with a plain read-modify-write,
//            the two edge words with a global atomicAdd.
// Launches, bytes and atomics of B (the 4K encode: 408 groups x 16
// sub-ranges): on the encoder's path one launch, the scatter, which reads
// each covered element once (4 B), its group's table row and meta rows
// (32 B a plane), its histogram rows (at most 16 + 1 of 128 B), and reads
// and writes each word that holds a refinement bit once (4 + 4 B); it
// issues at most two global atomicAdds a (block, live plane) run and at
// most two shared atomicOrs a (thread, live plane).  Called
// without histograms, the wrapper adds the count launch: the covered
// elements read once more, 1,152 B of histograms written a (chunk,
// sub-range).  One block a unit, as the TPU kernel's grid has it, would
// read each element once a live plane (4-10 times at 4K).
//
// Bound: bytes.  A reads the elements its live units cover (once for the
// bound; twice here, one read a launch) and writes its whole pair buffer
// (the wrapper's zero fill, then one int32 per placed pair); B reads the
// elements its live units cover once and reads and writes each word that
// holds one of their refinement bits.
#include "common.cuh"

namespace {

constexpr int MAGMASK = (1 << 30) - 1;

// ---- Kernel A ---------------------------------------------------------
constexpr int A_THREADS = 256;
constexpr int A_ITEMS = 16;                  // elements per thread
constexpr int A_WARPS = A_THREADS / 32;
constexpr int A_SEG = 32 * A_ITEMS;          // elements per warp
constexpr int SUBLEN = A_THREADS * A_ITEMS;  // elements per sub-range
constexpr int NBIN = 32;
constexpr int PAD_KEY = 31;
// Histogram rows of a (chunk, sub-range): the sub-range's key counts, then
// for each warp the counts of the warps before it.
constexpr int HROWS = 1 + A_WARPS;

// Bit length of an element's magnitude (0 for a zero magnitude, at most
// 30), PAD_KEY for padding.
__device__ __forceinline__ int elem_key(int v) {
  return v < 0 ? PAD_KEY : 32 - __clz(v & MAGMASK);
}

// The units of group g, one a lane of warp 0: lane b gets the meta row of
// table slot b - 1 (the unit of plane b - 1) in m, with m[6] <= 0 where
// there is none or it has no outputs.  Sets the chunk's first element and
// valid length from the first live unit (every unit of a group has the
// same), length 0 if no unit is live.
__device__ __forceinline__ void group_units(const int* __restrict__ meta,
                                            const int* __restrict__ table,
                                            int g, int P, int U, int sub,
                                            int E, int m[8], int64_t* el0,
                                            int* len) {
  const int bin = threadIdx.x & 31;
  const int r = bin >= 1 && bin <= P ? __ldg(table + (int64_t)g * P + bin - 1)
                                     : -1;
  int4 lo = make_int4(0, 0, 0, 0), hi = make_int4(0, 0, 0, 0);
  if (r >= 0 && r < U) {
    lo = __ldg(reinterpret_cast<const int4*>(meta + 8 * (int64_t)r));
    hi = __ldg(reinterpret_cast<const int4*>(meta + 8 * (int64_t)r + 4));
  }
  m[0] = lo.x; m[1] = lo.y; m[2] = lo.z; m[3] = lo.w;
  m[4] = hi.x; m[5] = hi.y; m[6] = hi.z; m[7] = hi.w;
  const unsigned live = __ballot_sync(0xffffffffu, m[6] > 0);
  *len = 0;
  *el0 = 0;
  if (live) {
    const int first = __ffs(live) - 1;
    *el0 = (int64_t)__shfl_sync(0xffffffffu, m[0], first) * sub;
    *len = max(0, min(__shfl_sync(0xffffffffu, m[1], first), E));
  }
}

// Count launch: the key histograms of sub-range s of group g's chunk,
// into hist[((g * nsub + s) * HROWS + row) * NBIN + key]: row 0 for the
// sub-range, row 1 + w for its warps before warp w.
__global__ void __launch_bounds__(A_THREADS)
compact_count_kernel(const int* __restrict__ vmag,
                     const int* __restrict__ meta,
                     const int* __restrict__ table, int* __restrict__ hist,
                     int P, int U, int sub, int E, int nsub) {
  __shared__ int64_t s_el0;
  __shared__ int s_len;
  __shared__ int s_cnt[A_WARPS][NBIN];
  const int g = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int m[8], len;
    int64_t el0;
    group_units(meta, table, g, P, U, sub, E, m, &el0, &len);
    if (lane == 0) s_el0 = el0, s_len = len;
  }
  __syncthreads();
  const int len = s_len;
  if (s * SUBLEN >= len) return;
  const int* el = vmag + s_el0;
  s_cnt[warp][lane] = 0;
  __syncwarp();
  // Thread t reads elements [i0, i0 + A_ITEMS) of the chunk; the first
  // lane of each set of lanes with one key adds the set's size.
  const int i0 = s * SUBLEN + threadIdx.x * A_ITEMS;
#pragma unroll
  for (int q = 0; q < A_ITEMS; q += 4) {
    int v[4];
    if (i0 + q + 4 <= len) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(el + i0 + q));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = i0 + q + k < len ? __ldg(el + i0 + q + k) : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int key = elem_key(v[k]);
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (!(peers & ((1u << lane) - 1u)))
        atomicAdd(&s_cnt[warp][key], __popc(peers));
    }
  }
  __syncthreads();
  if (warp == 0) {
    int* h = hist + ((int64_t)g * nsub + s) * HROWS * NBIN + lane;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < A_WARPS; ++w) {
      h[(1 + w) * NBIN] = sum;
      sum += s_cnt[w][lane];
    }
    h[0] = sum;
  }
}

// Place launch: the j-th newly significant element of a unit gets the
// pair value (zero-prefix << 1) | sign at pair slot col3 + col4 + j, where
// zero-prefix is col5 plus the zeros before it in the unit.
__global__ void __launch_bounds__(A_THREADS)
compact_place_kernel(const int* __restrict__ vmag,
                     const int* __restrict__ meta,
                     const int* __restrict__ table,
                     const int* __restrict__ hist, int* __restrict__ pairs,
                     int P, int U, int sub, int E, int nsub,
                     int64_t npairs) {
  // Per key b (the unit of plane b - 1): first pair slot, zero carry,
  // output count (0: no live unit), and the elements of key b in the
  // sub-ranges before this one.
  __shared__ int64_t s_base[NBIN];
  __shared__ int s_zc[NBIN], s_cnt[NBIN], s_before[NBIN];
  __shared__ int64_t s_el0;
  __shared__ int s_len, s_work;
  const int g = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* h = hist + (int64_t)g * nsub * HROWS * NBIN + lane;
  if (warp == 0) {
    // Rows of hist past the chunk's length are never written; their sum
    // is not used then.
    int before = 0;
#pragma unroll 4
    for (int t = 0; t < s; ++t) before += __ldg(h + t * HROWS * NBIN);
    int m[8], len;
    int64_t el0;
    group_units(meta, table, g, P, U, sub, E, m, &el0, &len);
    const int cnt = max(m[6], 0);
    s_base[lane] = (int64_t)m[3] + m[4];
    s_zc[lane] = m[5];
    s_cnt[lane] = cnt;
    s_before[lane] = before;
    // Work is left if some live unit has not placed all its outputs.
    const unsigned open = __ballot_sync(0xffffffffu, before < cnt);
    if (lane == 0) s_el0 = el0, s_len = len, s_work = open != 0;
  }
  __syncthreads();
  const int len = s_len;
  if (s * SUBLEN >= len || !s_work) return;
  const int* el = vmag + s_el0;

  // Warp w walks the elements [e0, e0 + A_SEG) of the chunk, 32 at a
  // time (lane l takes element e0 + 32 * it + l).  Lane j keeps `below`,
  // the elements before the current 32 (in the unit) with a key < j,
  // starting from the earlier sub-ranges and the earlier warps.
  const int e0 = s * SUBLEN + warp * A_SEG;
  int v[A_ITEMS];
#pragma unroll
  for (int it = 0; it < A_ITEMS; ++it) {
    const int i = e0 + 32 * it + lane;
    v[it] = i < len ? __ldg(el + i) : -1;
  }
  int below = s_before[lane] + __ldg(h + (s * HROWS + 1 + warp) * NBIN);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {  // inclusive scan over the keys
    const int y = __shfl_up_sync(0xffffffffu, below, d);
    if (lane >= d) below += y;
  }
  below = __shfl_up_sync(0xffffffffu, below, 1);  // ... made exclusive
  if (lane == 0) below = 0;
  unsigned jbit[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) jbit[i] = (lane >> i) & 1 ? ~0u : 0u;
  const unsigned before_me = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < A_ITEMS; ++it) {
    const int key = elem_key(v[it]);
    // Lane j: the lanes whose key is below j, from the top bit down
    // (jeq: the lanes equal to j in the bits so far).
    unsigned jeq = 0xffffffffu, jlt = 0;
#pragma unroll
    for (int i = 4; i >= 0; --i) {
      const unsigned B = __ballot_sync(0xffffffffu, (key >> i) & 1);
      jlt |= jeq & ~B & jbit[i];
      jeq &= ~(B ^ jbit[i]);
    }
    // This element's key k: lanes below k and below k + 1, and the
    // elements before these 32 likewise.
    const int k1 = min(key + 1, 31);
    const unsigned lt = __shfl_sync(0xffffffffu, jlt, key);
    const unsigned le = __shfl_sync(0xffffffffu, jlt, k1);
    const int lo = __shfl_sync(0xffffffffu, below, key);
    const int hi = __shfl_sync(0xffffffffu, below, k1);
    below += __popc(jlt);
    const int cnt = s_cnt[key];  // 0 for key 0 and padding
    if (cnt <= 0) continue;
    const int rank = hi - lo + __popc(le & ~lt & before_me);
    const int64_t slot = s_base[key] + rank;
    if (rank < cnt && slot >= 0 && slot < npairs) {
      const unsigned zeros =
          (unsigned)s_zc[key] + lo + __popc(lt & before_me);
      pairs[slot] = (int)((zeros << 1) | ((v[it] >> 30) & 1));
    }
  }
}

// ---- Kernel B ---------------------------------------------------------
// Shared words a block can assemble: its runs hold at most SUBLEN * 29
// bits (an element of key b is refined at the b - 1 <= 29 planes below
// b - 1), and each run adds at most 2 words of alignment.
constexpr int B_WORDS = SUBLEN * 29 / 32 + 2 * NBIN;

// Inclusive sum over the warp's lanes.
__device__ __forceinline__ int warp_incl_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Lane b: the count of x over the lanes (keys) above b, i.e. keys > b.
__device__ __forceinline__ int keys_above(int x) {
  const int incl = warp_incl_scan(x);
  return __shfl_sync(0xffffffffu, incl, 31) - incl;
}

// Scatter launch: the refined elements of sub-range s of group g's chunk,
// every live plane at once.  Lane b of a warp stands for the unit of
// plane b - 1 (table slot b - 1), whose refined elements are those of key
// > b; their rank is a count of earlier keys > b, so the count launch's
// histograms give each warp and the block their starting ranks.  A
// thread reads A_ITEMS consecutive elements once and, for each live plane
// below its largest key, packs the plane bits of its refined elements
// into one word in order (at most A_ITEMS bits); a warp scan of the
// counts places each thread's bits after the earlier threads'.  The
// block's refined elements at one plane form one run of consecutive
// stream bits, which it assembles in shared memory; the words strictly
// inside a run belong to this block alone (distinct units own disjoint
// bit ranges, and the other blocks of the unit own the ranks before and
// after the run) and are added with a plain read-modify-write, the <= 2
// edge words with a global atomicAdd.  Six blocks an SM (at most 40
// registers a thread) measured faster than the five that 44 allow.
__global__ void __launch_bounds__(A_THREADS, 6)
refbits_scatter_kernel(const int* __restrict__ vmag,
                       const int* __restrict__ meta,
                       const int* __restrict__ table,
                       const int* __restrict__ hist,
                       unsigned int* __restrict__ words, int P, int U,
                       int sub, int E, int nsub, int64_t nwords) {
  __shared__ unsigned int s_words[B_WORDS];
  // Per lane b (plane b - 1): the run's first global word, the bit of its
  // first element in that word, its length after the unit's cap (0: no
  // bit to write), and its first word and word count in s_words.
  __shared__ int64_t s_w0[NBIN];
  __shared__ int s_a[NBIN], s_ncap[NBIN], s_seg[NBIN], s_nw[NBIN];
  __shared__ int s_part[A_WARPS][NBIN];
  __shared__ int s_tot;
  __shared__ unsigned int s_live;
  const int g = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* h = hist + (int64_t)g * nsub * HROWS * NBIN + lane;
  // Every warp reads the group's units itself, so its element loads need
  // not wait for the block's plan.
  int m[8], len;
  int64_t el0;
  group_units(meta, table, g, P, U, sub, E, m, &el0, &len);
  // Rows of hist past the chunk's length are never written.
  if (s * SUBLEN >= len) return;
  for (int i = threadIdx.x; i < B_WORDS; i += A_THREADS) s_words[i] = 0;
  const int* el = vmag + el0;

  // Thread t takes the A_ITEMS consecutive elements from i0, so warp w
  // reads [w * A_SEG, (w + 1) * A_SEG) of the sub-range, as the count
  // launch counted it.  Magnitudes only, 0 for padding: an element is
  // refined at plane b - 1 when mag >> (b - 1) > 1.
  const int i0 = s * SUBLEN + threadIdx.x * A_ITEMS;
  unsigned int mag[A_ITEMS], most = 0;
#pragma unroll
  for (int q = 0; q < A_ITEMS; q += 4) {
    int x[4];
    if (i0 + q + 4 <= len) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(el + i0 + q));
      x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[k] = i0 + q + k < len ? __ldg(el + i0 + q + k) : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mag[q + k] = x[k] < 0 ? 0u : (unsigned int)(x[k] & MAGMASK);
      most = max(most, mag[q + k]);
    }
  }
  // Warp w sums the key histograms of sub-ranges w and w + A_WARPS before
  // s, and lane b keeps rank, the warp's next rank in the block's run of
  // plane b - 1 (refined: key > b).
  int part = 0, rank = 0;
  if (lane != PAD_KEY) {
    for (int t = warp; t < s; t += A_WARPS) part += __ldg(h + t * HROWS * NBIN);
    rank = __ldg(h + (s * HROWS + 1 + warp) * NBIN);
  }
  s_part[warp][lane] = part;
  rank = keys_above(rank);
  __syncthreads();
  if (warp == 0) {
    int before = 0;
#pragma unroll
    for (int w = 0; w < A_WARPS; ++w) before += s_part[w][lane];
    const int cur = lane == PAD_KEY ? 0 : __ldg(h + s * HROWS * NBIN);
    const int rank0 = keys_above(before);  // the unit's ranks before s
    const int nrun = keys_above(cur);      // its refined elements in s
    int ncap = m[6] > 0 ? min(max(m[6] - rank0, 0), nrun) : 0;
    const int64_t bit = 32 * (int64_t)m[3] + m[4] + rank0;
    const int64_t w0 = bit >> 5;
    int nw = ncap > 0 ? (int)(((bit + ncap - 1) >> 5) - w0 + 1) : 0;
    const int end = warp_incl_scan(nw);
    if (end > B_WORDS) ncap = nw = 0;  // only with histograms of other data
    s_w0[lane] = w0;
    s_a[lane] = (int)(bit & 31);
    s_ncap[lane] = ncap;
    s_seg[lane] = end - nw;
    s_nw[lane] = nw;
    const unsigned int live = __ballot_sync(0xffffffffu, ncap > 0);
    const int tot = __reduce_max_sync(0xffffffffu, ncap > 0 ? end : 0);
    if (lane == 0) s_live = live, s_tot = tot;
  }
  const int kt = 32 - __clz(most);  // this thread's largest key
  const int km = __reduce_max_sync(0xffffffffu, kt);
  __syncthreads();
  const unsigned int live = s_live;
  if (!live) return;
  // The live planes b - 1 at which some element of the warp is refined.
  for (unsigned int todo = live & ((1u << km) - 1u); todo; todo &= todo - 1) {
    const int b = __ffs(todo) - 1;
    // This thread's refined elements at plane b - 1, in order: cnt of
    // them, their plane bits packed from bit 0 (shifted in from the right,
    // then reversed).
    unsigned int bits = 0;
    int cnt = 0;
    if (b < kt) {
#pragma unroll
      for (int k = 0; k < A_ITEMS; ++k) {
        const unsigned int t = mag[k] >> (b - 1);
        if (t > 1) bits = 2 * bits + (t & 1u), ++cnt;
      }
      bits = __brev(bits) >> (32 - max(cnt, 1));
    }
    const int incl = warp_incl_scan(cnt);
    const int r0 = __shfl_sync(0xffffffffu, rank, b) + incl - cnt;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == b) rank += total;
    // Ranks r0 ... r0 + cnt - 1 of the run, capped at the unit's count:
    // at most A_ITEMS consecutive bits, in at most two words.
    const int ncap = s_ncap[b];
    if (r0 >= ncap) continue;
    if (ncap - r0 < cnt) bits &= (1u << (ncap - r0)) - 1u;
    if (!bits) continue;
    const int pos = s_a[b] + r0, sh = pos & 31;
    unsigned int* w = s_words + s_seg[b] + (pos >> 5);
    atomicOr(w, bits << sh);
    if (sh && bits >> (32 - sh)) atomicOr(w + 1, bits >> (32 - sh));
  }
  __syncthreads();
  // Word i of s_words belongs to the run of the live lane b whose words
  // s_seg[b] ... s_seg[b] + s_nw[b] - 1 hold it.
  for (int i = threadIdx.x; i < s_tot; i += A_THREADS) {
    unsigned int todo = live;
    int b = __ffs(todo) - 1;
    while (i >= s_seg[b] + s_nw[b]) {
      todo &= todo - 1;
      b = __ffs(todo) - 1;
    }
    const unsigned int x = s_words[i];
    const int64_t w = s_w0[b] + i - s_seg[b];
    if (!x || w < 0 || w >= nwords) continue;
    if (i == s_seg[b] || i == s_seg[b] + s_nw[b] - 1)
      atomicAdd(words + w, x);
    else
      words[w] += x;
  }
}

}  // namespace

extern "C" int dwt_compact_count(const void* vmag, const void* meta,
                                 const void* table, void* hist, int groups,
                                 int P, int U, int sub, int E, int nsub,
                                 void* stream) {
  if (groups > 0 && nsub > 0)
    compact_count_kernel<<<dim3(groups, nsub), A_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int*)vmag, (const int*)meta, (const int*)table, (int*)hist, P,
        U, sub, E, nsub);
  return (int)cudaGetLastError();
}

extern "C" int dwt_compact_place(const void* vmag, const void* meta,
                                 const void* table, const void* hist,
                                 void* pairs, int groups, int P, int U,
                                 int sub, int E, int nsub, int64_t npairs,
                                 void* stream) {
  if (groups > 0 && nsub > 0)
    compact_place_kernel<<<dim3(groups, nsub), A_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int*)vmag, (const int*)meta, (const int*)table,
        (const int*)hist, (int*)pairs, P, U, sub, E, nsub, npairs);
  return (int)cudaGetLastError();
}

extern "C" int dwt_refbits_scatter(const void* vmag, const void* meta,
                                   const void* table, const void* hist,
                                   void* words, int groups, int P, int U,
                                   int sub, int E, int nsub, int64_t nwords,
                                   void* stream) {
  if (groups > 0 && nsub > 0)
    refbits_scatter_kernel<<<dim3(groups, nsub), A_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const int*)vmag, (const int*)meta, (const int*)table,
        (const int*)hist, (unsigned int*)words, P, U, sub, E, nsub, nwords);
  return (int)cudaGetLastError();
}
