// Codeword packing: adds each token's <= 3 disjoint uint32 codeword pieces
// c0, c1, c2 into stream words widx, widx + 1, widx + 2.
//
// Replaces dwt_tpu/ops/pallas_pack.py:pack_words_pallas (_kernel), which
// compacts blocks of tokens into 128-aligned word windows with one-hot MXU
// matmuls and leaves "wild" blocks (spans past its window budget) to a
// straggler pass.  The bits of different tokens are disjoint, so the sum
// (mod 2^32, in any order) is the OR of the pieces.
//
// Bound: bytes, the 16 B read a token plus the whole returned buffer
// written once (the wrapper's zero fill of all nwords; the stream itself
// is a few percent of it).  The design moves each byte about once:
//   - A block takes a tile of TILE consecutive tokens, read with 16-byte
//     loads (ITEMS consecutive tokens a thread).  widx is nondecreasing,
//     and at 4K about ten tokens share a word, so a thread first merges
//     its own tokens' pieces word by word in registers.
//   - The merged pieces go into a shared-memory window of the tile's
//     words, starting at the first token's word, with shared atomics.  A
//     piece past the window (after a jump of widx, where refinement bits
//     are injected) goes straight to a global atomicAdd.
//   - Only this tile's tokens touch the words strictly between the first
//     token's pieces and the last token's word (widx[t0] + 3 ...
//     widx[t1 - 1] - 1): those leave the window with plain coalesced
//     stores.  The <= 3 words at each edge, shared with the neighbouring
//     tiles, are added with global atomics onto the zeroed buffer.
//   - Each thread checks that its tokens and the one before its first
//     are nondecreasing, and sets *flag on a violation; the wrapper (or
//     the encoder, with data it copies to the host anyway) reads it.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                 // consecutive tokens a thread
constexpr int TILE = THREADS * ITEMS;    // tokens a block
constexpr int WIN = 4096;                // words of the shared window

// ITEMS consecutive values from i0 (a multiple of 4), `pad` past n.
__device__ __forceinline__ void load_items(const int* __restrict__ p,
                                           int64_t i0, int64_t n, int pad,
                                           int out[ITEMS]) {
  if (i0 + ITEMS <= n) {
#pragma unroll
    for (int q = 0; q < ITEMS; q += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p + i0 + q));
      out[q] = a.x; out[q + 1] = a.y; out[q + 2] = a.z; out[q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      out[k] = i0 + k < n ? __ldg(p + i0 + k) : pad;
  }
}

__global__ void __launch_bounds__(THREADS)
pack_words_kernel(const int* __restrict__ widx, const int* __restrict__ c0,
                  const int* __restrict__ c1, const int* __restrict__ c2,
                  unsigned int* __restrict__ words, int* __restrict__ flag,
                  int64_t ntok, int64_t nwords) {
  __shared__ unsigned int win[WIN];
  const int64_t t0 = (int64_t)blockIdx.x * TILE;
  const int64_t t1 = t0 + TILE < ntok ? t0 + TILE : ntok;
  const int64_t wfirst = __ldg(widx + t0), wlast = __ldg(widx + t1 - 1);
  // The window: words [wfirst, wfirst + nwin), every word that this tile
  // touches when widx is nondecreasing, up to WIN of them.
  const int64_t span = wlast + 3 - wfirst;
  const int nwin = span <= 0 ? 0 : span < WIN ? (int)span : WIN;
  for (int i = threadIdx.x; i < nwin; i += THREADS) win[i] = 0;

  const int64_t i0 = t0 + (int64_t)threadIdx.x * ITEMS;
  int w[ITEMS], a[ITEMS], b[ITEMS], c[ITEMS];
  load_items(widx, i0, t1, -1, w);
  load_items(c0, i0, t1, 0, a);
  load_items(c1, i0, t1, 0, b);
  load_items(c2, i0, t1, 0, c);

  bool bad = false;
  int prev = i0 > 0 && i0 < t1 ? __ldg(widx + i0 - 1) : INT32_MIN;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (i0 + k < t1) {
      bad |= w[k] < prev;
      prev = w[k];
    }
  }
  if (bad) *flag = 1;
  __syncthreads();  // the window is zeroed

  auto put = [&](int64_t wd, unsigned int v) {
    if (v == 0 || wd < 0 || wd >= nwords) return;
    const int64_t o = wd - wfirst;
    if (o >= 0 && o < nwin)
      atomicAdd(&win[o], v);
    else
      atomicAdd(words + wd, v);
  };
  // Merge runs of tokens on the same or nearby words: (a0, a1, a2) are
  // the sums aimed at words cur, cur + 1, cur + 2.  Tokens whose word is
  // outside [0, nwords) are dropped whole, as are pieces past nwords.
  bool have = false;
  int64_t cur = 0;
  unsigned int a0 = 0, a1 = 0, a2 = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t wk = w[k];
    if (i0 + k >= t1 || wk < 0 || wk >= nwords) continue;
    const unsigned int p0 = a[k], p1 = b[k], p2 = c[k];
    if (have) {
      const int64_t d = wk - cur;
      if (d == 0) {
        a0 += p0; a1 += p1; a2 += p2;
        continue;
      }
      put(cur, a0);
      if (d == 1) {
        a0 = a1 + p0; a1 = a2 + p1; a2 = p2; cur = wk;
        continue;
      }
      put(cur + 1, a1);
      if (d == 2) {
        a0 = a2 + p0; a1 = p1; a2 = p2; cur = wk;
        continue;
      }
      put(cur + 2, a2);
    }
    have = true;
    cur = wk;
    a0 = p0; a1 = p1; a2 = p2;
  }
  if (have) {
    put(cur, a0);
    put(cur + 1, a1);
    put(cur + 2, a2);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nwin; i += THREADS) {
    const int64_t wd = wfirst + i;
    if (wd < 0 || wd >= nwords) continue;
    const unsigned int v = win[i];
    if (wd >= wfirst + 3 && wd < wlast)
      words[wd] = v;  // this tile's alone
    else if (v)
      atomicAdd(words + wd, v);  // shared with a neighbouring tile
  }
}

}  // namespace

extern "C" int dwt_pack_words(const void* widx, const void* c0,
                              const void* c1, const void* c2, void* words,
                              void* flag, int64_t ntok, int64_t nwords,
                              void* stream) {
  if (ntok > 0)
    pack_words_kernel<<<(unsigned)((ntok + TILE - 1) / TILE), THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const int*)widx, (const int*)c0, (const int*)c1, (const int*)c2,
        (unsigned int*)words, (int*)flag, ntok, nwords);
  return (int)cudaGetLastError();
}
