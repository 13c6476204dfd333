// The encoder's forward transform: YCoCg-R colour (image.h:39-79) and the
// multi-level integer CDF 5/3 lifting (cdf53.h:9-34, encode.c:16-30) of N
// (N, H, W, C) frames, one launch a level.
//
// No TPU kernel to replace: the JAX package runs the transform as XLA
// (dwt_tpu/ops/lifting.py:dwt2d_fwd and dwt_tpu/ops/color.py:rgb_to_ycocg,
// traced into one program with dwt_tpu/codec/encoder.py:
// _transform_and_stats), which fuses each direction's predict, update and
// deinterleave into one pass.  The plain PyTorch version
// (ops/lifting.py:forward_transform_plain) runs the same formulas eagerly,
// about 230 launches at 4K, with strided whole-level passes.
//
// Semantics: every division truncates toward zero (C's /).  Along an axis
// of n samples x, deinterleaved [L | H]: the odd sample k gets d = x[k] -
// (x[k-1] + x[k+1]) / 2, its right neighbour clamped to x[k-1] at k + 1 ==
// n; the even sample k gets s = x[k] + (d[k-1] + d[k+1]) / 4, its left
// neighbour clamped to d[k+1] at k == 0, except the last sample of an
// odd n, which keeps its value.  Rows first, then columns; the LL quadrant
// recurses.
//
// Bound: bytes.  The function reads each frame once (1 byte a sample for
// uint8 frames) and writes the (N, H, W, C) int32 coefficients once; its
// integer work (about 14 operations a sample over all levels) takes less
// time than those bytes at the card's INT32 rate.
//
// lift_fwd_kernel: one CUDA block a tile of TP x TP output pairs (2TP x
// 2TP samples) of one frame and level.  It loads the tile's input with a
// halo of 2 samples before and 1 after in each direction into shared
// memory (the colour transform applied as the finest level's frames load),
// lifts the rows of the whole halo tile (predict, then update), then the
// columns of its 2TP output columns, and writes the tile once,
// deinterleaved: the three detail quadrants straight into the coefficient
// tensor, the LL quadrant into the next level's input buffer (or, at the
// last level, into coeff[:h0, :w0]).  A level's output positions overlap
// other tiles' input positions, so its input is never the coefficient
// tensor: the wrapper ping-pongs two LL buffers.
#include "common.cuh"

constexpr int TP = 16;          // output pairs a tile side
constexpr int TS = 2 * TP + 3;  // halo tile side: 2 before, 1 after
constexpr int TSP = TS + 2;     // padded shared row (odd: fewer conflicts)
constexpr int THREADS = 256;

__device__ __forceinline__ int ycocg(int ch, int R, int G, int B) {
  const int U = R - B;
  const int T = B + U / 2;
  const int V = G - T;
  return ch == 0 ? T + V / 2 : (ch == 1 ? U : V);
}

// Where a sample lives: frame base, row and pixel strides in elements.
struct Plane {
  int64_t frame, row;
};

template <int C>
__global__ void __launch_bounds__(THREADS) lift_fwd_kernel(
    const void* __restrict__ src, int src_u8, int colour, Plane in,
    int* __restrict__ coeff, Plane co, int* __restrict__ ll, Plane lo,
    int h, int w) {
  __shared__ int t[C][TS][TSP];
  const int n = (int)blockIdx.z;
  const int r0 = 2 * TP * (int)blockIdx.y - 2;  // tile origin, halo included
  const int c0 = 2 * TP * (int)blockIdx.x - 2;
  const int tid = threadIdx.x;

  // Load the halo tile; samples outside the level are never read below.
  for (int p = tid; p < TS * TS; p += THREADS) {
    const int r = p / TS, k = p % TS;
    const int gr = r0 + r, gc = c0 + k;
    if (gr < 0 || gr >= h || gc < 0 || gc >= w) continue;
    const int64_t o = n * in.frame + gr * in.row + (int64_t)gc * C;
    int v[C];
    if (src_u8) {
      const unsigned char* s = (const unsigned char*)src + o;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) v[ch] = s[ch];
    } else {
      const int* s = (const int*)src + o;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) v[ch] = s[ch];
    }
    if (C == 3 && colour) {
      const int R = v[0], G = v[1 % C], B = v[2 % C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) v[ch] = ycocg(ch, R, G, B);
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) t[ch][r][k] = v[ch];
  }
  __syncthreads();

  // Rows: predict the odd columns k = 1, 3, .., 2TP + 1 of every row in the
  // level (TP + 1 of them), then update the even columns 2, .., 2TP.
  for (int p = tid; p < C * TS * (TP + 1); p += THREADS) {
    const int ch = p / (TS * (TP + 1)), rem = p % (TS * (TP + 1));
    const int r = rem / (TP + 1), k = 2 * (rem % (TP + 1)) + 1;
    const int gr = r0 + r, gc = c0 + k;
    if (gr < 0 || gr >= h || gc < 0 || gc >= w) continue;
    const int right = gc + 1 < w ? k + 1 : k - 1;
    t[ch][r][k] -= (t[ch][r][k - 1] + t[ch][r][right]) / 2;
  }
  __syncthreads();
  for (int p = tid; p < C * TS * TP; p += THREADS) {
    const int ch = p / (TS * TP), rem = p % (TS * TP);
    const int r = rem / TP, k = 2 * (rem % TP) + 2;
    const int gr = r0 + r, gc = c0 + k;
    if (gr < 0 || gr >= h || gc >= w) continue;
    if ((w & 1) && gc == w - 1) continue;  // odd n: no update on the last
    const int left = gc >= 1 ? k - 1 : k + 1;
    t[ch][r][k] += (t[ch][r][left] + t[ch][r][k + 1]) / 4;
  }
  __syncthreads();

  // Columns, on the tile's output columns 2 .. 2TP + 1 only.
  for (int p = tid; p < C * (TP + 1) * 2 * TP; p += THREADS) {
    const int ch = p / ((TP + 1) * 2 * TP), rem = p % ((TP + 1) * 2 * TP);
    const int r = 2 * (rem / (2 * TP)) + 1, k = rem % (2 * TP) + 2;
    const int gr = r0 + r, gc = c0 + k;
    if (gr < 0 || gr >= h || gc >= w) continue;
    const int below = gr + 1 < h ? r + 1 : r - 1;
    t[ch][r][k] -= (t[ch][r - 1][k] + t[ch][below][k]) / 2;
  }
  __syncthreads();
  for (int p = tid; p < C * TP * 2 * TP; p += THREADS) {
    const int ch = p / (TP * 2 * TP), rem = p % (TP * 2 * TP);
    const int r = 2 * (rem / (2 * TP)) + 2, k = rem % (2 * TP) + 2;
    const int gr = r0 + r, gc = c0 + k;
    if (gr >= h || gc >= w) continue;
    if ((h & 1) && gr == h - 1) continue;
    const int above = gr >= 1 ? r - 1 : r + 1;
    t[ch][r][k] += (t[ch][above][k] + t[ch][r + 1][k]) / 4;
  }
  __syncthreads();

  // Store deinterleaved: output row a (0 .. 2TP - 1) is the tile's even
  // rows first, then its odd rows; within a row, channels fastest, the
  // even columns first, then the odd ones (two runs of TP * C contiguous
  // elements a row).
  const int heven = (h + 1) / 2, weven = (w + 1) / 2;
  const int i0 = TP * (int)blockIdx.y, j0 = TP * (int)blockIdx.x;
  for (int p = tid; p < 2 * TP * 2 * TP * C; p += THREADS) {
    const int a = p / (2 * TP * C), rem = p % (2 * TP * C);
    const int b = rem / C, ch = rem % C;
    const int odd_r = a >= TP, odd_c = b >= TP;
    const int i = i0 + a - odd_r * TP, j = j0 + b - odd_c * TP;  // pair
    const int gr = 2 * i + odd_r, gc = 2 * j + odd_c;
    if (gr >= h || gc >= w) continue;
    const int v = t[ch][gr - r0][gc - c0];
    if (!odd_r && !odd_c) {
      ll[n * lo.frame + i * lo.row + (int64_t)j * C + ch] = v;
    } else {
      const int orow = odd_r ? heven + i : i, ocol = odd_c ? weven + j : j;
      coeff[n * co.frame + orow * co.row + (int64_t)ocol * C + ch] = v;
    }
  }
}

// One level: src (the frames, uint8 or int32, or the previous level's LL
// buffer, int32) of n frames of h x w samples and C channels at the given
// frame and row strides (elements) -> the level's detail quadrants into
// coeff and its LL quadrant into ll, each at its own strides.
extern "C" int dwt_lift_fwd(const void* src, int src_u8, int colour,
                            int64_t src_frame, int64_t src_row, void* coeff,
                            int64_t co_frame, int64_t co_row, void* ll,
                            int64_t ll_frame, int64_t ll_row, int n, int h,
                            int w, int C, void* stream) {
  if (n < 0 || h < 1 || w < 1 || n > 65535 || (C != 1 && C != 3))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 grid((w + 2 * TP - 1) / (2 * TP), (h + 2 * TP - 1) / (2 * TP),
                  n);
  const Plane in{src_frame, src_row}, co{co_frame, co_row},
      lo{ll_frame, ll_row};
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1)
    lift_fwd_kernel<1><<<grid, THREADS, 0, s>>>(src, src_u8, colour, in,
                                                 (int*)coeff, co, (int*)ll,
                                                 lo, h, w);
  else
    lift_fwd_kernel<3><<<grid, THREADS, 0, s>>>(src, src_u8, colour, in,
                                                 (int*)coeff, co, (int*)ll,
                                                 lo, h, w);
  return (int)cudaGetLastError();
}
