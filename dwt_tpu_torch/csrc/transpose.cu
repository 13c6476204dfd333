// 2-D transpose: (R, C) -> (C, R), for 4-byte (int32, and uint32 carried
// as int32 bits) and 1-byte (int8) elements, any R and C.
//
// Replaces dwt_tpu/ops/pallas_transpose.py:transpose2d (kernels
// _t32_kernel and _t8_kernel), which pads to (128, 256) tiles and
// contracts each tile with a constant identity on the MXU, one byte plane
// at a time, because an XLA transpose of the VLI scan's layouts ran
// shuffle-bound on the TPU.  Hopper needs no such trick: a tile goes
// through shared memory.
//
// Bound: bytes (each element read once and written once).
//
// Element kernel (int32, and int8 shapes whose sides are not multiples of
// 16): a block of 32x8 threads moves one 32x32 tile: each warp reads 32
// consecutive elements of an input row and writes 32 consecutive elements
// of an output row, so both directions are coalesced; the shared tile has
// a padded row (TD + 1) so the column reads of the write phase hit 32
// different banks.  For int8 that is one byte a thread, and the load and
// store units, not the bytes, set its time.
//
// Byte kernel (int8 with both sides multiples of 16, as the VLI scan's
// (128, nblk) always is: nblk = padded_T / 128 and padded_T is a multiple
// of 2,048): a block of 256 threads moves one 128x128 byte tile.  It reads
// the tile in 16-byte words along the input rows (a warp covers whole
// 128-byte lines) into shared memory, whose rows are XOR-swizzled by words
// so that both phases are free of bank conflicts; each thread then reads a
// 16x4 byte block as 16 words, turns its 4x4 byte blocks with __byte_perm
// in registers, and writes 4 output rows of 16 bytes (8 lanes on one
// 128-byte output line).  Ragged edges are masked in place at whole words
// (no padding pass, no crop).  The wrapper picks the kernel from the
// shape.
//
// In both, the dimension with more tiles goes on gridDim.x, which has no
// 65535 limit: at 4K the VLI scan's long side has 1,920 byte tiles.
#include "common.cuh"

constexpr int TD = 32;  // tile side
constexpr int TY = 8;   // thread rows a block (each moves TD / TY rows)

template <typename T>
__global__ void transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 int64_t R, int64_t C, bool rows_on_x) {
  __shared__ T tile[TD][TD + 1];
  const int64_t r0 = (int64_t)(rows_on_x ? blockIdx.x : blockIdx.y) * TD;
  const int64_t c0 = (int64_t)(rows_on_x ? blockIdx.y : blockIdx.x) * TD;
  const int tx = threadIdx.x;
#pragma unroll
  for (int k = 0; k < TD; k += TY) {
    const int j = threadIdx.y + k;
    const int64_t r = r0 + j, c = c0 + tx;
    if (r < R && c < C) tile[j][tx] = in[r * C + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < TD; k += TY) {
    const int j = threadIdx.y + k;
    const int64_t c = c0 + j, r = r0 + tx;
    if (c < C && r < R) out[c * R + r] = tile[tx][j];
  }
}

constexpr int TB = 128;          // byte tile side
constexpr int TBW = TB / 4;      // words of a tile row
constexpr int TB_THREADS = 256;
constexpr int V = 16;            // bytes a thread loads or stores at once
constexpr int PER_ROW = TB / V;  // 16-byte words of a tile row

// The word XOR of tile row `row`: a multiple of 4, so a 16-byte word stays
// whole; rows 16 apart get different XORs, so the column reads of the
// second phase hit 32 different banks.
__device__ __forceinline__ int swizzle(int row) {
  return ((row >> 4) & 7) << 2;
}

// Rows a, b, c, d of a 4x4 byte block -> its columns 0..3.
__device__ __forceinline__ void transpose4x4(unsigned& a, unsigned& b,
                                             unsigned& c, unsigned& d) {
  const unsigned x0 = __byte_perm(a, b, 0x5140);
  const unsigned x1 = __byte_perm(a, b, 0x7362);
  const unsigned y0 = __byte_perm(c, d, 0x5140);
  const unsigned y1 = __byte_perm(c, d, 0x7362);
  a = __byte_perm(x0, y0, 0x5410);
  b = __byte_perm(x0, y0, 0x7632);
  c = __byte_perm(x1, y1, 0x5410);
  d = __byte_perm(x1, y1, 0x7632);
}

__global__ void __launch_bounds__(TB_THREADS, 8) transpose_bytes_kernel(
    const signed char* __restrict__ in, signed char* __restrict__ out,
    int64_t R, int64_t C, bool rows_on_x) {
  __shared__ __align__(16) unsigned tile[TB * TBW];
  const int64_t r0 = (int64_t)(rows_on_x ? blockIdx.x : blockIdx.y) * TB;
  const int64_t c0 = (int64_t)(rows_on_x ? blockIdx.y : blockIdx.x) * TB;
  const int t = threadIdx.x;
  // 1. Consecutive threads on consecutive 16-byte words of a row: a warp
  // reads four whole 128-byte lines.
#pragma unroll
  for (int i = 0; i < TB * PER_ROW / TB_THREADS; ++i) {
    const int u = t + i * TB_THREADS, row = u / PER_ROW, w = u % PER_ROW;
    const int64_t r = r0 + row, c = c0 + (int64_t)w * V;
    if (r < R && c < C)
      *(uint4*)(tile + row * TBW + ((w * 4) ^ swizzle(row))) =
          __ldg((const uint4*)(in + r * C + c));
  }
  __syncthreads();
  // 2. Thread (a, b): input rows 16a .. 16a+15, input columns 4b .. 4b+3,
  // read as 16 words and turned into 4 output rows of 16 bytes; lanes
  // with consecutive a write one 128-byte output line.
  const int a = t % PER_ROW, b = t / PER_ROW;
  unsigned x[V];
#pragma unroll
  for (int m = 0; m < V; ++m) {
    const int row = a * V + m;
    x[m] = tile[row * TBW + (b ^ swizzle(row))];
  }
#pragma unroll
  for (int m = 0; m < V; m += 4)
    transpose4x4(x[m], x[m + 1], x[m + 2], x[m + 3]);
  // x[4j + k]: output row 4b + k, bytes of input rows 16a+4j .. +3.
  const int64_t r = r0 + a * V;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t c = c0 + 4 * b + k;
    if (c < C && r < R)
      *(uint4*)(out + c * R + r) = make_uint4(x[k], x[4 + k], x[8 + k],
                                              x[12 + k]);
  }
}

// vec: 1 for the element kernel; 16 for the byte kernel (int8 only, R and
// C multiples of 16, 16-byte aligned buffers).
extern "C" int dwt_transpose(const void* in, void* out, int64_t R, int64_t C,
                             int elem_bytes, int vec, void* stream) {
  const int td = vec == 1 ? TD : TB;
  const int64_t tr = (R + td - 1) / td, tc = (C + td - 1) / td;
  if (tr == 0 || tc == 0) return 0;
  const bool rows_on_x = tr >= tc;
  const int64_t gx = rows_on_x ? tr : tc, gy = rows_on_x ? tc : tr;
  if (gx > 0x7fffffff || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* i8 = (const signed char*)in;
  auto* o8 = (signed char*)out;
  if (vec != 1) {
    if (elem_bytes != 1 || vec != V || R % V || C % V)
      return (int)cudaErrorInvalidValue;
    transpose_bytes_kernel<<<grid, TB_THREADS, 0, s>>>(i8, o8, R, C,
                                                       rows_on_x);
  } else if (elem_bytes == 4) {
    transpose_kernel<int><<<grid, dim3(TD, TY), 0, s>>>(
        (const int*)in, (int*)out, R, C, rows_on_x);
  } else if (elem_bytes == 1) {
    transpose_kernel<signed char><<<grid, dim3(TD, TY), 0, s>>>(
        i8, o8, R, C, rows_on_x);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
