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
// Bound: bytes (each element read once and written once).  A block of
// 32x8 threads moves one 32x32 tile: each warp reads 32 consecutive
// elements of an input row and writes 32 consecutive elements of an
// output row, so both directions are coalesced; the shared tile has a
// padded row (TD + 1) so the column reads of the write phase hit 32
// different banks.  Ragged edges are masked in place (no padding pass,
// no crop).  The dimension with more tiles goes on gridDim.x, which has
// no 65535 limit: at 4K the VLI scan's long side has 7,680 tiles.
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

extern "C" int dwt_transpose(const void* in, void* out, int64_t R, int64_t C,
                             int elem_bytes, void* stream) {
  const int64_t tr = (R + TD - 1) / TD, tc = (C + TD - 1) / TD;
  if (tr == 0 || tc == 0) return 0;
  const bool rows_on_x = tr >= tc;
  const int64_t gx = rows_on_x ? tr : tc, gy = rows_on_x ? tc : tr;
  if (gx > 0x7fffffff || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy), block(TD, TY);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    transpose_kernel<int><<<grid, block, 0, s>>>((const int*)in, (int*)out, R,
                                                 C, rows_on_x);
  else if (elem_bytes == 1)
    transpose_kernel<signed char><<<grid, block, 0, s>>>(
        (const signed char*)in, (signed char*)out, R, C, rows_on_x);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
