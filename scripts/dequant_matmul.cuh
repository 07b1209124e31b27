// The earlier design of kernels K3 (int8) and K4 (int4): a weight-only
// dequant matrix product with fp32 products on the CUDA cores. No kernel of
// the port uses it: K3 and K4 are the instances of
// msr3d_tpu_torch/csrc/wq_matmul.cuh. It is kept for scripts/w8_parent.cu and
// scripts/w4_parent.cu, which time it beside them (chip_smoke.py,
// scripts/w8_variants.py, scripts/w4_variants.py).
//
//   y[b, n] = bf16( (sum_k x[b, k] * w[k, n]) * scale[n] ),  fp32 accumulator
//
// x is (B, K) bf16, y (B, N) bf16, scale (N,) fp32. The weight wq is int8,
// row-major along N: (K, N) for BITS 8; for BITS 4 (K/2, N) in the kernel
// layout of the TPU kernel's pack_w4: the byte at packed row r holds input row r in its low nibble,
// biased by +8, and input row r + K/2 in its high nibble, two's complement.
//
// Every product bf16(x) * w has at most 8 + 4 significant bits and is exact
// in fp32, so the kernel and its plain version differ only in the order of
// the fp32 sums, then by the one rounding to bf16.
//
// What bounds it: at decode (B = 4..16 rows) the weight is read once and is
// almost all the bytes, 4 * B operations per weight byte, far below the
// card's ratio of operations to bytes. The design streams the weight once
// with every load coalesced along N and keeps everything else on chip:
//   * one block of 256 threads per tile of 32 output columns and up to 16
//     rows of x; rows beyond 16 take more blocks along grid.y (a prefill is
//     correct, if slow: each row tile reads the weight again);
//   * thread (lane, column group) owns 4 adjacent columns, loads their 4
//     weight bytes as one 32-bit word per packed row and keeps fp32
//     accumulators for every row in registers; the 32 lanes split the
//     contraction (rows lane, lane + 32, ...), and each lane starts the loads
//     of all its rows of a staged chunk (8 words) before it uses them;
//   * x is staged in shared memory 256 packed rows at a time, as fp32 in
//     [row of the contraction][row of x] order, so one 16-byte load gives a
//     thread four rows of x for one weight row;
//   * the 32 lanes' partial sums meet through warp shuffles and one pass
//     through shared memory; the scale is applied once, on the fp32 sum, and
//     the output written in bf16.
// The nibbles are unpacked with integer shifts: the high one by an arithmetic
// shift, the low one by a mask minus 8.
//
// The function is bound by its weight bytes. This design is not: it does its
// 2 * B * K * N operations as fp32 FMAs on the CUDA cores, and at B = 16 those
// take longer than the weight's bytes (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dqmm {

constexpr int kThreads = 256;
constexpr int kCols = 4;                        // adjacent output columns per thread
constexpr int kColThreads = 8;                  // threads across a block's columns
constexpr int kTileN = kCols * kColThreads;     // 32 output columns per block
constexpr int kLanes = kThreads / kColThreads;  // 32 lanes split the contraction
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;                     // packed rows of x staged at a time
constexpr int kUnroll = kChunk / kLanes;        // packed rows in flight per lane (8)

static_assert(kWarps * kTileN == kChunk, "the reduction reuses one staged side of x");

// The 4 weight bytes of columns n0 .. n0 + 3 of one packed row as one word,
// column n0 in the lowest byte; 0 past N.
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ row, int n0, int n) {
  if (VEC)  // N % 4 == 0 and the row 4-byte aligned: n0 < N covers all four
    return n0 < n ? *reinterpret_cast<const uint32_t*>(row + n0) : 0u;
  uint32_t word = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (n0 + c < n) word |= (uint32_t)(uint8_t)row[n0 + c] << (8 * c);
  return word;
}

// Byte c of a word as a signed value.
__device__ __forceinline__ int byte_at(uint32_t word, int c) {
  return (int)(word << (24 - 8 * c)) >> 24;
}

template <int BITS, int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                      int b, int k, int n) {
  constexpr int kSides = BITS == 4 ? 2 : 1;  // int4: x's low and high halves of K
  __shared__ __align__(16) float smem[kSides * kChunk * R];

  const int tid = threadIdx.x;
  const int cg = tid % kColThreads;
  const int lane_k = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN + cg * kCols;
  const int row0 = blockIdx.y * R;
  const int rows = BITS == 4 ? k / 2 : k;  // packed rows of the weight

  float acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int p0 = 0; p0 < rows; p0 += kChunk) {
    const int len = min(kChunk, rows - p0);
    // stage x[row0 + r, side * rows + p0 + i] at smem[(side * kChunk + i) * R + r]
    for (int idx = tid; idx < kSides * R * kChunk; idx += kThreads) {
      const int side = idx / (R * kChunk);
      const int r = (idx / kChunk) % R;
      const int i = idx % kChunk;
      float v = 0.f;
      if (row0 + r < b && i < len)
        v = __bfloat162float(x[(size_t)(row0 + r) * k + side * rows + p0 + i]);
      smem[(side * kChunk + i) * R + r] = v;
    }
    __syncthreads();

    if (n0 < n) {
      for (int i = lane_k; i < len; i += kLanes * kUnroll) {
        uint32_t words[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int ii = i + u * kLanes;
          words[u] = ii < len ? load_word<VEC>(wq + (size_t)(p0 + ii) * n, n0, n) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int ii = i + u * kLanes;
          if (ii >= len) break;
          const float4* xa = reinterpret_cast<const float4*>(smem + ii * R);
          if (BITS == 8) {
            float w[kCols];
#pragma unroll
            for (int c = 0; c < kCols; ++c) w[c] = (float)byte_at(words[u], c);
#pragma unroll
            for (int q = 0; q < R / 4; ++q) {
              const float4 xv = xa[q];
#pragma unroll
              for (int c = 0; c < kCols; ++c) {
                acc[4 * q + 0][c] = fmaf(xv.x, w[c], acc[4 * q + 0][c]);
                acc[4 * q + 1][c] = fmaf(xv.y, w[c], acc[4 * q + 1][c]);
                acc[4 * q + 2][c] = fmaf(xv.z, w[c], acc[4 * q + 2][c]);
                acc[4 * q + 3][c] = fmaf(xv.w, w[c], acc[4 * q + 3][c]);
              }
            }
          } else {
            const float4* xb = reinterpret_cast<const float4*>(smem + (kChunk + ii) * R);
            float lo[kCols], hi[kCols];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              const int v = byte_at(words[u], c);
              hi[c] = (float)(v >> 4);         // arithmetic shift: two's complement
              lo[c] = (float)((v & 0xF) - 8);  // biased low nibble
            }
#pragma unroll
            for (int q = 0; q < R / 4; ++q) {
              const float4 xl = xa[q];
              const float4 xh = xb[q];
#pragma unroll
              for (int c = 0; c < kCols; ++c) {
                acc[4 * q + 0][c] = fmaf(xh.x, hi[c], fmaf(xl.x, lo[c], acc[4 * q + 0][c]));
                acc[4 * q + 1][c] = fmaf(xh.y, hi[c], fmaf(xl.y, lo[c], acc[4 * q + 1][c]));
                acc[4 * q + 2][c] = fmaf(xh.z, hi[c], fmaf(xl.z, lo[c], acc[4 * q + 2][c]));
                acc[4 * q + 3][c] = fmaf(xh.w, hi[c], fmaf(xl.w, lo[c], acc[4 * q + 3][c]));
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the 4 lanes of a warp that share a column group: lane = (lane_k % 4) * 8 + cg
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 8);
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
    }
  float* red = smem;  // [warp][row][column of the tile]
  const int warp = tid / 32;
  if (tid % 32 < kColThreads) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[(warp * R + r) * kTileN + cg * kCols + c] = acc[r][c];
  }
  __syncthreads();
  for (int idx = tid; idx < R * kTileN; idx += kThreads) {
    const int r = idx / kTileN;
    const int c = idx % kTileN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * R + r) * kTileN + c];
    const int row = row0 + r;
    const int col = blockIdx.x * kTileN + c;
    if (row < b && col < n) y[(size_t)row * n + col] = __float2bfloat16(s * scale[col]);
  }
}

template <int BITS, int R>
void launch_rows(dim3 grid, bool vec, const void* x, const void* wq, const void* scale, void* y,
                 int b, int k, int n, cudaStream_t stream) {
  if (vec)
    dequant_matmul_kernel<BITS, R, true><<<grid, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)x, (const int8_t*)wq, (const float*)scale, (__nv_bfloat16*)y, b, k, n);
  else
    dequant_matmul_kernel<BITS, R, false><<<grid, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)x, (const int8_t*)wq, (const float*)scale, (__nv_bfloat16*)y, b, k, n);
}

// Row tiles of 4, 8 or 16 rows, the least that holds B up to 16; 16 beyond.
// Returns the launch's cudaGetLastError().
template <int BITS>
int launch(const void* x, const void* wq, const void* scale, void* y, int b, int k, int n,
           void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (BITS == 4 && k % 2 != 0) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  const int rt = b <= 4 ? 4 : (b <= 8 ? 8 : 16);
  const dim3 grid((n + kTileN - 1) / kTileN, (b + rt - 1) / rt);
  const cudaStream_t s = (cudaStream_t)stream;
  if (rt == 4) launch_rows<BITS, 4>(grid, vec, x, wq, scale, y, b, k, n, s);
  else if (rt == 8) launch_rows<BITS, 8>(grid, vec, x, wq, scale, y, b, k, n, s);
  else launch_rows<BITS, 16>(grid, vec, x, wq, scale, y, b, k, n, s);
  return (int)cudaGetLastError();
}

}  // namespace dqmm
