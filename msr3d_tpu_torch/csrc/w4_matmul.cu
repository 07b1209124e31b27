// Kernel K4: int4 weight-only matrix product on Hopper.
//
// Replaces the Pallas TPU kernel msr3d_tpu/ops/pallas/w4_matmul.py::_kernel
// (wrapper matmul_w4):
//
//   y[b, n] = bf16( (sum_{r < K/2} x[b, r] * lo[r, n] + x[b, r + K/2] * hi[r, n]) * scale[n] )
//
// with x (B, K) bf16, wq (K/2, N) int8 in pack_w4's layout (low nibble: input
// row r biased by +8; high nibble: input row r + K/2, two's complement),
// scale (N,) fp32 per output channel and y (B, N) bf16; fp32 accumulator.
//
// The TPU kernel unpacks with bf16/f32/i16 arithmetic (its vector unit has no
// int8 shifts) and folds the low nibble's +8 bias out as -8 * rowsum(x_lo)
// after the products. Here the unpack is two integer operations per byte
// (an arithmetic shift for the high nibble, a mask minus 8 for the low one),
// so the bias never enters the sum. Its three unpack modes give identical
// results and this one kernel stands for all three.
//
// What bounds it at decode (B = 4..16): the K/2 * N weight bytes, read once,
// and at B = 16 the fp32 products on the CUDA cores (two per byte per row).
// The design is in dequant_matmul.cuh.

#include "dequant_matmul.cuh"

// x (b, k) bf16, wq (k/2, n) int8, scale (n,) fp32, y (b, n) bf16, all
// contiguous on the card; k even. Returns the launch's cudaGetLastError().
extern "C" int w4_matmul_launch(const void* x, const void* wq, const void* scale, void* y, int b,
                                int k, int n, void* stream) {
  return dqmm::launch<4>(x, wq, scale, y, b, k, n, stream);
}
