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
// after the products. Here each nibble is converted to its signed value in
// bf16 in registers (a byte permute, a mask ORed into bf16 128.0, one bf16x2
// FMA that subtracts 136), so the bias never enters the sum. The TPU kernel's
// three unpack modes give identical results and this one kernel stands for
// all three.
//
// The kernel is the BITS = 4 instance of wq_matmul.cuh, which holds the
// design (mma.sync, two products a packed k16 step, a warp-private cp.async
// ring carrying the weight and both slices of x, a split K summed in split
// order by the last block of each column tile) and what bounds it. The
// function is bound by its K/2 * N weight bytes.

#include "wq_matmul.cuh"

// x (b, k) bf16, wq (k/2, n) int8, scale (n,) fp32, y (b, n) bf16, all
// contiguous on the card; k even; the rest as wqmm::launch, whose k is the
// weight's k/2 rows. Returns the launch's CUDA error, or 0.
extern "C" int w4_matmul_launch(const void* x, const void* wq, const void* scale, void* y,
                                void* ws, void* counters, int b, int k, int n, int split, int tn,
                                int stages, void* stream) {
  if (k % 2 != 0) return (int)cudaErrorInvalidValue;
  return wqmm::launch<4>(x, wq, scale, y, ws, counters, b, k / 2, n, split, tn, stages, stream);
}

// Blocks of the instance (tn, stages) that fit on one SM, for the variants'
// records; 0 for an unknown instance.
extern "C" int w4_matmul_blocks_per_sm(int tn, int stages) {
  return wqmm::blocks_per_sm<4>(tn, stages);
}
