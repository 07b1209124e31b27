// Kernel K3: int8 weight-only matrix product on Hopper.
//
// Replaces the Pallas TPU kernel msr3d_tpu/ops/pallas/w8_matmul.py::_kernel
// (wrapper matmul_w8):
//
//   y[b, n] = bf16( (sum_k bf16(x[b, k]) * wq[k, n]) * scale[n] ),  fp32 accumulator
//
// with x (B, K) bf16, wq (K, N) int8, scale (N,) fp32 and y (B, N) bf16. The
// TPU kernel's 128-aligned blocks and its padding of B to 16 rows are TPU
// tiling and are gone: any B, K and N are taken.
//
// What bounds it at decode (B = 4..16): the K * N weight bytes, read once.
// The design (one block per 32 output columns and up to 16 rows, vectorised
// weight loads along N, fp32 register accumulators, the scale once on the
// sum) is in dequant_matmul.cuh.

#include "dequant_matmul.cuh"

// x (b, k) bf16, wq (k, n) int8, scale (n,) fp32, y (b, n) bf16, all
// contiguous on the card. Returns the launch's cudaGetLastError().
extern "C" int w8_matmul_launch(const void* x, const void* wq, const void* scale, void* y, int b,
                                int k, int n, void* stream) {
  return dqmm::launch<8>(x, wq, scale, y, b, k, n, stream);
}
