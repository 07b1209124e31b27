// Kernel K3: int8 weight-only matrix product on Hopper.
//
// Replaces the Pallas TPU kernel msr3d_tpu/ops/pallas/w8_matmul.py::_kernel
// (wrapper matmul_w8):
//
//   y[b, n] = bf16( (sum_k bf16(x[b, k]) * wq[k, n]) * scale[n] ),  fp32 accumulator
//
// with x (B, K) bf16, wq (K, N) int8 (the flax (in, out) layout, row-major
// along N), scale (N,) fp32 and y (B, N) bf16. The TPU kernel's 128-aligned
// blocks and its padding of B to 16 rows are TPU tiling and are gone: any B,
// K and N are taken.
//
// The kernel is the BITS = 8 instance of wq_matmul.cuh, which holds the
// design (mma.sync over the weight converted to bf16 in registers, a
// warp-private cp.async ring, a split K summed in split order by the last
// block of each column tile) and what bounds it.

#include "wq_matmul.cuh"

// x (b, k) bf16, wq (k, n) int8, scale (n,) fp32, y (b, n) bf16, all
// contiguous on the card; the rest as wqmm::launch. Returns the launch's CUDA
// error, or 0.
extern "C" int w8_matmul_launch(const void* x, const void* wq, const void* scale, void* y,
                                void* ws, void* counters, int b, int k, int n, int split, int tn,
                                int stages, void* stream) {
  return wqmm::launch<8>(x, wq, scale, y, ws, counters, b, k, n, split, tn, stages, stream);
}

// Blocks of the instance (tn, stages) that fit on one SM, for the variants'
// records; 0 for an unknown instance.
extern "C" int w8_matmul_blocks_per_sm(int tn, int stages) {
  return wqmm::blocks_per_sm<8>(tn, stages);
}
