// The earlier design of kernel K4 (int4 weight-only matrix product), kept
// to time beside the current one: the int4 instance of the CUDA-core kernel
// in dequant_matmul.cuh (one block of 256 threads per 32 output columns,
// fp32 FMAs over nibbles unpacked by integer shifts, x staged in shared
// memory between barriers).

#include "dequant_matmul.cuh"

// x (b, k) bf16, wq (k/2, n) int8 in pack_w4's layout, scale (n,) fp32, y
// (b, n) bf16, all contiguous on the card; k even. Returns the launch's
// cudaGetLastError().
extern "C" int w4_parent_launch(const void* x, const void* wq, const void* scale, void* y, int b,
                                int k, int n, void* stream) {
  return dqmm::launch<4>(x, wq, scale, y, b, k, n, stream);
}
