// The earlier design of kernel K3 (int8 weight-only matrix product), kept
// to time beside the current one: the int8 instance of the CUDA-core kernel
// in dequant_matmul.cuh (one block of 256 threads per 32 output columns,
// fp32 FMAs, x staged in shared memory between barriers).

#include "dequant_matmul.cuh"

// x (b, k) bf16, wq (k, n) int8, scale (n,) fp32, y (b, n) bf16, all
// contiguous on the card. Returns the launch's cudaGetLastError().
extern "C" int w8_parent_launch(const void* x, const void* wq, const void* scale, void* y, int b,
                                int k, int n, void* stream) {
  return dqmm::launch<8>(x, wq, scale, y, b, k, n, stream);
}
