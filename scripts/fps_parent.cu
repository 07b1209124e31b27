// K1's earlier design (one block of up to 256 threads a cloud, two barriers
// and a shuffle reduce a round), kept as it was so that
// scripts/fps_variants.py can time it beside the kernel in
// msr3d_tpu_torch/csrc/fps.cu in one process. The port does not build it.
//
// Furthest-point sampling on Hopper.
//
// Replaces the Pallas TPU kernel msr3d_tpu/ops/pallas/fps.py::_fps_kernel
// (wrapper furthest_point_sample_pallas). Semantics, bit for bit:
//   * column 0 is index 0;
//   * a point with x*x + y*y + z*z <= 1e-3 is padding and never picked;
//   * each round updates the running min squared distance to the last pick
//     and picks the first index of the largest one;
//   * a cloud with no valid point yields all zeros (argmax over all -inf).
//
// What bounds it: not bytes (each cloud is read once, 12 KB at N = 1024)
// and not arithmetic (about ten fp32 operations per point and round), but
// the npoint - 1 dependent rounds, each ending in a block-wide argmax.
// Design: one block per cloud, each thread holds its points and their
// running min distance in registers for the whole loop, so a round touches
// no memory except the reduction slots and the winner's coordinates (an L1
// hit after the first round). The reduction is warp shuffles, then one
// warp over the per-warp winners, ties broken by the lowest index.
//
// The squared distance is ((x-lx)^2 + (y-ly)^2) + (z-lz)^2 in fp32 with
// every operation rounded on its own (__fmul_rn/__fadd_rn: nvcc would
// otherwise contract a*a+b into an FMA, which changes the last bit and
// flips picks against the reference).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxPerThread = 16;  // N <= 4096
constexpr float kPadEps = 1e-3f;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out,
                           int n, int npoint) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
  const float* cloud = xyz + (size_t)b * n * 3;
  int32_t* dst = out + (size_t)b * npoint;

  __shared__ float s_val[kMaxThreads / 32];
  __shared__ int s_idx[kMaxThreads / 32];
  __shared__ int s_best;

  float px[kMaxPerThread], py[kMaxPerThread], pz[kMaxPerThread], md[kMaxPerThread];
  bool valid[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = tid + k * nthreads;
    if (i < n) {
      px[k] = cloud[3 * i + 0];
      py[k] = cloud[3 * i + 1];
      pz[k] = cloud[3 * i + 2];
      valid[k] = sq3(px[k], py[k], pz[k]) > kPadEps;
    } else {
      px[k] = py[k] = pz[k] = 0.f;
      valid[k] = false;
    }
    md[k] = 1e10f;
  }
  if (tid == 0) dst[0] = 0;

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = cloud[3 * last + 0];
    const float ly = cloud[3 * last + 1];
    const float lz = cloud[3 * last + 2];
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int i = tid + k * nthreads;
      if (i < n) {
        const float d = sq3(__fsub_rn(px[k], lx), __fsub_rn(py[k], ly), __fsub_rn(pz[k], lz));
        md[k] = fminf(md[k], d);
        const float c = valid[k] ? md[k] : -CUDART_INF_F;
        if (better(c, i, bv, bi)) { bv = c; bi = i; }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { s_val[warp] = bv; s_idx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? s_val[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? s_idx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) { s_best = bi; dst[j] = bi; }
    }
    __syncthreads();
    last = s_best;
  }
}

}  // namespace

// xyz (b, n, 3) fp32 contiguous -> out (b, npoint) int32. Returns the
// launch's cudaGetLastError().
extern "C" int fps_launch(const void* xyz, void* out, int b, int n, int npoint,
                          void* stream) {
  if (b <= 0 || npoint <= 0) return 0;
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (n > kMaxThreads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  fps_kernel<<<b, threads, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (int32_t*)out, n, npoint);
  return (int)cudaGetLastError();
}
