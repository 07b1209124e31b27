// Furthest-point sampling on Hopper.
//
// Replaces the Pallas TPU kernel msr3d_tpu/ops/pallas/fps.py::_fps_kernel
// (wrapper furthest_point_sample_pallas). Semantics, bit for bit:
//   * column 0 is index 0;
//   * a point with x*x + y*y + z*z <= 1e-3 is padding and never picked;
//   * each round updates the running min squared distance (from 1e10, by
//     fminf) to the last pick and picks the first index of the largest one;
//   * a cloud with no valid point yields all zeros (argmax over all -inf).
//
// What bounds it: not bytes (each cloud is read once, 12 KB at N = 1024)
// and not arithmetic (about ten fp32 operations per point and round), but
// the npoint - 1 dependent rounds, each ending in an argmax over the cloud
// whose winner the next round needs. At the scene encode's shapes (60
// clouds a scene; N 1024 -> 32, then 32 -> 16) that is 46 rounds in a row,
// each with a floor set by latency; at 960 clouds the SMs' issue rate
// (about twelve instructions per point and round) adds to it.
// What the design does about it:
//   * Sized to the shape: P points a lane, W warps a cloud (N <= 32 W P).
//     N <= 64 (stage 2) takes one warp a cloud and C clouds a block, so a
//     round has no barrier at all. Larger N take W from the batch: the
//     most warps a cloud (8, 4 or 2) that keep B * W within about 16 warps
//     an SM. Few clouds (240 at batch 4) are bound by a round's latency,
//     which more warps a cloud shorten (fewer points a lane); many clouds
//     (960 at batch 16) by the SMs' issue rate and, at 8 warps, by a second
//     wave, so fewer warps a cloud win there (scripts/fps_variants.py).
//   * One 32-bit key a point, reduced by hardware: a valid point's running
//     min md is >= +0, so its bit pattern orders as a signed int; a padding
//     point keeps md = -1.0f (fminf(-1, d) = -1), a negative int, so it
//     never wins against a valid point, and an all-padding cloud ties
//     everywhere and picks index 0. (The same order as the unsigned key
//     valid ? bits(md) + 1 : 0, without the add and the select a point.)
//     Each lane keeps its best key and the first index holding it; the
//     warp takes __reduce_max_sync of the keys, then __reduce_min_sync of
//     the indices of the lanes holding the maximum: two redux.sync where
//     the earlier design had twenty dependent shuffles.
//   * One barrier a round across a cloud's warps (W > 1, one cloud a
//     block): each warp writes its (key, index) into a slot double-buffered
//     by round parity, one __syncthreads, then every warp reduces the W
//     slots itself with the same two redux.sync. No second barrier, no
//     warp-0 step.
//   * The cloud in shared memory, loaded once, coalesced: the winner's
//     coordinates come from a broadcast shared load, not a global one. The
//     picks are held in registers (lane j % 32 of the cloud's first warp)
//     and stored 32 at a time, each cloud's npoint int32s written once.
//
// The squared distance is ((x-lx)^2 + (y-ly)^2) + (z-lz)^2 in fp32 with
// every operation rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn: nvcc
// would otherwise contract a*a+b into an FMA, which changes the last bit and
// flips picks against the reference).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPoints = 4096;
constexpr int kMaxPerLane = 32;
constexpr int kSmallN = 64;  // N up to this many points: one warp a cloud
// What fps_launch takes: for N > kSmallN, the most warps a cloud (8, 4 or
// 2) with B * W <= kWarpsInFlight, about 16 warps on each of the H100's 132
// SMs; for N <= kSmallN, kCloudsPerBlock clouds a block.
// scripts/fps_variants.py times the others through fps_launch_config.
constexpr int kWarpsInFlight = 2048;
constexpr int kCloudsPerBlock = 4;
constexpr float kPadEps = 1e-3f;
constexpr float kFar = 1e10f;  // the running min of a valid point before round 1
constexpr float kPadMin = -1.0f;  // the running min of padding, for good
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// P points a lane, W warps a cloud, C clouds a block (C > 1 only with W = 1:
// such a block has no block-wide barrier, each warp works on its own).
template <int P, int W, int C>
__global__ void __launch_bounds__(32 * W * C)
fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int b, int n,
           int npoint) {
  static_assert(W == 1 || C == 1, "several clouds a block only with one warp a cloud");
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int cw = W == 1 ? 0 : threadIdx.x >> 5;  // warp within its cloud
  const int cb = W == 1 ? threadIdx.x >> 5 : 0;  // cloud within the block
  const int cloud = blockIdx.x * C + cb;
  if (cloud >= b) return;  // only a warp of the last block, with W = 1
  const int t = cw * 32 + lane;  // thread within its cloud
  float* s_xyz = smem + cb * 3 * n;
  int* s_key = reinterpret_cast<int*>(smem + C * 3 * n);  // [2][W], W > 1
  unsigned* s_idx = reinterpret_cast<unsigned*>(s_key + 2 * W);

  const float* g = xyz + (size_t)cloud * n * 3;
#pragma unroll 4
  for (int e = t; e < 3 * n; e += 32 * W) s_xyz[e] = __ldg(g + e);
  if (W > 1) __syncthreads(); else __syncwarp();

  float px[P], py[P], pz[P], md[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = t + k * 32 * W;
    if (i < n) {
      px[k] = s_xyz[3 * i + 0];
      py[k] = s_xyz[3 * i + 1];
      pz[k] = s_xyz[3 * i + 2];
      md[k] = sq3(px[k], py[k], pz[k]) > kPadEps ? kFar : kPadMin;
    } else {  // past the cloud: padding at the origin, with an index past n
      px[k] = py[k] = pz[k] = 0.f;
      md[k] = kPadMin;
    }
  }

  int32_t* dst = out + (size_t)cloud * npoint;
  unsigned held = 0;  // lane l holds the pick of round 32 * (j / 32) + l
  unsigned last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = s_xyz[3 * last + 0];
    const float ly = s_xyz[3 * last + 1];
    const float lz = s_xyz[3 * last + 2];
    int best_key = 0;
    unsigned best_idx = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float d = sq3(__fsub_rn(px[k], lx), __fsub_rn(py[k], ly), __fsub_rn(pz[k], lz));
      md[k] = fminf(md[k], d);
      const int key = __float_as_int(md[k]);
      if (k == 0 || key > best_key) {  // strict: the lane's first index of its max
        best_key = key;
        best_idx = (unsigned)(t + k * 32 * W);
      }
    }
    int key = __reduce_max_sync(kFull, best_key);
    unsigned idx = __reduce_min_sync(kFull, best_key == key ? best_idx : kFull);
    if constexpr (W > 1) {
      const int slot = (j & 1) * W;
      if (lane == 0) {
        s_key[slot + cw] = key;
        s_idx[slot + cw] = idx;
      }
      __syncthreads();
      const int wkey = s_key[slot + (lane & (W - 1))];
      const unsigned widx = s_idx[slot + (lane & (W - 1))];
      key = __reduce_max_sync(kFull, wkey);
      idx = __reduce_min_sync(kFull, wkey == key ? widx : kFull);
    }
    last = idx;
    if (lane == (j & 31)) held = idx;
    if ((j & 31) == 31 && cw == 0) dst[j - 31 + lane] = (int32_t)held;
  }
  if (cw == 0 && lane < (npoint & 31)) dst[(npoint & ~31) + lane] = (int32_t)held;
}

struct Args {
  const float* xyz;
  int32_t* out;
  int b, n, npoint;
  cudaStream_t stream;
};

template <int P, int W, int C>
int launch(const Args& a) {
  const size_t smem = (size_t)C * 3 * a.n * sizeof(float) + (W > 1 ? 4 * W * sizeof(int) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<P, W, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fps_kernel<P, W, C><<<(a.b + C - 1) / C, 32 * W * C, smem, a.stream>>>(
      a.xyz, a.out, a.b, a.n, a.npoint);
  return (int)cudaGetLastError();
}

// One instance for each power of two P up to what N <= kMaxPoints needs at
// W warps (and at most kMaxPerLane).
template <int W, int P = 1>
int launch_per_lane(int per_lane, const Args& a) {
  if (per_lane == P) return launch<P, W, 1>(a);
  if constexpr (P < kMaxPerLane && 32 * W * P < kMaxPoints) {
    return launch_per_lane<W, 2 * P>(per_lane, a);
  }
  return (int)cudaErrorInvalidValue;
}

template <int C>
int launch_small(int per_lane, const Args& a) {
  return per_lane == 1 ? launch<1, 1, C>(a) : launch<2, 1, C>(a);
}

}  // namespace

// xyz (b, n, 3) fp32 contiguous -> out (b, npoint) int32, with `warps`
// warps a cloud (1, 2, 4 or 8; raised while a lane would hold more than 32
// points) and, with one warp a cloud and n <= 64, `clouds_per_block` clouds
// a block (1, 2, 4 or 8). Returns the launch's cudaGetLastError().
extern "C" int fps_launch_config(const void* xyz, void* out, int b, int n, int npoint,
                                 int warps, int clouds_per_block, void* stream) {
  if (b <= 0 || npoint <= 0) return 0;
  if (n <= 0 || n > kMaxPoints) return (int)cudaErrorInvalidValue;
  if (warps != 1 && warps != 2 && warps != 4 && warps != 8) return (int)cudaErrorInvalidValue;
  while (warps < 8 && (n + 32 * warps - 1) / (32 * warps) > kMaxPerLane) warps *= 2;
  int per_lane = 1;
  while (per_lane * 32 * warps < n) per_lane *= 2;
  const Args a{(const float*)xyz, (int32_t*)out, b, n, npoint, (cudaStream_t)stream};
  if (warps == 1 && n <= kSmallN) {
    switch (clouds_per_block) {
      case 1: return launch_small<1>(per_lane, a);
      case 2: return launch_small<2>(per_lane, a);
      case 4: return launch_small<4>(per_lane, a);
      case 8: return launch_small<8>(per_lane, a);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (warps) {
    case 1: return launch_per_lane<1>(per_lane, a);
    case 2: return launch_per_lane<2>(per_lane, a);
    case 4: return launch_per_lane<4>(per_lane, a);
    case 8: return launch_per_lane<8>(per_lane, a);
  }
  return (int)cudaErrorInvalidValue;
}

// xyz (b, n, 3) fp32 contiguous -> out (b, npoint) int32, in the kernel's
// own choice: one warp a cloud and kCloudsPerBlock clouds a block for
// n <= 64; above, 8, 4 or 2 warps a cloud, the most with b * warps <=
// kWarpsInFlight (8 at 240 clouds, 2 at 960). Returns the launch's
// cudaGetLastError().
extern "C" int fps_launch(const void* xyz, void* out, int b, int n, int npoint,
                          void* stream) {
  int warps = 1;
  if (n > kSmallN) {
    warps = 8;
    while (warps > 2 && (long long)b * warps > kWarpsInFlight) warps /= 2;
  }
  return fps_launch_config(xyz, out, b, n, npoint, warps, kCloudsPerBlock, stream);
}
