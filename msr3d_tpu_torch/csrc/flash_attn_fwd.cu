// Flash-attention forward on Hopper (kernel K2f): causal GQA attention with a
// key-valid mask and an online softmax.
//
// Replaces the Pallas TPU kernel msr3d_tpu/ops/flash_attention.py::_fwd_kernel
// (wrapper flash_attention -> _flash / _fwd_call). Same contract:
//   * scores s = (q . k) * scale in fp32 from the 16-bit inputs, masked by
//     causal (col <= row, both counted from 0) AND key_valid AND in range;
//     masked probabilities are exactly 0;
//   * online softmax with a running max m and sum l per row (l sums the fp32
//     probabilities); p is rounded to the value dtype before p . v, which
//     accumulates in fp32 (the TPU kernel's own rounding);
//   * o = acc / l, or 0 where l == 0 (a row with no valid key);
//     lse = m + log(l) in natural log, or 0 where l == 0.
// Layouts are the model's own: q/o (B, T, Hq, D), k/v (B, S, Hkv, D), key_valid
// (B, S) bytes, lse (B, Hq, T) fp32. The kv head of q head h is h / (Hq / Hkv).
//
// What bounds it on this card: at the prefill shape (B 4, T = S = 225, 32
// heads, D 128, bf16) the bytes (q, k, v, o read or written once: ~29.5 MB,
// ~8.8 us at 3.35 TB/s) outweigh the causal matmul work (~3.4 GFLOP, ~3.5 us
// at 989 TFLOP/s).
//
// Design:
//   * One block of 4 warps per (q head, batch, 64-row query tile); each warp
//     owns 16 query rows. The grid has the tile slowest and the last query
//     tile (the most key tiles) first, so the heavy blocks are not the tail.
//   * The Q tile is copied once with cp.async and each warp keeps its 16 x D
//     of Q as mma A fragments in registers for the whole key loop (32
//     registers at D 128); its shared rows are reused to stage the output.
//   * K and V tiles of 64 keys stream through a kStages-deep cp.async ring
//     (zero-filled past S) with the tile's key_valid flags beside them as a
//     64-bit mask (one ballot per 32 keys); tile j + 1 is in flight while
//     tile j is multiplied, one barrier a tile. Key tiles above the causal
//     diagonal are never loaded, and inside the diagonal tile a warp skips
//     the 16-key column blocks that lie wholly above its rows.
//   * Both products run on the tensor cores as mma.sync.m16n8k16 (mma.cuh)
//     with fp32 accumulators in registers: s = q.k^T as a 16 x 64 fragment
//     per warp (B fragments by ldmatrix), and o += p.v with p packed from the
//     score registers straight into A fragments (two neighbouring
//     accumulator tiles are one A fragment) and V by ldmatrix.trans. Scores,
//     probabilities and the 16 x D output accumulator (64 registers at D 128)
//     never leave the registers.
//   * The mask is applied only in tiles where it can bite (the diagonal, a
//     tile with an invalid key, the ragged last tile): a masked score becomes
//     -inf, so its probability is ex2(-inf) = +0 exactly (PTX ISA), whatever
//     the running max; a row whose keys so far are all masked keeps m at
//     -1e30 and l at 0, and alpha = 1 leaves its zeros as they are.
//   * The softmax works in base 2 with scale * log2(e) folded into one FFMA
//     before ex2.approx; m and l live in registers, two rows a thread. A
//     row's max takes the thread's 16 scores and two __shfl_xor over the
//     four lanes that share the row; l is kept per lane and summed once at
//     the end.
//   * Shared memory at D 128: the Q tile plus 2 stages of K and V, 64 x (128
//     + 8) 16-bit elements each (the padding keeps ldmatrix free of bank
//     conflicts), and 16 bytes of masks: 87,056 bytes, so two blocks share an
//     SM (flash_attn_fwd_blocks_per_sm).
//   * Chosen: 64 query rows and 4 warps a block, 2 stages, __launch_bounds__
//     (128, 2). nvcc 12.8 -Xptxas -v reports 216 registers a thread at D 128
//     and 145 at D 64 (bf16 and fp16 alike), 0 bytes of spill stores and
//     loads, 1 barrier; 87,056 / 46,096 bytes of shared memory at D 128 / 64.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3 and
// scripts/flash_fwd_variants.py; the kernel's device time at the prefill
// shape): 0.0216 ms L2-warm and 0.0228 ms with its operands read from HBM,
// 2.4x and 2.6x the byte bound; cuDNN's SDPA forward 0.037 / 0.038 ms. The
// design before this one (WMMA, scores, probabilities and the fp32
// accumulator through shared memory, synchronous loads) took 0.114 / 0.122
// ms. Variants: a three-stage ring leaves one block an SM and took 0.033 ms;
// 128 query rows and 8 warps a block (one block an SM) 0.020 ms here and
// level at T = 256; the mask in every tile 0.022 ms (PERF.md, 6).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;         // each owns 16 query rows
constexpr int kStages = 2;        // K/V tiles in the cp.async ring
constexpr int kMinBlocks = 2;     // blocks an SM, for __launch_bounds__
constexpr int kBM = 16 * kWarps;  // query rows per block
constexpr int kBN = 64;           // keys per tile
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the running max before any valid key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // row length of a 16-bit tile, in elements
  static constexpr int kv_elems = kBN * LD;
  static constexpr size_t ring_off = sizeof(uint16_t) * kBM * LD;  // after the Q tile
  static constexpr size_t mask_off = ring_off + sizeof(uint16_t) * kStages * 2 * kv_elems;
  static constexpr size_t bytes = mask_off + sizeof(uint32_t) * 2 * kStages;
};

// Starts the copy of rows [row0, row0 + ROWS) of one head of a (.., rows, H, D)
// tensor into a shared tile, 16 bytes a cp.async, zero-filling rows at or
// past n_rows.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, int row0, int n_rows,
                                                size_t row_stride, int tid) {
  constexpr int kVecPerRow = D / 8;
  static_assert(ROWS * kVecPerRow % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < ROWS * kVecPerRow / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    const bool ok = row0 + r < n_rows;
    mma::cp_async_16(dst + r * Layout<D>::LD + c,
                     src + (size_t)(ok ? row0 + r : 0) * row_stride + c, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ key_valid, T* __restrict__ o,
                 float* __restrict__ lse, int t_len, int s_len, int hq, int hkv,
                 float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int NT = kBN / 8;  // 16 x 8 score tiles of a warp
  constexpr int ND = D / 8;    // 16 x 8 output tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L::ring_off);  // stage s: k at 2s tiles, v at 2s + 1
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L::mask_off);  // stage s: 2 words

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // the last tile has the most key tiles
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_base = warp * 16;

  const size_t q_stride = (size_t)hq * D, k_stride = (size_t)hkv * D;
  const T* q_head = q + ((size_t)b * t_len * hq + h) * D;
  const T* k_head = k + ((size_t)b * s_len * hkv + hk) * D;
  const T* v_head = v + ((size_t)b * s_len * hkv + hk) * D;
  const uint8_t* valid_row = key_valid + (size_t)b * s_len;

  // keys needed by this tile: with causality only cols <= the last row
  const int k_end = min(s_len, min(t_len, q0 + kBM));
  const int n_tiles = (k_end + kBN - 1) / kBN;

  auto load_kv = [&](int kt) {  // starts the copy of key tile kt into its stage
    T* dst = ring + (kt % kStages) * 2 * L::kv_elems;
    load_rows_async<T, D, kBN>(dst, k_head, kt * kBN, s_len, k_stride, tid);
    load_rows_async<T, D, kBN>(dst + L::kv_elems, v_head, kt * kBN, s_len, k_stride, tid);
  };
  auto key_flag = [&](int kt) {  // thread tid < 64: is key tid of tile kt valid and in range
    const int key = kt * kBN + tid;
    return tid < kBN && key < s_len && valid_row[key] != 0;
  };
  auto store_mask = [&](int kt, bool flag) {  // warps 0 and 1 hold keys 0-31 and 32-63
    if (warp < 2) {
      const uint32_t bits = __ballot_sync(0xffffffffu, flag);
      if (lane == 0) masks[(kt % kStages) * 2 + warp] = bits;
    }
  };

  load_rows_async<T, D, kBM>(qs, q_head, q0, t_len, q_stride, tid);
  mma::cp_async_commit();
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < n_tiles) load_kv(kt);
    mma::cp_async_commit();
  }
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt)
    if (kt < n_tiles) store_mask(kt, key_flag(kt));
  mma::cp_async_wait<kStages - 1>();  // the Q tile has landed; K/V may still be in flight
  __syncthreads();

  uint32_t qf[D / 16][4];  // the warp's 16 rows of Q as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma::ldmatrix_x4(qf[kk], mma::addr_a(qs, LD, row_base, kk * 16, lane));

  const int first_row = q0 + row_base;     // the warp's rows: first_row .. + 15
  const bool live = first_row < t_len;     // a warp wholly past T only loads and waits
  const int row_r[2] = {first_row + g, first_row + g + 8};  // the thread's two rows
  const float scale_log2 = scale * kLog2e;
  float m_r[2] = {kNegInf, kNegInf};  // running max of s * scale * log2(e)
  float l_r[2] = {0.f, 0.f};          // this lane's part of the running sum
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed for all; the readers of its stage's last tile are done
    const int kn = kt + kStages - 1;  // the tile to start now, into the stage read at kt - 1
    bool flag_next = false;
    if (kn < n_tiles) {
      load_kv(kn);
      flag_next = key_flag(kn);
    }
    mma::cp_async_commit();

    const int st = kt % kStages;
    const T* ks = ring + st * 2 * L::kv_elems;
    const T* vs = ks + L::kv_elems;
    const int k0 = kt * kBN;
    // columns of this tile at or left of the warp's last row
    const int n_cols = min(kBN, first_row + 16 - k0);
    if (live && n_cols > 0) {
      const uint32_t mask_lo = masks[2 * st], mask_hi = masks[2 * st + 1];

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          if (16 * jp >= n_cols) continue;  // wholly above the warp's rows (warp-uniform)
          uint32_t fb[4];
          mma::ldmatrix_x4(fb, mma::addr_b_nk(ks, LD, 16 * jp, 16 * kk, lane));
          mma::mma_16816(s[2 * jp], qf[kk], fb[0], fb[1], T());
          mma::mma_16816(s[2 * jp + 1], qf[kk], fb[2], fb[3], T());
        }

      // the mask bites on the diagonal, past S and on invalid keys (warp-uniform)
      const bool bite = k0 + kBN - 1 > first_row || (mask_lo & mask_hi) != 0xffffffffu;
      if (bite) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t bits = (j < NT / 2 ? mask_lo : mask_hi) >> ((8 * j) % 32 + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t4 + (e & 1);
            if (!((bits >> (e & 1)) & 1u) || col > row_r[e >> 1]) s[j][e] = -INFINITY;
          }
        }
      }

      // online softmax: the new max, alpha, p = 2^(s * scale * log2 e - m)
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[i], mx * scale_log2);  // -inf * c keeps m_r
        alpha[i] = mma::exp2_approx(m_r[i] - m_new);
        m_r[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = mma::exp2_approx(fmaf(s[j][e], scale_log2, -m_r[e >> 1]));
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = alpha[i] * l_r[i] + sum[i];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // acc += p . v, p rounded to the value dtype straight into A fragments
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        if (16 * kk >= n_cols) continue;  // p is 0 there
        const uint32_t pa[4] = {
            mma::pack2(s[2 * kk][0], s[2 * kk][1], T()),
            mma::pack2(s[2 * kk][2], s[2 * kk][3], T()),
            mma::pack2(s[2 * kk + 1][0], s[2 * kk + 1][1], T()),
            mma::pack2(s[2 * kk + 1][2], s[2 * kk + 1][3], T()),
        };
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t fb[4];
          mma::ldmatrix_x4_trans(fb, mma::addr_b_kn(vs, LD, 16 * kk, 16 * np, lane));
          mma::mma_16816(acc[2 * np], pa, fb[0], fb[1], T());
          mma::mma_16816(acc[2 * np + 1], pa, fb[2], fb[3], T());
        }
      }
    }
    if (kn < n_tiles) store_mask(kn, flag_next);  // its stage's mask was last read at kt - 1
  }
  if (!live) return;

  // epilogue: l over the four lanes of a row, o = acc / l, lse = m ln 2 + log l
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
    if (t4 == 0 && row_r[i] < t_len)
      lse[((size_t)b * hq + h) * t_len + row_r[i]] =
          l_r[i] > 0.f ? m_r[i] * kLn2 + logf(l_r[i]) : 0.f;
  }
  // park the rounded rows in the warp's own rows of the Q tile (read by this
  // warp alone, into registers, before the loop) and store them 16 bytes a thread
  T* rows = qs + row_base * LD;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<uint32_t*>(rows + g * LD + 8 * j + 2 * t4) =
        mma::pack2(acc[j][0] * inv[0], acc[j][1] * inv[0], T());
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * LD + 8 * j + 2 * t4) =
        mma::pack2(acc[j][2] * inv[1], acc[j][3] * inv[1], T());
  }
  __syncwarp();
  constexpr int kVecPerRow = D / 8;
  T* o_head = o + ((size_t)b * t_len * hq + h) * D;
#pragma unroll
  for (int it = 0; it < 16 * kVecPerRow / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    if (first_row + r < t_len)
      *reinterpret_cast<uint4*>(o_head + (size_t)(first_row + r) * q_stride + c) =
          *reinterpret_cast<const uint4*>(rows + r * LD + c);
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // ask for the largest shared-memory carveout, so two blocks fit an SM
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* key_valid, void* o,
           void* lse, int b, int t, int s, int hq, int hkv, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, b, (t + kBM - 1) / kBM);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)key_valid, (T*)o, (float*)lse,
      t, s, hq, hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Returns the launch's cudaGetLastError().
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                                     const void* key_valid, void* o, void* lse, int b, int t,
                                     int s, int hq, int hkv, int d, float scale, int dtype,
                                     void* stream) {
  if (b <= 0 || t <= 0 || s <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, key_valid, o, lse, b, t, s, hq, hkv, scale, st);
  if (dtype == 0 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, key_valid, o, lse, b, t, s, hq, hkv, scale, st);
  if (dtype == 1 && d == 128)
    return launch<__half, 128>(q, k, v, key_valid, o, lse, b, t, s, hq, hkv, scale, st);
  if (dtype == 1 && d == 64)
    return launch<__half, 64>(q, k, v, key_valid, o, lse, b, t, s, hq, hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the D = 128 bf16 kernel that one SM holds at once, by the
// runtime's occupancy calculation; -1 on error.
extern "C" int flash_attn_fwd_blocks_per_sm() {
  int n = 0;
  const size_t smem = Layout<128>::bytes;
  if (prepare(flash_fwd_kernel<__nv_bfloat16, 128>, smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<__nv_bfloat16, 128>,
                                                    kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}
