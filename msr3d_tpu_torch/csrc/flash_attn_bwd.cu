// Flash-attention backward on Hopper: the FlashAttention-2 recomputation of
// dq (kernel K2dq) and of per-q-head dk/dv (kernel K2dkv) from the saved lse.
//
// Replaces the Pallas TPU kernels msr3d_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (custom-vjp backward _flash_bwd). Same
// contract:
//   * s = (q . k) * scale in fp32, scale 1/sqrt(D); mask = causal by absolute
//     row and column (col <= row) AND key_valid AND in range;
//   * p = exp(where(mask, s, -1e30) - lse) * mask, recomputed from the forward's
//     lse (a row with no valid key has lse 0, so its p is exactly 0);
//   * dp = do . v^T, ds = p * (dp - delta) * scale, with delta = rowsum(do * o)
//     computed outside (fp32, as the TPU path computes it in XLA);
//   * dq = ds . k, accumulated in fp32 over the key tiles up to the diagonal;
//   * dv = p^T . do and dk = ds^T . q, per q head, accumulated in fp32 over the
//     query tiles from the diagonal down; the GQA group-sum happens outside;
//   * outputs in the input dtype. A query row with no valid key gives dq
//     exactly 0, an invalid key (or one no query reaches) dk = dv = 0 exactly.
// Layouts are the model's own: q/do (B, T, Hq, D), k/v (B, S, Hkv, D),
// key_valid (B, S) bytes, lse/delta (B, Hq, T) fp32; dq (B, T, Hq, D), dk/dv
// per q head (B, S, Hq, D). The kv head of q head h is h / (Hq / Hkv).
//
// What bounds it on this card: at the training shape (B 4, T = S = 256, 32
// heads, D 128, bf16) there are ~3.7 M unmasked (row, key) pairs over all
// heads. K2dq moves ~42 MB (q, k, v, do read, dq written: ~12.6 us at 3.35
// TB/s) for 3 products of 2D flops a pair (~3 us at 989 TFLOP/s); K2dkv
// moves ~50 MB (~15.1 us) for 4 products. The bytes bound both functions.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 5; the
// kernel's own device time at that shape): K2dq 0.030 ms with its operands
// read from HBM and 0.028 ms L2-warm, K2dkv 0.038 ms either way, 2.3x and 2.5x
// the byte bounds; cuDNN's fused backward takes 0.084 ms for the work of both.
// The design before this one (fp32 products on the CUDA cores, scores through
// shared memory, one block an SM) took 0.177 and 0.306 ms. What holds it off
// the bound now is mma.sync throughput, the element-wise work between products
// and the launch's first wave of loads and its tail, not HBM (PERF.md, 6).
//
// Design:
//   * All five products run on the tensor cores as mma.sync.m16n8k16 (mma.cuh),
//     with fp32 accumulators in registers. A block is 4 warps and owns one
//     64-row tile: 64 query rows in K2dq, 64 keys in K2dkv; each warp owns 16
//     of them and keeps their dq (or dk and dv) in registers over the whole
//     loop, rounds them once and writes them once.
//   * The scores never leave the registers. K2dq computes s = q.k^T and dp =
//     do.v^T as 16 x 8 accumulator tiles; K2dkv computes the transposes s^T =
//     k.q^T and dp^T = v.do^T. Two neighbouring accumulator tiles have the
//     layout of one A fragment, so p and ds feed ds.k (K2dq) and p^T.do,
//     ds^T.q (K2dkv) straight from registers. Masks come from the thread's
//     own (row, column) in the fragment.
//   * The fp32 contract of p and ds: the TPU kernels multiply p and ds in
//     fp32. Here each is split in registers into hi = round16(x) and lo =
//     round16(x - hi) and both parts are multiplied into the same
//     accumulator. The other operand (k, do, q) is 16-bit, so every term is
//     exact in fp32 and the split leaves ~2^-17 relative a term (bf16; in
//     fp16 2^-22, and a lo part under fp16's 2^-24 is dropped: an absolute
//     2^-25 a term, far under the outputs' own rounding).
//   * The other side is streamed through a two-stage cp.async ring: K2dq
//     keeps its q and do tile resident and streams k/v tiles up to the
//     diagonal; K2dkv keeps k and v resident and streams q/do tiles with
//     their lse and delta from the diagonal down. Tile n + 1 is in flight
//     while tile n is multiplied; one barrier a tile. Rows past T or S are
//     zero-filled by the copy (src-size 0).
//   * Shared memory at D 128: 2 resident + 2 x 2 streamed 16-bit tiles of
//     64 x (128 + 8) (the padding keeps ldmatrix free of bank conflicts) plus
//     1 KB of row data = 105,472 bytes, so two blocks share an SM (8 warps).
//   * The grid is (q head, batch, tile) with the tile slowest and the tiles
//     with the most steps first (the last query tile in K2dq, the first key
//     tile in K2dkv), so the heavy blocks are not the tail.
//   * A warp works on the 64-wide score tile in chunks of kChunkDq / kChunkDkv
//     columns (s, p, dp, ds of one chunk live at a time), which bounds the
//     registers, and skips a chunk that lies wholly above the causal diagonal.
//   * Chosen: 64 x 64 tiles, 4 warps a block, 2 stages, __launch_bounds__(128,
//     2). nvcc 12.8 -Xptxas -v reports, for <type, D>, registers a thread and
//     dynamic shared memory a block, each with 0 bytes of spill stores and
//     loads and 1 barrier:
//       K2dq  <bf16, 128> 242   <fp16, 128> 246   <bf16, 64> 206   <fp16, 64> 201
//       K2dkv <bf16, 128> 246   <fp16, 128> 244   <bf16, 64> 158   <fp16, 64> 156
//       shared memory: 105,472 bytes at D 128, 56,320 bytes at D 64

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// Columns of the 64-wide score tile that a warp holds at a time (s, p, dp, ds
// as fp32 fragments), a multiple of 16. On the H100 chunks of 16, 32 and 64
// ran within a few percent of each other for both kernels (PERF.md, section
// 6). K2dq takes the whole tile, so it loads its q and do fragments once a
// tile; K2dkv keeps two 16 x D accumulators, and at D 128 only the chunk of
// 16 leaves ptxas without spills under the 255 registers that two blocks an
// SM allow.
constexpr int kChunkDq = 64;
constexpr int kChunkDkv = 16;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // row length of a 16-bit tile, in elements
  static constexpr int tile_elems = kTile * LD;
  static constexpr size_t tile_bytes = sizeof(uint16_t) * tile_elems;
  // two resident tiles, two stages of two streamed tiles, then per stage
  // 2 x 64 words of row data (K2dq: key flags; K2dkv: lse and delta)
  static constexpr size_t rows_off = 6 * tile_bytes;
  static constexpr size_t bytes = rows_off + 2 * 2 * kTile * sizeof(float);
};

// Starts the copy of rows [row0, row0 + 64) of one head of a (.., rows, H, D)
// tensor into a shared tile, 16 bytes a cp.async, zero-filling rows at or
// past n_rows.
template <typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int row0, int n_rows,
                                                size_t row_stride, int tid) {
  constexpr int kVecPerRow = D / 8;
#pragma unroll
  for (int it = 0; it < kTile * kVecPerRow / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    const bool ok = row0 + r < n_rows;
    mma::cp_async_16(dst + r * Layout<D>::LD + c,
                     src + (size_t)(ok ? row0 + r : 0) * row_stride + c, ok);
  }
}

// acc (16 x 8 tiles over NT * 8 columns) = A rows [row0, +16) of `a` times
// the transpose of rows [n0, n0 + NT * 8) of `b`, both D deep.
template <typename T, int D, int NT>
__device__ __forceinline__ void warp_abt(float (&acc)[NT][4], const T* a, int row0, const T* b,
                                         int n0, int lane) {
  constexpr int LD = Layout<D>::LD;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    mma::ldmatrix_x4(fa, mma::addr_a(a, LD, row0, kk * 16, lane));
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t fb[4];
      mma::ldmatrix_x4(fb, mma::addr_b_nk(b, LD, n0 + jp * 16, kk * 16, lane));
      mma::mma_16816(acc[2 * jp], fa, fb[0], fb[1], T());
      mma::mma_16816(acc[2 * jp + 1], fa, fb[2], fb[3], T());
    }
  }
}

// acc (16 x D) += X (16 x NT * 8, fp32 accumulator tiles, taken as hi + lo
// 16-bit parts) times rows [k0, k0 + NT * 8) of `b` (D wide).
template <typename T, int D, int NT>
__device__ __forceinline__ void warp_acc_xb(float (&acc)[D / 8][4], const float (&x)[NT][4],
                                            const T* b, int k0, int lane) {
  constexpr int LD = Layout<D>::LD;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[4], lo[4];
    mma::pack_a_from_c<T>(hi, lo, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t fb[4];
      mma::ldmatrix_x4_trans(fb, mma::addr_b_kn(b, LD, k0 + kk * 16, np * 16, lane));
      mma::mma_16816(acc[2 * np], hi, fb[0], fb[1], T());
      mma::mma_16816(acc[2 * np + 1], hi, fb[2], fb[3], T());
      mma::mma_16816(acc[2 * np], lo, fb[0], fb[1], T());
      mma::mma_16816(acc[2 * np + 1], lo, fb[2], fb[3], T());
    }
  }
}

// Rounds the warp's 16 x D accumulator once, parks it in the warp's own 16
// rows of a shared tile and writes the rows below n_rows to `out` (row stride
// in elements), 16 bytes a thread.
template <typename T, int D>
__device__ __forceinline__ void warp_store(const float (&acc)[D / 8][4], T* tile_rows, T* out,
                                           size_t row_stride, int first_row, int n_rows,
                                           int lane) {
  constexpr int LD = Layout<D>::LD;
  const int g = lane >> 2, t4 = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile_rows + g * LD + 8 * j + 2 * t4) =
        mma::pack2(acc[j][0], acc[j][1], T());
    *reinterpret_cast<uint32_t*>(tile_rows + (g + 8) * LD + 8 * j + 2 * t4) =
        mma::pack2(acc[j][2], acc[j][3], T());
  }
  __syncwarp();
  constexpr int kVecPerRow = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * kVecPerRow / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    if (first_row + r < n_rows)
      *reinterpret_cast<uint4*>(out + (size_t)(first_row + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(tile_rows + r * LD + c);
  }
}

// K2dq: one block per (q head, batch, query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t_len, int s_len, int hq, int hkv, float scale) {
  using L = Layout<D>;
  constexpr int CH = kChunkDq;  // keys of the score tile live at a time
  constexpr int NT = CH / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + L::tile_elems;
  T* kv_ring = dos + L::tile_elems;  // stage s: k at s * 2 tiles, then v
  int* flags = reinterpret_cast<int*>(smem + L::rows_off);  // stage s: 64 key flags at s * 64

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // the last tile has the most steps
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_base = warp * 16;

  const size_t q_stride = (size_t)hq * D, k_stride = (size_t)hkv * D;
  const T* q_head = q + ((size_t)b * t_len * hq + h) * D;
  const T* do_head = dout + ((size_t)b * t_len * hq + h) * D;
  const T* k_head = k + ((size_t)b * s_len * hkv + hk) * D;
  const T* v_head = v + ((size_t)b * s_len * hkv + hk) * D;
  const float* lse_row = lse + ((size_t)b * hq + h) * t_len;
  const float* delta_row = delta + ((size_t)b * hq + h) * t_len;
  const uint8_t* valid_row = key_valid + (size_t)b * s_len;

  load_tile_async<T, D>(qs, q_head, q0, t_len, q_stride, tid);
  load_tile_async<T, D>(dos, do_head, q0, t_len, q_stride, tid);
  load_tile_async<T, D>(kv_ring, k_head, 0, s_len, k_stride, tid);
  load_tile_async<T, D>(kv_ring + L::tile_elems, v_head, 0, s_len, k_stride, tid);
  mma::cp_async_commit();
  if (tid < kTile) flags[tid] = (tid < s_len) && valid_row[tid];

  // the thread's two rows, g and g + 8 of the warp's 16; a row past T gets
  // -1, below every column, so the causal test masks it. lse in log2 units
  int row_r[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_base + g + 8 * i;
    const bool in = row < t_len;
    row_r[i] = in ? row : -1;
    lse_r[i] = in ? lse_row[row] * kLog2e : 0.f;
    delta_r[i] = in ? delta_row[row] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // keys needed by this tile: with causality only cols <= the last row
  const int k_end = min(s_len, min(t_len, q0 + kTile));
  const int n_tiles = (k_end + kTile - 1) / kTile;

  for (int kt = 0; kt < n_tiles; ++kt) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt has landed for all; tile kt - 1's readers are done
    const int st = kt & 1;
    const bool more = kt + 1 < n_tiles;
    int flag_next = 0;
    if (more) {
      const int k0n = (kt + 1) * kTile;
      T* dst = kv_ring + (st ^ 1) * 2 * L::tile_elems;
      load_tile_async<T, D>(dst, k_head, k0n, s_len, k_stride, tid);
      load_tile_async<T, D>(dst + L::tile_elems, v_head, k0n, s_len, k_stride, tid);
      mma::cp_async_commit();
      if (tid < kTile) flag_next = (k0n + tid < s_len) && valid_row[k0n + tid];
    }
    const T* ks = kv_ring + st * 2 * L::tile_elems;
    const T* vs = ks + L::tile_elems;
    const int* flag = flags + st * kTile;
    const int k0 = kt * kTile;

#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += CH) {
      if (k0 + c0 > q0 + row_base + 15) continue;  // wholly above the diagonal (warp-uniform)
      float s[NT][4], dp[NT][4];
      warp_abt<T, D, NT>(s, qs, row_base, ks, c0, lane);
      warp_abt<T, D, NT>(dp, dos, row_base, vs, c0, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int2 f = *reinterpret_cast<const int2*>(flag + c0 + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = k0 + c0 + 8 * j + 2 * t4 + (e & 1);
          const bool ok = ((e & 1) ? f.y : f.x) && col <= row_r[i];
          const float p = ok ? mma::exp2_approx(s[j][e] * scale_log2 - lse_r[i]) : 0.f;
          dp[j][e] = p * (dp[j][e] - delta_r[i]) * scale;  // ds
        }
      }
      warp_acc_xb<T, D, NT>(acc, dp, ks, c0, lane);
    }
    // the other stage's flags were last read in tile kt - 1
    if (more && tid < kTile) flags[(st ^ 1) * kTile + tid] = flag_next;
  }

  // the warp's rows of qs are read by this warp alone
  warp_store<T, D>(acc, qs + row_base * L::LD, dq + ((size_t)b * t_len * hq + h) * D, q_stride,
                   q0 + row_base, t_len, lane);
}

// K2dkv: one block per (q head, batch, key tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len, int hq,
                     int hkv, float scale) {
  using L = Layout<D>;
  constexpr int CH = kChunkDkv;  // query rows of the score tile live at a time
  constexpr int NT = CH / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + L::tile_elems;
  T* q_ring = vs + L::tile_elems;  // stage s: q at s * 2 tiles, then do
  float* rows = reinterpret_cast<float*>(smem + L::rows_off);  // stage s: lse, delta at s * 128

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // the first key tile has the most steps
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int key_base = warp * 16;

  const size_t q_stride = (size_t)hq * D, k_stride = (size_t)hkv * D;
  T* dk_head = dk + ((size_t)b * s_len * hq + h) * D;
  T* dv_head = dv + ((size_t)b * s_len * hq + h) * D;

  // query rows that see this tile: with causality only rows >= its first key
  const int n_qtiles = (t_len + kTile - 1) / kTile;
  const int qt0 = k0 / kTile;
  if (qt0 >= n_qtiles) {  // no query reaches these keys
    constexpr int kVecPerRow = D / 8;
    for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
      const int key = k0 + i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      if (key < s_len) {
        *reinterpret_cast<uint4*>(dk_head + (size_t)key * q_stride + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv_head + (size_t)key * q_stride + c) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  const T* q_head = q + ((size_t)b * t_len * hq + h) * D;
  const T* do_head = dout + ((size_t)b * t_len * hq + h) * D;
  const T* k_head = k + ((size_t)b * s_len * hkv + hk) * D;
  const T* v_head = v + ((size_t)b * s_len * hkv + hk) * D;
  const float* lse_row = lse + ((size_t)b * hq + h) * t_len;
  const float* delta_row = delta + ((size_t)b * hq + h) * t_len;
  const uint8_t* valid_row = key_valid + (size_t)b * s_len;

  // starts the copy of query tile qt (q, do, lse, delta) into a stage
  auto load_stage = [&](int stage, int qt) {
    T* dst = q_ring + stage * 2 * L::tile_elems;
    const int r0 = qt * kTile;
    load_tile_async<T, D>(dst, q_head, r0, t_len, q_stride, tid);
    load_tile_async<T, D>(dst + L::tile_elems, do_head, r0, t_len, q_stride, tid);
    const int r = r0 + (tid & (kTile - 1));
    const bool ok = r < t_len;
    const float* src = (tid < kTile ? lse_row : delta_row) + (ok ? r : 0);
    mma::cp_async_4(rows + stage * 2 * kTile + tid, src, ok);
  };

  load_tile_async<T, D>(ks, k_head, k0, s_len, k_stride, tid);
  load_tile_async<T, D>(vs, v_head, k0, s_len, k_stride, tid);
  load_stage(0, qt0);
  mma::cp_async_commit();

  // the thread's two keys, g and g + 8 of the warp's 16; an invalid key or
  // one past S gets INT_MAX, above every row, so the causal test masks it
  int key_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + key_base + g + 8 * i;
    key_r[i] = (key < s_len && valid_row[key]) ? key : INT_MAX;
  }
  const float scale_log2 = scale * kLog2e;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int qt = qt0; qt < n_qtiles; ++qt) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile qt has landed for all; tile qt - 1's readers are done
    const int st = (qt - qt0) & 1;
    if (qt + 1 < n_qtiles) {
      load_stage(st ^ 1, qt + 1);
      mma::cp_async_commit();
    }
    const T* qs = q_ring + st * 2 * L::tile_elems;
    const T* dos = qs + L::tile_elems;
    const float* lse_s = rows + st * 2 * kTile;
    const float* delta_s = lse_s + kTile;
    const int q0 = qt * kTile;

#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += CH) {
      if (q0 + c0 + CH - 1 < k0 + key_base) continue;  // wholly above the diagonal (warp-uniform)
      float p[NT][4];
      warp_abt<T, D, NT>(p, ks, key_base, qs, c0, lane);  // s^T: keys x rows
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c0 + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + c0 + 8 * j + 2 * t4 + (e & 1);
          const bool ok = row < t_len && key_r[e >> 1] <= row;
          const float l = (e & 1) ? l2.y : l2.x;
          p[j][e] = ok ? mma::exp2_approx(p[j][e] * scale_log2 - l * kLog2e) : 0.f;
        }
      }
      warp_acc_xb<T, D, NT>(dv_acc, p, dos, c0, lane);  // dv += p^T . do
      float ds[NT][4];
      warp_abt<T, D, NT>(ds, vs, key_base, dos, c0, lane);  // dp^T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c0 + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
      warp_acc_xb<T, D, NT>(dk_acc, ds, qs, c0, lane);  // dk += ds^T . q
    }
  }

  // the warp's rows of ks and vs are read by this warp alone
  warp_store<T, D>(dk_acc, ks + key_base * L::LD, dk_head, q_stride, k0 + key_base, s_len, lane);
  warp_store<T, D>(dv_acc, vs + key_base * L::LD, dv_head, q_stride, k0 + key_base, s_len, lane);
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
int launch_dq(const void* q, const void* k, const void* v, const void* key_valid,
              const void* dout, const void* lse, const void* delta, void* dq, int b, int t,
              int s, int hq, int hkv, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, b, (t + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)key_valid, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, t, s, hq, hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_valid,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv, int b,
               int t, int s, int hq, int hkv, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, b, (s + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)key_valid, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, t, s, hq, hkv, scale);
  return (int)cudaGetLastError();
}

template <typename K>
int blocks_per_sm(K kernel, size_t smem) {
  int n = 0;
  if (prepare(kernel, smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Each returns the launch's cudaGetLastError().
extern "C" int flash_attn_bwd_dq_launch(const void* q, const void* k, const void* v,
                                        const void* key_valid, const void* dout,
                                        const void* lse, const void* delta, void* dq, int b,
                                        int t, int s, int hq, int hkv, int d, float scale,
                                        int dtype, void* stream) {
  if (b <= 0 || t <= 0 || s <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && d == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, key_valid, dout, lse, delta, dq, b, t, s,
                                         hq, hkv, scale, st);
  if (dtype == 0 && d == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, key_valid, dout, lse, delta, dq, b, t, s,
                                        hq, hkv, scale, st);
  if (dtype == 1 && d == 128)
    return launch_dq<__half, 128>(q, k, v, key_valid, dout, lse, delta, dq, b, t, s, hq, hkv,
                                  scale, st);
  if (dtype == 1 && d == 64)
    return launch_dq<__half, 64>(q, k, v, key_valid, dout, lse, delta, dq, b, t, s, hq, hkv,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                         const void* key_valid, const void* dout,
                                         const void* lse, const void* delta, void* dk, void* dv,
                                         int b, int t, int s, int hq, int hkv, int d,
                                         float scale, int dtype, void* stream) {
  if (b <= 0 || t <= 0 || s <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && d == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, key_valid, dout, lse, delta, dk, dv, b, t,
                                          s, hq, hkv, scale, st);
  if (dtype == 0 && d == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, key_valid, dout, lse, delta, dk, dv, b, t,
                                         s, hq, hkv, scale, st);
  if (dtype == 1 && d == 128)
    return launch_dkv<__half, 128>(q, k, v, key_valid, dout, lse, delta, dk, dv, b, t, s, hq,
                                   hkv, scale, st);
  if (dtype == 1 && d == 64)
    return launch_dkv<__half, 64>(q, k, v, key_valid, dout, lse, delta, dk, dv, b, t, s, hq,
                                  hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the D = 128 bf16 kernels (which: 0 = K2dq, 1 = K2dkv) that one SM
// holds at once, by the runtime's occupancy calculation; -1 on error.
extern "C" int flash_attn_bwd_blocks_per_sm(int which) {
  const size_t smem = Layout<128>::bytes;
  return which == 0 ? blocks_per_sm(flash_bwd_dq_kernel<__nv_bfloat16, 128>, smem)
                    : blocks_per_sm(flash_bwd_dkv_kernel<__nv_bfloat16, 128>, smem);
}
