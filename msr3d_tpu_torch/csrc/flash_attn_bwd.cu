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
// heads, D 128, bf16) there are ~4.2 M causal (row, key) pairs over all
// heads. K2dq moves ~42 MB (q, k, v, do read, dq written: ~12.5 us at 3.35
// TB/s) for 3 products of 2D flops a pair (~3.2 GFLOP, ~3.3 us at 989
// TFLOP/s); K2dkv moves ~50 MB (~15 us) for 4 products (~4.3 GFLOP). The
// bytes bound both. This simple design runs the products with an fp32
// operand (ds.k, p^T.do, ds^T.q) on the CUDA cores at 67 TFLOP/s: one in
// K2dq (~16 us), two in K2dkv (~32 us), and those bound it instead.
// Design: K2dq is one block of 4 warps per (64-row query tile,
// q head, batch) that streams 64-key tiles of K/V through shared memory up to
// the diagonal; K2dkv is one block per (64-key tile, q head, batch) that
// streams 64-row tiles of Q/dO (with lse and delta) from the diagonal down.
// q.k^T and do.v^T run on the tensor cores through WMMA (16-bit in, fp32
// accumulate: every product of two 16-bit values is exact in fp32, so only
// the summation order differs from the fp32 math of the TPU kernels). Each
// warp owns 16 rows (K2dq) or 16 keys (K2dkv) of the score tile, so p and ds
// need warp-level sync only; the fp32 products accumulate into fp32 tiles in
// shared memory through per-thread register partials. Simple first: no TMA,
// no wgmma, no pipelining, and the fp32 products are not on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;     // 16-bit tiles, in elements
  static constexpr int LDS = kTile + 4;  // fp32 score tiles
  static constexpr int LDA = D + 4;     // fp32 accumulators
  static constexpr size_t tile16 = sizeof(uint16_t) * kTile * LDQ;
  static constexpr size_t tile32 = sizeof(float) * kTile * LDS;
  static constexpr size_t acc32 = sizeof(float) * kTile * LDA;
  // four 16-bit tiles, two score tiles, `n_acc` accumulators, then
  // lse, delta and the key-valid flags of one tile
  static constexpr size_t s_off = 4 * tile16;
  static constexpr size_t bytes(int n_acc) {
    return 4 * tile16 + 2 * tile32 + n_acc * acc32 + 3 * sizeof(float) * kTile;
  }
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_val(__half* p, float x) { *p = __float2half(x); }

// Copies rows [row0, row0 + 64) of one head of a (.., rows, H, D) tensor into
// shared memory, 16 bytes a thread, zero-filling rows at or past n_rows.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int n_rows,
                                          size_t row_stride, int tid) {
  constexpr int kVecPerRow = D / 8;
  for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDQ + c) = val;
  }
}

// out (16 x 64 fp32, ld LDS) = A (16 x D) . B^T, with B a 64 x D tile: the
// warp's 16 rows of A against all 64 rows of B, on the tensor cores.
template <typename T, int D>
__device__ __forceinline__ void warp_abt(float* out, const T* a, const T* b) {
  using L = Layout<D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTile / 16];
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, L::LDQ);
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + n * 16 * L::LDQ + kk, L::LDQ);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], L::LDS, wmma::mem_row_major);
}

// acc (16 x D fp32, ld LDA) += A (16 x 64 fp32, ld LDS) . B (64 x D, 16-bit,
// ld LDQ), in fp32 on the CUDA cores. Lane l owns columns l, l + 32, ...; the
// warp's 16 rows are summed in registers over the 64-deep product, then added
// to the accumulator once.
template <typename T, int D>
__device__ __forceinline__ void warp_acc_ab(float* acc, const float* a, const T* b, int lane) {
  using L = Layout<D>;
  constexpr int kCols = D / 32;
  float part[16][kCols];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) part[i][j] = 0.f;
  for (int k = 0; k < kTile; ++k) {
    float bv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = to_float(b[k * L::LDQ + lane + 32 * j]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float av = a[i * L::LDS + k];
#pragma unroll
      for (int j = 0; j < kCols; ++j) part[i][j] = fmaf(av, bv[j], part[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i * L::LDA + lane + 32 * j] += part[i][j];
}

// K2dq: one block per (query tile, q head, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t_len, int s_len, int hq, int hkv, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L::tile16);
  T* ks = reinterpret_cast<T*>(smem + 2 * L::tile16);
  T* vs = reinterpret_cast<T*>(smem + 3 * L::tile16);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);  // s, then p, then ds
  float* dps = reinterpret_cast<float*>(smem + L::s_off + L::tile32);
  float* acc = reinterpret_cast<float*>(smem + L::s_off + 2 * L::tile32);
  float* lse_s = reinterpret_cast<float*>(smem + L::s_off + 2 * L::tile32 + L::acc32);
  float* delta_s = lse_s + kTile;
  int* kvs = reinterpret_cast<int*>(delta_s + kTile);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row_base = warp * 16;

  const T* q_head = q + ((size_t)b * t_len * hq + h) * D;
  const T* do_head = dout + ((size_t)b * t_len * hq + h) * D;
  const T* k_head = k + ((size_t)b * s_len * hkv + hk) * D;
  const T* v_head = v + ((size_t)b * s_len * hkv + hk) * D;
  const float* lse_row = lse + ((size_t)b * hq + h) * t_len;
  const float* delta_row = delta + ((size_t)b * hq + h) * t_len;
  const uint8_t* valid_row = key_valid + (size_t)b * s_len;

  load_tile<T, D>(qs, q_head, q0, t_len, (size_t)hq * D, tid);
  load_tile<T, D>(dos, do_head, q0, t_len, (size_t)hq * D, tid);
  for (int i = tid; i < kTile; i += kThreads) {
    lse_s[i] = q0 + i < t_len ? lse_row[q0 + i] : 0.f;
    delta_s[i] = q0 + i < t_len ? delta_row[q0 + i] : 0.f;
  }
  for (int i = lane; i < 16 * D; i += 32) acc[(row_base + i / D) * L::LDA + i % D] = 0.f;

  // keys needed by this tile: with causality only cols <= the last row
  const int k_end = min(s_len, min(t_len, q0 + kTile));
  const int n_tiles = (k_end + kTile - 1) / kTile;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers of ks/vs/kvs are done
    load_tile<T, D>(ks, k_head, k0, s_len, (size_t)hkv * D, tid);
    load_tile<T, D>(vs, v_head, k0, s_len, (size_t)hkv * D, tid);
    if (tid < kTile) kvs[tid] = (k0 + tid < s_len) && valid_row[k0 + tid];
    __syncthreads();

    warp_abt<T, D>(ss + row_base * L::LDS, qs + row_base * L::LDQ, ks);
    warp_abt<T, D>(dps + row_base * L::LDS, dos + row_base * L::LDQ, vs);
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = row_base + rr;
      const int row = q0 + r;
#pragma unroll
      for (int c2 = 0; c2 < kTile / 32; ++c2) {
        const int c = lane + 32 * c2;
        const bool ok = row < t_len && kvs[c] && k0 + c <= row;
        const float p = ok ? expf(ss[r * L::LDS + c] * scale - lse_s[r]) : 0.f;
        ss[r * L::LDS + c] = p * (dps[r * L::LDS + c] - delta_s[r]) * scale;
      }
    }
    __syncwarp();
    warp_acc_ab<T, D>(acc + row_base * L::LDA, ss + row_base * L::LDS, ks, lane);
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + row_base + rr;
    if (row >= t_len) break;
    T* dq_row = dq + (((size_t)b * t_len + row) * hq + h) * D;
    for (int c = lane; c < D; c += 32) store_val(dq_row + c, acc[(row_base + rr) * L::LDA + c]);
  }
}

// K2dkv: one block per (key tile, q head, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len, int hq,
                     int hkv, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + L::tile16);
  T* qs = reinterpret_cast<T*>(smem + 2 * L::tile16);
  T* dos = reinterpret_cast<T*>(smem + 3 * L::tile16);
  float* pts = reinterpret_cast<float*>(smem + L::s_off);  // s^T, then p^T
  float* dsts = reinterpret_cast<float*>(smem + L::s_off + L::tile32);  // dp^T, then ds^T
  float* dk_acc = reinterpret_cast<float*>(smem + L::s_off + 2 * L::tile32);
  float* dv_acc = reinterpret_cast<float*>(smem + L::s_off + 2 * L::tile32 + L::acc32);
  float* lse_s = reinterpret_cast<float*>(smem + L::s_off + 2 * L::tile32 + 2 * L::acc32);
  float* delta_s = lse_s + kTile;
  int* kvs = reinterpret_cast<int*>(delta_s + kTile);

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int key_base = warp * 16;

  const T* q_head = q + ((size_t)b * t_len * hq + h) * D;
  const T* do_head = dout + ((size_t)b * t_len * hq + h) * D;
  const T* k_head = k + ((size_t)b * s_len * hkv + hk) * D;
  const T* v_head = v + ((size_t)b * s_len * hkv + hk) * D;
  const float* lse_row = lse + ((size_t)b * hq + h) * t_len;
  const float* delta_row = delta + ((size_t)b * hq + h) * t_len;
  const uint8_t* valid_row = key_valid + (size_t)b * s_len;

  load_tile<T, D>(ks, k_head, k0, s_len, (size_t)hkv * D, tid);
  load_tile<T, D>(vs, v_head, k0, s_len, (size_t)hkv * D, tid);
  if (tid < kTile) kvs[tid] = (k0 + tid < s_len) && valid_row[k0 + tid];
  for (int i = lane; i < 16 * D; i += 32) {
    dk_acc[(key_base + i / D) * L::LDA + i % D] = 0.f;
    dv_acc[(key_base + i / D) * L::LDA + i % D] = 0.f;
  }

  // query rows that see this tile: with causality only rows >= its first key
  const int n_qtiles = (t_len + kTile - 1) / kTile;
  for (int qt = k0 / kTile; qt < n_qtiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers of qs/dos/lse/delta are done
    load_tile<T, D>(qs, q_head, q0, t_len, (size_t)hq * D, tid);
    load_tile<T, D>(dos, do_head, q0, t_len, (size_t)hq * D, tid);
    for (int i = tid; i < kTile; i += kThreads) {
      lse_s[i] = q0 + i < t_len ? lse_row[q0 + i] : 0.f;
      delta_s[i] = q0 + i < t_len ? delta_row[q0 + i] : 0.f;
    }
    __syncthreads();

    warp_abt<T, D>(pts + key_base * L::LDS, ks + key_base * L::LDQ, qs);
    warp_abt<T, D>(dsts + key_base * L::LDS, vs + key_base * L::LDQ, dos);
    __syncwarp();

    for (int kk = 0; kk < 16; ++kk) {
      const int kr = key_base + kk;
      const int col = k0 + kr;
      const bool key_ok = kvs[kr] != 0;
#pragma unroll
      for (int c2 = 0; c2 < kTile / 32; ++c2) {
        const int r = lane + 32 * c2;
        const int row = q0 + r;
        const bool ok = key_ok && row < t_len && col <= row;
        const float p = ok ? expf(pts[kr * L::LDS + r] * scale - lse_s[r]) : 0.f;
        pts[kr * L::LDS + r] = p;
        dsts[kr * L::LDS + r] = p * (dsts[kr * L::LDS + r] - delta_s[r]) * scale;
      }
    }
    __syncwarp();
    warp_acc_ab<T, D>(dv_acc + key_base * L::LDA, pts + key_base * L::LDS, dos, lane);
    warp_acc_ab<T, D>(dk_acc + key_base * L::LDA, dsts + key_base * L::LDS, qs, lane);
  }
  __syncwarp();

  for (int kk = 0; kk < 16; ++kk) {
    const int key = k0 + key_base + kk;
    if (key >= s_len) break;
    const size_t off = (((size_t)b * s_len + key) * hq + h) * D;
    for (int c = lane; c < D; c += 32) {
      store_val(dk + off + c, dk_acc[(key_base + kk) * L::LDA + c]);
      store_val(dv + off + c, dv_acc[(key_base + kk) * L::LDA + c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* key_valid,
              const void* dout, const void* lse, const void* delta, void* dq, int b, int t,
              int s, int hq, int hkv, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes(1);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kTile - 1) / kTile, hq, b);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)key_valid, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, t, s, hq, hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_valid,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv, int b,
               int t, int s, int hq, int hkv, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes(2);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + kTile - 1) / kTile, hq, b);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)key_valid, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, t, s, hq, hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Each returns the launch's cudaGetLastError().
extern "C" int flash_attn_bwd_dq_launch(const void* q, const void* k, const void* v,
                                        const void* key_valid, const void* dout,
                                        const void* lse, const void* delta, void* dq, int b,
                                        int t, int s, int hq, int hkv, int d, float scale,
                                        int dtype, void* stream) {
  if (b <= 0 || t <= 0 || s <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
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
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
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
