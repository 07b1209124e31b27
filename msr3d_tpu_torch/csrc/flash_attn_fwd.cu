// Flash-attention forward on Hopper: causal GQA attention with a key-valid
// mask and an online softmax.
//
// Replaces the Pallas TPU kernel msr3d_tpu/ops/flash_attention.py::_fwd_kernel
// (wrapper flash_attention -> _flash / _fwd_call). Same contract:
//   * scores S = (q . k) * scale in fp32, masked by causal (col <= row, both
//     counted from 0) AND key_valid AND in-range; masked scores are -1e30 and
//     their probabilities exactly 0;
//   * online softmax with running max m and sum l per row (l sums the fp32
//     probabilities); p is rounded to the value dtype before p . v, which
//     accumulates in fp32;
//   * o = acc / l, or 0 where l == 0 (a row with no valid key);
//     lse = m + log(l), or 0 where l == 0.
// Layouts are the model's own: q/o (B, T, Hq, D), k/v (B, S, Hkv, D), key_valid
// (B, S) bytes, lse (B, Hq, T) fp32. The kv head of q head h is h / (Hq / Hkv).
//
// What bounds it on this card: at the prefill shape (B 4, T = S = 225, 32
// heads, D 128, bf16) the bytes (q, k, v, o read or written once: ~29.5 MB,
// ~8.8 us at 3.35 TB/s) outweigh the causal matmul work (~3.4 GFLOP, ~3.5 us
// at 989 TFLOP/s). Design: one block of 4 warps per (query tile of 64 rows,
// head, batch); Q stays in shared memory, K/V tiles of 64 keys stream
// through it, key tiles above the diagonal are skipped, and neither the
// score matrix nor the probabilities ever reach device memory. The products
// run on the tensor cores through WMMA (bf16/fp16 in, fp32 accumulate); each
// warp owns 16 query rows, so the softmax needs warp shuffles only. The fp32
// output accumulator lives in shared memory so each row can be rescaled by
// its own alpha between tiles. Simple first: no TMA, no wgmma, no pipelining.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 64;   // query rows per block
constexpr int kBN = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;    // Q/K/V rows, in elements (16-bit)
  static constexpr int LDS = kBN + 4;  // fp32 scores
  static constexpr int LDP = kBN + 8;  // 16-bit probabilities
  static constexpr int LDO = D + 4;    // fp32 accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(uint16_t) * kBM * LDQ;
  static constexpr size_t v_off = k_off + sizeof(uint16_t) * kBN * LDQ;
  static constexpr size_t s_off = v_off + sizeof(uint16_t) * kBN * LDQ;
  static constexpr size_t p_off = s_off + sizeof(float) * kBM * LDS;
  static constexpr size_t o_off = p_off + sizeof(uint16_t) * kBM * LDP;
  static constexpr size_t m_off = o_off + sizeof(float) * kBM * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * kBM;
  static constexpr size_t a_off = l_off + sizeof(float) * kBM;
  static constexpr size_t kv_off = a_off + sizeof(float) * kBM;
  static constexpr size_t bytes = kv_off + sizeof(int) * kBN;
};

__device__ __forceinline__ void store_val(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_val(__half* p, float x) { *p = __float2half(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copies rows [row0, row0 + 64) of one head of a (.., rows, H, D) tensor into
// shared memory, 16 bytes a thread, zero-filling rows at or past n_rows.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int n_rows,
                                          size_t row_stride, int tid) {
  constexpr int kVecPerRow = D / 8;
  for (int i = tid; i < 64 * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDQ + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ key_valid, T* __restrict__ o,
                 float* __restrict__ lse, int t_len, int s_len, int hq, int hkv,
                 float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* ps = reinterpret_cast<T*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* ms = reinterpret_cast<float*>(smem + L::m_off);
  float* ls = reinterpret_cast<float*>(smem + L::l_off);
  float* as = reinterpret_cast<float*>(smem + L::a_off);
  int* kvs = reinterpret_cast<int*>(smem + L::kv_off);

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row_base = warp * 16;

  const T* q_head = q + ((size_t)b * t_len * hq + h) * D;
  const T* k_head = k + ((size_t)b * s_len * hkv + hk) * D;
  const T* v_head = v + ((size_t)b * s_len * hkv + hk) * D;
  const uint8_t* valid_row = key_valid + (size_t)b * s_len;

  load_tile<T, D>(qs, q_head, q0, t_len, (size_t)hq * D, tid);
  for (int i = tid; i < kBM * D; i += kThreads) os[(i / D) * L::LDO + i % D] = 0.f;
  for (int i = tid; i < kBM; i += kThreads) { ms[i] = kNegInf; ls[i] = 0.f; }

  // keys needed by this tile: with causality only cols <= the last row
  const int k_end = min(s_len, min(t_len, q0 + kBM));
  const int n_tiles = (k_end + kBN - 1) / kBN;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the previous tile's readers of ks/vs are done
    load_tile<T, D>(ks, k_head, k0, s_len, (size_t)hkv * D, tid);
    load_tile<T, D>(vs, v_head, k0, s_len, (size_t)hkv * D, tid);
    if (tid < kBN) kvs[tid] = (k0 + tid < s_len) && valid_row[k0 + tid];
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBN / 16];
#pragma unroll
      for (int n = 0; n < kBN / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, qs + row_base * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int n = 0; n < kBN / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, ks + n * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kBN / 16; ++n)
        wmma::store_matrix_sync(ss + row_base * L::LDS + n * 16, acc[n], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time, two columns a lane
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row_base + rr;
      const int row = q0 + r;
      float sv[kBN / 32];
      bool ok[kBN / 32];
      float mx = kNegInf;
#pragma unroll
      for (int c2 = 0; c2 < kBN / 32; ++c2) {
        const int c = lane + 32 * c2;
        ok[c2] = row < t_len && kvs[c] && k0 + c <= row;
        sv[c2] = ok[c2] ? ss[r * L::LDS + c] * scale : kNegInf;
        mx = fmaxf(mx, sv[c2]);
      }
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c2 = 0; c2 < kBN / 32; ++c2) {
        const float p = ok[c2] ? expf(sv[c2] - m_new) : 0.f;
        sum += p;
        store_val(ps + r * L::LDP + lane + 32 * c2, p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[r] = alpha;
        ms[r] = m_new;
        ls[r] = alpha * ls[r] + sum;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = row_base + i / D;
      os[r * L::LDO + i % D] *= as[r];
    }
    __syncwarp();

    // acc += p . v for this warp's rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fp[kBN / 16];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wmma::load_matrix_sync(fp[kk], ps + row_base * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* out_tile = os + row_base * L::LDO + dn * 16;
        wmma::load_matrix_sync(acc, out_tile, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, vs + kk * 16 * L::LDQ + dn * 16, L::LDQ);
          wmma::mma_sync(acc, fp[kk], fb, acc);
        }
        wmma::store_matrix_sync(out_tile, acc, L::LDO, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = row_base + rr;
    const int row = q0 + r;
    if (row >= t_len) break;
    const float l = ls[r];
    T* o_row = o + (((size_t)b * t_len + row) * hq + h) * D;
    for (int c = lane; c < D; c += 32) store_val(o_row + c, l > 0.f ? os[r * L::LDO + c] / l : 0.f);
    if (lane == 0)
      lse[((size_t)b * hq + h) * t_len + row] = l > 0.f ? ms[r] + logf(fmaxf(l, 1e-37f)) : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* key_valid, void* o,
           void* lse, int b, int t, int s, int hq, int hkv, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBM - 1) / kBM, hq, b);
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
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
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
