// Warp-level tensor-core building blocks for sm_80 and later, as inline PTX:
// mma.sync.m16n8k16 (bf16 or fp16 in, fp32 accumulate), ldmatrix (plain and
// transposed) and cp.async with zero fill. Shared by the attention kernels.
//
// Fragment layouts of mma.m16n8k16, with g = lane / 4 and t = lane % 4
// (PTX ISA, "Matrix Fragments for mma.m16n8k16 with floating point type"):
//   A (16 x 16, row): a0 = (row g,     k 2t, 2t+1)    a1 = (row g + 8, k 2t, 2t+1)
//                     a2 = (row g,     k 2t+8, 2t+9)  a3 = (row g + 8, k 2t+8, 2t+9)
//   B (16 x 8, col):  b0 = (k 2t, 2t+1, col g)        b1 = (k 2t+8, 2t+9, col g)
//   C (16 x 8, fp32): c0 = (row g, col 2t)  c1 = (row g, col 2t+1)
//                     c2 = (row g + 8, col 2t)  c3 = (row g + 8, col 2t+1)
// Each 32-bit register of A and B holds two 16-bit values, the lower index
// in the lower half. Two neighbouring C tiles (columns 0-7 and 8-15) hold, in
// one thread, exactly the elements of one A fragment over those 16 columns:
// (c0, c1) of the first tile is a0, (c2, c3) a1, and the second tile's pairs
// are a2 and a3. So a product's result can feed the next product from
// registers (pack_a_from_c).
//
// ldmatrix.x4 loads four 8 x 8 matrices of 16-bit values; lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned), and
// receives of matrix i, in register i, the elements (row g, columns 2t,
// 2t+1), or with .trans the elements (rows 2t, 2t+1, column g).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async ------------------------------------------------------------

// 16 bytes global -> shared, bypassing L1; with `valid` false the 16 bytes
// are zero-filled and the source is not read (it must still be an address
// inside the tensor).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const uint32_t n = valid ? 16u : 0u;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  const uint32_t n = valid ? 4u : 0u;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- ldmatrix ------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Addresses for the three uses below, all on a row-major tile of 16-bit
// values with `ld` elements a row (ld * 2 bytes a multiple of 16, and an odd
// multiple of 16 modulo 128 keeps the eight rows of a matrix on distinct
// banks: ld = D + 8 does for D 64 and 128).

// A fragment (16 rows x 16 k) of tile[row0 .. +16][k0 .. +16]:
// registers a0..a3 in order.
template <typename T>
__device__ __forceinline__ uint32_t addr_a(const T* tile, int ld, int row0, int k0, int lane) {
  return smem_addr(tile + (row0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// B fragments of X^T for a tile X[n][k] (the product A . X^T): two n8 tiles,
// n0 .. +8 in registers (0, 1) = (b0, b1) and n0 + 8 .. +16 in (2, 3), over
// k0 .. +16. Plain ldmatrix.
template <typename T>
__device__ __forceinline__ uint32_t addr_b_nk(const T* tile, int ld, int n0, int k0, int lane) {
  return smem_addr(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                   (((lane >> 3) & 1) << 3));
}

// B fragments of X for a tile X[k][n] (the product A . X): two n8 tiles, n0 ..
// +8 in registers (0, 1) and n0 + 8 .. +16 in (2, 3), over k0 .. +16. Needs
// ldmatrix.trans.
template <typename T>
__device__ __forceinline__ uint32_t addr_b_kn(const T* tile, int ld, int k0, int n0, int lane) {
  return smem_addr(tile + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
}

// ---- mma.sync --------------------------------------------------------------

// c += a . b, one m16n8k16 product.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1, __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx: 2 ulp over the full range;
// .ftz flushes a denormal result to 0). exp(y) is exp2_approx(y * log2(e)).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- fp32 -> 16-bit pairs --------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round16(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round16(float x, __half) {
  return __half2float(__float2half_rn(x));
}

// Two neighbouring fp32 C tiles (columns 0-7 and 8-15 of a 16-wide k step)
// as an A fragment, split so that hi + lo carries the fp32 values to ~2^-17
// relative: hi = round16(x), lo = round16(x - hi). A product with a 16-bit B
// is then exact in fp32 term by term for both parts.
template <typename T>
__device__ __forceinline__ void pack_a_from_c(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float (&c0)[4], const float (&c1)[4]) {
  float h[8], l[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = round16(c0[i], T());
    l[i] = c0[i] - h[i];
    h[4 + i] = round16(c1[i], T());
    l[4 + i] = c1[i] - h[4 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = pack2(h[2 * i], h[2 * i + 1], T());
    lo[i] = pack2(l[2 * i], l[2 * i + 1], T());
  }
}

}  // namespace mma
