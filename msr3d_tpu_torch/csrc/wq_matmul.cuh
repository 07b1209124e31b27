// Weight-only quantized matrix product on Hopper: the kernel of K3 (int8,
// w8_matmul.cu) and of K4 (int4, w4_matmul.cu), templated on the weight's
// bits. The two differ only in what a stage holds and in the inner loop.
//
//   y[b, n] = bf16( (sum_k bf16(x[b, k]) * w[k, n]) * scale[n] ),  fp32 accumulator
//
// x (B, K) bf16, scale (N,) fp32, y (B, N) bf16; the weight wq is int8,
// row-major along N. BITS 8: wq is (K, N), w = wq. BITS 4: wq is (K/2, N) in
// pack_w4's layout: the byte at packed row r holds input row r in its low
// nibble, biased by +8, and input row r + K/2 in its high nibble, two's
// complement. Below, "weight rows" are wq's rows, K or K/2 of them; with
// BITS 4 weight row r meets two slices of x, columns r and K/2 + r.
//
// What bounds it: at decode (B = 4..16) the weight bytes, read once, are
// almost all the traffic: 2 * B (BITS 8) or 4 * B (BITS 4) operations a
// weight byte, far below the card's ratio of tensor-core operations to
// bytes. The design keeps the weight stream running and does the rest on
// chip:
//   * products on the tensor cores: mma.sync.m16n8k16 bf16 -> fp32, x the A
//     operand (B rows padded to 16 with zeros in shared memory, never
//     stored), the weight the B operand, converted to bf16 in registers, the
//     conversion exact (an int8 has 8 significant bits, a nibble 4). Each
//     bf16 * bf16 product is exact in fp32, so the kernel differs from the
//     plain version only in the order of its fp32 sums and the one rounding
//     to bf16. BITS 8: a byte permute into the mantissa of 2^23, one fp32
//     subtract, a permute that packs two high halves. BITS 4: a byte permute
//     puts byte i of the fragment's two k rows into the low bytes of the two
//     halves of a word; a mask ORed into bf16 128.0 (0x4300) makes 128 + u
//     (u the biased low nibble, or the high nibble XOR 8) and one bf16x2 FMA
//     subtracts 136: u - 8, the signed value, so the +8 bias never enters the
//     sum. Each packed k16 step feeds two products a tile: the low nibbles
//     against x's slice [p, p + 16), the high ones against [K/2 + p, K/2 + p
//     + 16); the products a output are K3's, the weight bytes half;
//   * the fragment layout follows wq's bytes: the thread of group g loads,
//     from each of its four k rows (2t, 2t+1, 2t+8, 2t+9 of a k16 step), the
//     TN / 8 bytes of columns g * TN/8 .. + TN/8 in one shared load, and byte
//     i goes to n8 tile i. So tile i's fragment column g is the output column
//     g * TN/8 + i, a permutation of n that the epilogue undoes: a thread's
//     outputs are 2 * TN/8 adjacent columns;
//   * blocks of 4 warps take a column tile of TN columns and one of `split`
//     contiguous ranges of k tiles (KT = 8192 / TN weight rows a tile, twice
//     that for BITS 4); warp
//     w takes the k16 steps w, w + 4, ... of each tile and streams them, the
//     weight's columns and x's slice (both slices, BITS 4) of the same rows,
//     through a ring of STAGES stages of its own in shared memory by 16-byte
//     cp.async: one wait and one __syncwarp a stage and no block barrier in
//     the loop, the next stage's copies issued before this one's products.
//     The weight's 16-byte chunks are XOR-swizzled so that the four row loads
//     of a k16 step hit every bank once (TN 32, 64 and 128 alike);
//   * a grid that fills the card: the split sets the blocks. The four warps'
//     sums meet in shared memory in warp order; with split > 1 each block
//     writes its fp32 partial to a workspace, and the last block of the
//     column tile to finish (a counter a tile, which that block sets back to
//     zero) adds the partials in split order, scales and rounds. No float
//     atomics: two calls on the same inputs give the same bits;
//   * ragged edges in the same kernel: a weight row that is not 16-byte
//     aligned (N % 16 != 0) takes 4-byte cp.async (N % 4 == 0) or byte
//     loads; x takes 16-byte cp.async only where every slice starts 16-byte
//     aligned (the weight's rows % 8 == 0: K for BITS 8, K/2 for BITS 4), else
//     element loads; weight rows past the end and columns past N are
//     zero-filled. More than 16 rows of x take more row tiles along grid.z
//     (each reads the weight again).
//
// What bounds K3 now (PERF.md; scripts/w8_variants.py --diagnose on an
// H100): the copies. A copy of the kernel that skips the products takes
// 85-95 % of its time, one that skips the copies 55-70 %: the per-thread
// cp.async stream delivers about 1.9 TB/s whether the weight comes from HBM
// or from L2. K4's split is in PERF.md (scripts/w4_variants.py --diagnose).
// The next lever for both is the Tensor Memory Accelerator: one TMA copy a
// tile, tracked by an mbarrier, in place of 16-byte copies by every thread,
// then wgmma fed by a producer warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace wqmm {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;            // rows of x a block: one m16 tile
constexpr int kStageBytes = 8192;    // weight bytes a stage of the block's four rings (BITS 8)

template <int BITS, int TN>
struct Tile {
  static constexpr int SIDES = BITS == 4 ? 2 : 1;   // slices of x a weight row meets
  // BITS 4 stages hold twice the weight bytes: faster at every 7B shape (PERF.md)
  static constexpr int STAGE = BITS == 4 ? 2 * kStageBytes : kStageBytes;
  static constexpr int CPT = TN / 8;                // bytes a thread loads a k row = n8 tiles
  static constexpr int KT = STAGE / TN;             // weight rows a block stage (a k tile)
  static constexpr int CHUNKS = TN / 16;            // 16-byte chunks a weight row
  static constexpr int KSW = KT / (16 * kWarps);    // k16 steps of a warp's stage
  static constexpr int WROWS = 16 * KSW;            // weight rows of a warp's stage
  static constexpr int WBYTES = WROWS * TN;
  static constexpr int XLD = WROWS + 8;             // x row stride (bf16): ldmatrix rows on distinct banks
  static constexpr int XSIDE = kRows * XLD;         // bf16 of one slice of x in a stage
  static constexpr int WSTAGE = WBYTES + SIDES * XSIDE * 2;  // one stage of one warp's ring
  static constexpr int REDLD = 128 + 32 / CPT;      // floats of one (warp, n8 tile) of the sums
  static constexpr int RED = kWarps * CPT * REDLD * 4;
  static_assert(KSW >= 1 && KT % (16 * kWarps) == 0, "a k tile gives every warp whole k16 steps");
};

// Byte offset of weight (row r, column c) in a warp's stage: the 16-byte
// chunk index P = (r * TN + c) / 16 XORed, inside its aligned group of eight
// (one 128-byte line), with ((l << 1) ^ (l >> 1)) & 6 of its line l (mod 8).
template <int TN>
__device__ __forceinline__ int wswz(int r, int c) {
  const int p = (r * TN + c) >> 4;
  const int l = (p >> 3) & 7;
  return ((p ^ (((l << 1) ^ (l >> 1)) & 6)) << 4) | (c & 15);
}

// BITS 8: two signed bytes (byte i of lo, byte i of hi) as a bf16 pair, lo in
// the lower half. u = v + 128 goes into the low mantissa byte of 2^23
// (0x4B000000), so the float is 2^23 + 128 + v exactly; subtracting 2^23 +
// 128 leaves v, whose high 16 bits are bf16(v) exactly (|v| <= 128 has at
// most 8 significant bits).
template <int I>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t ulo, uint32_t uhi) {
  const float flo = __uint_as_float(__byte_perm(ulo, 0x4B000000u, 0x7650 + I)) - 8388736.f;
  const float fhi = __uint_as_float(__byte_perm(uhi, 0x4B000000u, 0x7650 + I)) - 8388736.f;
  return __byte_perm(__float_as_uint(flo), __float_as_uint(fhi), 0x7632);
}

// BITS 4: h - 136 on both bf16 halves of h (one bf16x2 FMA, exact here).
__device__ __forceinline__ uint32_t minus136(uint32_t h) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(h), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// BITS 4: byte i of rows a (lower half) and b (upper half) as two bf16 pairs
// of signed values: lo from the low nibbles (biased +8), hi from the high
// ones (two's complement, XOR 8 biases them). The permute puts the two bytes
// at bits 0 and 16; the mask and OR (one lop3) make the bf16 128 + u.
template <int I>
__device__ __forceinline__ void nibble_pairs(uint32_t ra, uint32_t rb, uint32_t& lo, uint32_t& hi) {
  const uint32_t v = __byte_perm(ra, rb, 0x4400 + 0x1111 * I);
  lo = minus136((v & 0x000F000Fu) | 0x43004300u);
  hi = minus136(((v >> 4) & 0x000F000Fu) ^ 0x43084308u);
}

// CPT bytes of one weight row from shared memory as CPT / 4 words.
template <int CPT>
__device__ __forceinline__ void load_row(uint32_t (&w)[CPT / 4], const unsigned char* p) {
  if constexpr (CPT == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (CPT == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Copy a warp's share of k tile `tile` into one stage of its ring: the k16
// steps warp, warp + 4, ... of the tile (stage row r is weight row
// tile * KT + 16 * (warp + 4 * (r / 16)) + r % 16), the weight's columns
// n0 .. n0 + TN and x's rows row0 .. row0 + rows, of each slice (slice s of
// weight row kg is x's column s * k + kg; x's rows are SIDES * k long).
// cp.async where the rows are aligned (WV 16 or 4, XV), plain loads and
// stores where not; weight rows past k and columns past N are zero.
template <int BITS, int TN, int WV, bool XV>
__device__ __forceinline__ void load_stage(unsigned char* st, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ wq, int tile, int warp,
                                           int n0, int row0, int rows, int k, int n, int lane) {
  using T = Tile<BITS, TN>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + T::WBYTES);
  const int kb = tile * T::KT + 16 * warp;  // weight row of stage row 0
  if constexpr (WV == 16) {
#pragma unroll
    for (int i = lane; i < T::WROWS * T::CHUNKS; i += 32) {
      const int r = i / T::CHUNKS, c = (i % T::CHUNKS) * 16;
      const int kg = kb + 16 * kWarps * (r >> 4) + (r & 15);
      const bool ok = kg < k && n0 + c < n;
      mma::cp_async_16(st + wswz<TN>(r, c), ok ? wq + (size_t)kg * n + n0 + c : wq, ok);
    }
  } else if constexpr (WV == 4) {
    for (int i = lane; i < T::WROWS * TN / 4; i += 32) {
      const int r = i / (TN / 4), c = (i % (TN / 4)) * 4;
      const int kg = kb + 16 * kWarps * (r >> 4) + (r & 15);
      const bool ok = kg < k && n0 + c < n;
      mma::cp_async_4(st + wswz<TN>(r, c), ok ? wq + (size_t)kg * n + n0 + c : wq, ok);
    }
  } else {
    for (int i = lane; i < T::WROWS * TN; i += 32) {
      const int r = i / TN, c = i % TN;
      const int kg = kb + 16 * kWarps * (r >> 4) + (r & 15);
      st[wswz<TN>(r, c)] = kg < k && n0 + c < n ? (unsigned char)wq[(size_t)kg * n + n0 + c] : 0;
    }
  }
#pragma unroll
  for (int side = 0; side < T::SIDES; ++side) {
    if constexpr (XV) {
      for (int i = lane; i < rows * T::KSW * 2; i += 32) {
        const int r = i / (T::KSW * 2), j = i % (T::KSW * 2);
        const int kg = kb + 16 * kWarps * (j >> 1) + 8 * (j & 1);
        const bool ok = kg < k;
        mma::cp_async_16(xs + side * T::XSIDE + r * T::XLD + 8 * j,
                         ok ? x + (size_t)(row0 + r) * (T::SIDES * k) + side * k + kg : x, ok);
      }
    } else {
#pragma unroll 1
      for (int i = lane; i < rows * T::WROWS; i += 32) {
        const int r = i / T::WROWS, c = i % T::WROWS;
        const int kg = kb + 16 * kWarps * (c >> 4) + (c & 15);
        xs[side * T::XSIDE + r * T::XLD + c] =
            kg < k ? x[(size_t)(row0 + r) * (T::SIDES * k) + side * k + kg] : __float2bfloat16(0.f);
      }
    }
  }
}

// k: the weight's rows (K for BITS 8, K/2 for BITS 4). WV: weight copies of
// 16 bytes (N % 16 == 0 and wq 16-byte aligned), 4 bytes (N % 4 == 0, 4-byte
// aligned) or 1 (plain loads); XV: x copies of 16 bytes (k % 8 == 0, x
// 16-byte aligned) or plain loads of one bf16.
template <int BITS, int TN, int STAGES, int WV, bool XV>
__global__ void __launch_bounds__(kThreads)
wq_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                 float* __restrict__ ws, int* __restrict__ counters, int b, int k, int n) {
  using T = Tile<BITS, TN>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TN;
  const int split = gridDim.y, part = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, b - row0);
  const int tiles = (k + T::KT - 1) / T::KT;
  const int t_begin = (int)((long long)part * tiles / split);
  const int nt = (int)((long long)(part + 1) * tiles / split) - t_begin;
  unsigned char* ring = smem + warp * STAGES * T::WSTAGE;  // this warp's own ring

  // x's pad rows (rows .. 15 of each slice) stay zero in every stage; nothing
  // writes them
  const int pad = (kRows - rows) * T::XLD / 8;  // 16-byte words of a slice of a stage
#pragma unroll
  for (int side = 0; side < T::SIDES; ++side)
    for (int i = lane; i < STAGES * pad; i += 32)
      reinterpret_cast<uint4*>(ring + (i / pad) * T::WSTAGE + T::WBYTES +
                               (side * kRows + rows) * T::XLD * 2)[i % pad] =
          make_uint4(0, 0, 0, 0);

  float acc[T::CPT][4];
#pragma unroll
  for (int i = 0; i < T::CPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // Each warp streams its own k rows through its own ring: no block barrier
  // in the loop, only the warp's wait for its copies and a __syncwarp.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt)
      load_stage<BITS, TN, WV, XV>(ring + s * T::WSTAGE, x, wq, t_begin + s, warp, n0, row0, rows,
                                   k, n, lane);
    mma::cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    mma::cp_async_wait<STAGES - 2>();
    __syncwarp();  // stage `it` landed for every lane; the slot refilled next was read last round
    if (it + STAGES - 1 < nt)
      load_stage<BITS, TN, WV, XV>(ring + ((it + STAGES - 1) % STAGES) * T::WSTAGE, x, wq,
                                   t_begin + it + STAGES - 1, warp, n0, row0, rows, k, n, lane);
    mma::cp_async_commit();

    const unsigned char* st = ring + (it % STAGES) * T::WSTAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + T::WBYTES);
#pragma unroll
    for (int step = 0; step < T::KSW; ++step) {
      // x's A fragments: the slice of the step's rows and (BITS 4) the high nibbles' slice
      uint32_t a[4], ah[4];
      mma::ldmatrix_x4(a, mma::addr_a(xs, T::XLD, 0, 16 * step, lane));
      if constexpr (BITS == 4)
        mma::ldmatrix_x4(ah, mma::addr_a(xs + T::XSIDE, T::XLD, 0, 16 * step, lane));
      uint32_t w[4][T::CPT / 4];  // rows 2t, 2t+1, 2t+8, 2t+9 of the step
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        load_row<T::CPT>(w[rr],
                         st + wswz<TN>(16 * step + 2 * t + (rr & 1) + 8 * (rr >> 1), g * T::CPT));
#pragma unroll
      for (int q = 0; q < T::CPT / 4; ++q) {
        if constexpr (BITS == 8) {
          const uint32_t u0 = w[0][q] ^ 0x80808080u, u1 = w[1][q] ^ 0x80808080u;
          const uint32_t u2 = w[2][q] ^ 0x80808080u, u3 = w[3][q] ^ 0x80808080u;
          mma::mma_16816(acc[4 * q + 0], a, bf16_pair<0>(u0, u1), bf16_pair<0>(u2, u3), __nv_bfloat16());
          mma::mma_16816(acc[4 * q + 1], a, bf16_pair<1>(u0, u1), bf16_pair<1>(u2, u3), __nv_bfloat16());
          mma::mma_16816(acc[4 * q + 2], a, bf16_pair<2>(u0, u1), bf16_pair<2>(u2, u3), __nv_bfloat16());
          mma::mma_16816(acc[4 * q + 3], a, bf16_pair<3>(u0, u1), bf16_pair<3>(u2, u3), __nv_bfloat16());
        } else {
          uint32_t lo[4][2], hi[4][2];  // tile 4q + i: (b0, b1) of the low and the high nibbles
          nibble_pairs<0>(w[0][q], w[1][q], lo[0][0], hi[0][0]);
          nibble_pairs<0>(w[2][q], w[3][q], lo[0][1], hi[0][1]);
          nibble_pairs<1>(w[0][q], w[1][q], lo[1][0], hi[1][0]);
          nibble_pairs<1>(w[2][q], w[3][q], lo[1][1], hi[1][1]);
          nibble_pairs<2>(w[0][q], w[1][q], lo[2][0], hi[2][0]);
          nibble_pairs<2>(w[2][q], w[3][q], lo[2][1], hi[2][1]);
          nibble_pairs<3>(w[0][q], w[1][q], lo[3][0], hi[3][0]);
          nibble_pairs<3>(w[2][q], w[3][q], lo[3][1], hi[3][1]);
          // the low halves' products first, then the high halves', so that no
          // product waits on the one just issued into the same accumulator
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma::mma_16816(acc[4 * q + i], a, lo[i][0], lo[i][1], __nv_bfloat16());
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma::mma_16816(acc[4 * q + i], ah, hi[i][0], hi[i][1], __nv_bfloat16());
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every ring is done: the warps' sums go where they were

  // The warps' sums meet in fragment order: (warp, tile i) holds REDLD
  // floats, lane l's (c0, c1) at 2l and (c2, c3) at 64 + 2l (conflict-free
  // float2 stores). Output (row r, column c) is tile i = c % CPT, fragment
  // column f = c / CPT of lane (r % 8) * 4 + f / 2, half r / 8; the padded
  // stride REDLD puts 32 adjacent columns on 32 banks.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::CPT; ++i) {
    float* dst = red + (warp * T::CPT + i) * T::REDLD + 2 * lane;
    *reinterpret_cast<float2*>(dst) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(dst + 64) = make_float2(acc[i][2], acc[i][3]);
  }
  __syncthreads();
  for (int idx = tid; idx < rows * TN; idx += kThreads) {
    const int r = idx / TN, c = idx % TN;
    if (n0 + c >= n) continue;
    const int f = c / T::CPT;
    const int off = (c % T::CPT) * T::REDLD + 64 * (r >> 3) + 2 * ((r & 7) * 4 + (f >> 1)) + (f & 1);
    float s = red[off];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * T::CPT * T::REDLD + off];
    const size_t at = (size_t)(row0 + r) * n + n0 + c;
    if (split == 1)
      y[at] = __float2bfloat16(s * scale[n0 + c]);
    else
      ws[(size_t)part * b * n + at] = s;
  }
  if (split == 1) return;

  // The last block of this column tile to finish adds the splits' partials
  // in split order (whichever block it is), scales and rounds, and resets
  // the tile's counter for the next launch.
  __threadfence();
  __syncthreads();
  const int tile_id = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(counters + tile_id, 1) == split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a thread's outputs idx = tid + 128 * e, G at a time, with four splits'
  // loads of each in flight
  constexpr int G = T::CPT < 8 ? T::CPT : 8;
  const size_t bn = (size_t)b * n;
  const float* part0 = ws + (size_t)row0 * n;
#pragma unroll 1
  for (int e0 = 0; e0 < T::CPT; e0 += G) {  // CPT = kRows * TN / kThreads outputs at most
    float sum[G];
    int at[G];  // row * n + column inside this row tile's b * n outputs
    bool ok[G];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int idx = tid + kThreads * (e0 + e), r = idx / TN, c = idx % TN;
      ok[e] = r < rows && n0 + c < n;
      at[e] = r * n + n0 + c;
      sum[e] = 0.f;
    }
    for (int p = 0; p < split; p += 4) {
      float v[4][G];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < G; ++e)
          v[q][e] = ok[e] && p + q < split ? __ldcg(part0 + (p + q) * bn + at[e]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < G; ++e)
          if (p + q < split) sum[e] = p + q == 0 ? v[0][e] : sum[e] + v[q][e];
    }
#pragma unroll
    for (int e = 0; e < G; ++e)
      if (ok[e]) y[(size_t)row0 * n + at[e]] = __float2bfloat16(sum[e] * scale[at[e] % n]);
  }
  if (tid == 0) counters[tile_id] = 0;
}

template <int BITS, int TN, int STAGES>
constexpr int smem_bytes() {
  using T = Tile<BITS, TN>;
  return kWarps * STAGES * T::WSTAGE > T::RED ? kWarps * STAGES * T::WSTAGE : T::RED;
}

// static: the flag below then belongs to this library alone (a template's
// static local with external linkage is one object across every library of
// the process that instantiates it, and another library's kernel is not set)
template <int BITS, int TN, int STAGES, int WV, bool XV>
static int launch_instance(dim3 grid, const void* x, const void* wq, const void* scale, void* y,
                           void* ws, void* counters, int b, int k, int n, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<BITS, TN, STAGES>();
  auto kernel = wq_matmul_kernel<BITS, TN, STAGES, WV, XV>;
  static bool attr = false;  // one instance, one setting: racing threads set the same value
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  kernel<<<grid, kThreads, bytes, stream>>>((const __nv_bfloat16*)x, (const int8_t*)wq,
                                            (const float*)scale, (__nv_bfloat16*)y, (float*)ws,
                                            (int*)counters, b, k, n);
  return 0;
}

template <int BITS, int TN, int STAGES>
int launch_edges(dim3 grid, const void* x, const void* wq, const void* scale, void* y, void* ws,
                 void* cnt, int b, int k, int n, cudaStream_t s) {
  const uintptr_t wa = reinterpret_cast<uintptr_t>(wq), xa = reinterpret_cast<uintptr_t>(x);
  const int wv = n % 16 == 0 && wa % 16 == 0 ? 16 : (n % 4 == 0 && wa % 4 == 0 ? 4 : 1);
  const bool xv = k % 8 == 0 && xa % 16 == 0;
  if (wv == 16)
    return xv ? launch_instance<BITS, TN, STAGES, 16, true>(grid, x, wq, scale, y, ws, cnt, b, k, n, s)
              : launch_instance<BITS, TN, STAGES, 16, false>(grid, x, wq, scale, y, ws, cnt, b, k, n, s);
  if (wv == 4)
    return xv ? launch_instance<BITS, TN, STAGES, 4, true>(grid, x, wq, scale, y, ws, cnt, b, k, n, s)
              : launch_instance<BITS, TN, STAGES, 4, false>(grid, x, wq, scale, y, ws, cnt, b, k, n, s);
  return xv ? launch_instance<BITS, TN, STAGES, 1, true>(grid, x, wq, scale, y, ws, cnt, b, k, n, s)
            : launch_instance<BITS, TN, STAGES, 1, false>(grid, x, wq, scale, y, ws, cnt, b, k, n, s);
}

template <int BITS, int TN>
int launch_stages(int stages, dim3 grid, const void* x, const void* wq, const void* scale,
                  void* y, void* ws, void* cnt, int b, int k, int n, cudaStream_t s) {
  switch (stages) {
    case 2: return launch_edges<BITS, TN, 2>(grid, x, wq, scale, y, ws, cnt, b, k, n, s);
    case 3: return launch_edges<BITS, TN, 3>(grid, x, wq, scale, y, ws, cnt, b, k, n, s);
    case 4: return launch_edges<BITS, TN, 4>(grid, x, wq, scale, y, ws, cnt, b, k, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch: x (b, SIDES * k) bf16, wq (k, n) int8, scale (n,) fp32, y (b,
// n) bf16, all contiguous on the card; k the weight's rows. split (1..64)
// ranges of k tiles, column tile tn (32, 64 or 128), stages (2, 3 or 4) of
// each warp's cp.async ring. With split > 1, ws holds split * b * n fp32 (the
// partial sums) and counters one int32 a column tile and row tile, ceil(n /
// tn) * ceil(b / 16), zero before the launch and zero again after it (the
// kernel resets them): launches that share counters must run one after
// another (one stream). Returns the launch's CUDA error, or 0.
template <int BITS>
int launch(const void* x, const void* wq, const void* scale, void* y, void* ws, void* counters,
           int b, int k, int n, int split, int tn, int stages, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (split < 1 || split > 64 || (split > 1 && (ws == nullptr || counters == nullptr)) || k < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + tn - 1) / tn, split, (b + kRows - 1) / kRows);
  int err;
  switch (tn) {
    case 32: err = launch_stages<BITS, 32>(stages, grid, x, wq, scale, y, ws, counters, b, k, n, s); break;
    case 64: err = launch_stages<BITS, 64>(stages, grid, x, wq, scale, y, ws, counters, b, k, n, s); break;
    case 128: err = launch_stages<BITS, 128>(stages, grid, x, wq, scale, y, ws, counters, b, k, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

// Blocks of the instance (tn, stages) that fit on one SM (registers, shared
// memory), for the variants' records; 0 for an unknown instance.
template <int BITS>
int blocks_per_sm(int tn, int stages) {
  int blocks = 0;
  auto query = [&](auto kernel, int bytes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
  };
#define WQ_QUERY(TN, ST)                                                              \
  if (tn == TN && stages == ST)                                                       \
    query(wq_matmul_kernel<BITS, TN, ST, 16, true>, smem_bytes<BITS, TN, ST>());
  WQ_QUERY(32, 2) WQ_QUERY(32, 3) WQ_QUERY(32, 4)
  WQ_QUERY(64, 2) WQ_QUERY(64, 3) WQ_QUERY(64, 4)
  WQ_QUERY(128, 2) WQ_QUERY(128, 3) WQ_QUERY(128, 4)
#undef WQ_QUERY
  return blocks;
}

}  // namespace wqmm
