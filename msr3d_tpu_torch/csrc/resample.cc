// The integer passes of Pillow's resample (src/libImaging/Resample.c,
// ImagingResample{Horizontal,Vertical}_8bpc) of a C-order (rows, columns, 3)
// uint8 image: each output pixel is the sum of its taps' input
// pixels times their fixed-point weights, from half an output step
// (1 << (PRECISION_BITS - 1)), shifted down by PRECISION_BITS and clipped
// to 0..255. The weights come from msr3d_tpu_torch/data/data_utils.py,
// which computes Pillow's double-precision coefficients in Pillow's order.
// The sums are exact in int32, so their order is free.
//
// C interface (bound with ctypes by msr3d_tpu_torch/data/data_utils.py):
//   msr3d_resample_rows(src, row, first, taps, weights, n_out, ksize, out)
//     the vertical pass: src (n_in, row) -> out (n_out, row), row = columns *
//     3; output row i reads input rows first[i] .. first[i] + taps[i]
//     - 1 with weights[i * ksize + 0 .. taps[i] - 1]
//   msr3d_resample_cols(src, rows, cols_in, first, taps, weights, n_out,
//                       ksize, out)
//     the horizontal pass: (rows, cols_in, 3) -> (rows, n_out, 3), output
//     column i from input columns first[i] .. likewise
// The caller checks that the taps lie inside the image.

#include <cstdint>
#include <vector>

namespace {
constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int32_t acc) {
  int32_t v = acc >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}
}  // namespace

extern "C" void msr3d_resample_rows(const uint8_t* src, int64_t row,
                                    const int64_t* first, const int64_t* taps,
                                    const int32_t* weights, int64_t n_out, int64_t ksize,
                                    uint8_t* out) {
  std::vector<int32_t> acc(row);
  for (int64_t i = 0; i < n_out; ++i) {
    for (int64_t j = 0; j < row; ++j) acc[j] = 1 << (kPrecisionBits - 1);
    for (int64_t x = 0; x < taps[i]; ++x) {
      const uint8_t* in = src + (first[i] + x) * row;
      const int32_t w = weights[i * ksize + x];
      for (int64_t j = 0; j < row; ++j) acc[j] += in[j] * w;
    }
    uint8_t* o = out + i * row;
    for (int64_t j = 0; j < row; ++j) o[j] = clip8(acc[j]);
  }
}

extern "C" void msr3d_resample_cols(const uint8_t* src, int64_t rows, int64_t cols_in,
                                    const int64_t* first, const int64_t* taps,
                                    const int32_t* weights, int64_t n_out, int64_t ksize,
                                    uint8_t* out) {
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* in = src + y * cols_in * 3;
    uint8_t* o = out + y * n_out * 3;
    for (int64_t i = 0; i < n_out; ++i) {
      const int32_t* w = weights + i * ksize;
      const uint8_t* px = in + first[i] * 3;
      int32_t r = 1 << (kPrecisionBits - 1), g = r, b = r;
      for (int64_t x = 0; x < taps[i]; ++x) {
        r += px[3 * x] * w[x];
        g += px[3 * x + 1] * w[x];
        b += px[3 * x + 2] * w[x];
      }
      o[3 * i] = clip8(r);
      o[3 * i + 1] = clip8(g);
      o[3 * i + 2] = clip8(b);
    }
  }
}
