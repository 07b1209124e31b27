// The two serial row filters of PNG (ISO/IEC 15948, section 9.2): Average
// (type 3) and Paeth (type 4). Each byte's prediction reads the byte one
// pixel to its left after that byte has been reconstructed, so a row is
// undone left to right. The filters None, Sub and Up are undone in numpy by
// msr3d_tpu_torch/data/png.py, which reads the chunks, checks their CRCs
// and inflates the image data.
//
// C interface (bound with ctypes by msr3d_tpu_torch/data/png.py):
//   msr3d_png_unfilter_row(filter, row, prior, n, bpp) -> 0, or -1 for a
//     filter type other than 3 and 4
//     row (n bytes) holds the filtered bytes of one scanline and is
//     reconstructed in place; prior (n bytes) is the reconstructed scanline
//     above it (zeros for the first); bpp is the bytes a pixel (3 or 4).

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" int msr3d_png_unfilter_row(int32_t filter, uint8_t* row, const uint8_t* prior,
                                      int64_t n, int64_t bpp) {
  if (filter == 3) {
    for (int64_t x = 0; x < n; ++x) {
      const int left = x >= bpp ? row[x - bpp] : 0;
      row[x] = static_cast<uint8_t>(row[x] + ((left + prior[x]) >> 1));
    }
    return 0;
  }
  if (filter == 4) {
    for (int64_t x = 0; x < n; ++x) {
      const int left = x >= bpp ? row[x - bpp] : 0;
      const int up_left = x >= bpp ? prior[x - bpp] : 0;
      row[x] = static_cast<uint8_t>(row[x] + paeth(left, prior[x], up_left));
    }
    return 0;
  }
  return -1;
}
