// Baseline JPEG decoder whose output is bit-equal to libjpeg-turbo 3.1 as
// Pillow drives it (`Image.open(p).convert("RGB")`): default decompression
// parameters, so the accurate integer IDCT (`jpeg_idct_islow`), fancy
// chroma upsampling and the table-driven YCbCr -> RGB conversion.
//
// Decodes sequential Huffman-coded frames (SOF0, SOF1) of 8-bit samples
// with 1 component (grayscale, replicated to RGB) or 3 components (YCbCr)
// subsampled 4:4:4, 4:2:2 or 4:2:0, in one scan; restart intervals.
// Everything else is refused with a reason: progressive, lossless,
// hierarchical and arithmetic-coded frames, 12-bit samples, 4 components,
// RGB-transformed colour, other subsamplings, a frame split into one scan per
// component, and entropy data that ends early or is corrupt. Integer
// arithmetic only.
//
// C interface (bound with ctypes by msr3d_tpu_torch/data/jpeg.py):
//   msr3d_jpeg_dims(buf, n, &height, &width, err, errlen)
//   msr3d_jpeg_decode(buf, n, out, height, width, err, errlen)
// Both return 0, or 1 with a message in err. `out` is (height, width, 3)
// uint8, C order, with the sizes msr3d_jpeg_dims gave.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// zigzag position -> natural (row-major) position
const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------------------
// Huffman tables (jdhuff.c's derived tables: a 9-bit lookahead, then the
// canonical maxcode search)

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t values[256] = {};
  int32_t maxcode[17] = {};   // largest code of each length, -1 if none
  int32_t valoffset[17] = {};  // values index of a code = code + valoffset[l]
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value, 0 = slow path

  void build(const uint8_t counts[17], const uint8_t* vals, int nvals) {
    std::memcpy(values, vals, nvals);
    int code = 0, k = 0;
    uint16_t huffcode[256];
    uint8_t huffsize[256];
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < counts[l]; ++i) huffsize[k++] = static_cast<uint8_t>(l);
    k = 0;
    int si = nvals ? huffsize[0] : 0;
    while (k < nvals) {
      while (k < nvals && huffsize[k] == si) huffcode[k++] = static_cast<uint16_t>(code++);
      // an over-full code space: a code no longer fits in si bits
      if (code >= (1 << si)) fail("bad Huffman table (over-full code space)");
      code <<= 1;
      ++si;
    }
    k = 0;
    for (int l = 1; l <= 16; ++l) {
      if (counts[l]) {
        valoffset[l] = k - huffcode[k];
        k += counts[l];
        maxcode[l] = huffcode[k - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    std::memset(look, 0, sizeof(look));
    k = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < counts[l]; ++i, ++k) {
        int prefix = huffcode[k] << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); ++j)
          look[prefix + j] = static_cast<uint16_t>((l << 8) | values[k]);
      }
    }
    defined = true;
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded segment reader. At a marker or at the end of the buffer it
// feeds zero bits, as libjpeg does, but counts them: a decode that consumed
// any of them read past its data and is refused.

struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;
  int nbits = 0;
  int fake = 0;       // zero bits appended past the data (at the low end of acc)
  bool stopped = false;  // at a marker or the end of the buffer

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!stopped) {
        if (p >= end) {
          stopped = true;
        } else if (*p != 0xFF) {
          byte = *p++;
        } else if (p + 1 < end && p[1] == 0x00) {
          byte = 0xFF;
          p += 2;
        } else {
          stopped = true;  // a marker (or fill bytes before one), left unread
        }
      }
      if (stopped) fake += 8;
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>(acc >> (64 - n));
  }

  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }

  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }

  bool overrun() const { return nbits < fake; }

  void reset() {
    acc = 0;
    nbits = 0;
    fake = 0;
    stopped = false;
  }
};

inline int decode_huffman(BitReader& br, const Huffman& h) {
  int look = br.peek(kLookBits);
  int entry = h.look[look];
  if (entry) {
    br.skip(entry >> 8);
    return entry & 0xFF;
  }
  int code = br.peek(16);
  int l = kLookBits + 1;
  int c = code >> (16 - l);
  while (c > h.maxcode[l]) {
    ++l;
    if (l > 16) fail("corrupt entropy data (no Huffman code matches)");
    c = code >> (16 - l);
  }
  br.skip(l);
  return h.values[c + h.valoffset[l]];
}

// HUFF_EXTEND of jdhuff.c
inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v; }

// ---------------------------------------------------------------------------
// jidctint.c's jpeg_idct_islow with libjpeg's range-limit table

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// jdmaster.c's prepare_range_limit_table: sample_range_limit, and the
// post-IDCT table at its CENTERJSAMPLE offset (indexed by x & 1023)
struct RangeLimit {
  uint8_t table[5 * 256 + 128];
  const uint8_t* sample;  // valid for -256 .. 511
  const uint8_t* idct;    // index (x & 1023)
  RangeLimit() {
    uint8_t* t = table + 256;
    std::memset(table, 0, 256);
    for (int i = 0; i <= 255; ++i) t[i] = static_cast<uint8_t>(i);
    sample = t;
    t += 128;
    for (int i = 128; i < 512; ++i) t[i] = 255;
    std::memset(t + 512, 0, 512 - 128);
    std::memcpy(t + 1024 - 128, sample, 128);
    idct = t;
  }
};

const RangeLimit& range_limit() {
  static const RangeLimit r;
  return r;
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  const uint8_t* rl = range_limit().idct;
  int32_t ws[64];
  // pass 1: columns, into the work array scaled up by 2^PASS1_BITS
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int32_t dc = (static_cast<int32_t>(in[0]) * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int32_t>(in[16]) * q[16];
    int64_t z3 = static_cast<int32_t>(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int32_t>(in[0]) * q[0];
    z3 = static_cast<int32_t>(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = static_cast<int32_t>(in[56]) * q[56];
    tmp1 = static_cast<int32_t>(in[40]) * q[40];
    tmp2 = static_cast<int32_t>(in[24]) * q[24];
    tmp3 = static_cast<int32_t>(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    constexpr int s = kConstBits - kPass1Bits;
    w[0] = static_cast<int32_t>(descale(tmp10 + tmp3, s));
    w[56] = static_cast<int32_t>(descale(tmp10 - tmp3, s));
    w[8] = static_cast<int32_t>(descale(tmp11 + tmp2, s));
    w[48] = static_cast<int32_t>(descale(tmp11 - tmp2, s));
    w[16] = static_cast<int32_t>(descale(tmp12 + tmp1, s));
    w[40] = static_cast<int32_t>(descale(tmp12 - tmp1, s));
    w[24] = static_cast<int32_t>(descale(tmp13 + tmp0, s));
    w[32] = static_cast<int32_t>(descale(tmp13 - tmp0, s));
  }
  // pass 2: rows, descaled by 2^3 and the PASS1_BITS scaling, range-limited
  constexpr int s = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + static_cast<int64_t>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = rl[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    o[0] = rl[static_cast<int>(descale(tmp10 + tmp3, s)) & 1023];
    o[7] = rl[static_cast<int>(descale(tmp10 - tmp3, s)) & 1023];
    o[1] = rl[static_cast<int>(descale(tmp11 + tmp2, s)) & 1023];
    o[6] = rl[static_cast<int>(descale(tmp11 - tmp2, s)) & 1023];
    o[2] = rl[static_cast<int>(descale(tmp12 + tmp1, s)) & 1023];
    o[5] = rl[static_cast<int>(descale(tmp12 - tmp1, s)) & 1023];
    o[3] = rl[static_cast<int>(descale(tmp13 + tmp0, s)) & 1023];
    o[4] = rl[static_cast<int>(descale(tmp13 - tmp0, s)) & 1023];
  }
}

// ---------------------------------------------------------------------------
// The frame

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // Huffman tables of the current scan
  int dw = 0, dh = 0;       // downsampled size: ceil(size * factor / max)
  int stride = 0, rows = 0;  // the plane, padded to whole MCUs
  std::vector<uint8_t> plane;
  int pred = 0;
};

struct Decoder {
  const uint8_t* end;
  const uint8_t* p;

  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool frame = false, scanned = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;

  Decoder(const uint8_t* b, int64_t n) : end(b + n), p(b) {}

  int byte() {
    if (p >= end) fail("truncated file (the data ends inside a marker segment)");
    return *p++;
  }

  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // the next marker code: fill bytes (0xFF runs) are skipped, and so is
  // stray data between segments, as libjpeg's next_marker does
  int next_marker() {
    for (;;) {
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) return -1;
      int m = *p++;
      if (m != 0) return m;
    }
  }

  // a marker segment's payload [start, start + len - 2)
  const uint8_t* segment(int* len) {
    int n = word();
    if (n < 2 || end - p < n - 2) fail("truncated file (a marker segment runs past the end)");
    *len = n - 2;
    const uint8_t* s = p;
    p += n - 2;
    return s;
  }

  void read_dqt() {
    int len;
    const uint8_t* s = segment(&len);
    const uint8_t* e = s + len;
    while (s < e) {
      int pq = *s >> 4, tq = *s & 15;
      ++s;
      if (tq > 3 || pq > 1) fail("bad DQT segment");
      if (e - s < (pq ? 128 : 64)) fail("bad DQT segment length");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (s[2 * k] << 8) | s[2 * k + 1] : s[k];
        quant[tq][kNaturalOrder[k]] = static_cast<uint16_t>(v);
      }
      s += pq ? 128 : 64;
      quant_defined[tq] = true;
    }
  }

  void read_dht() {
    int len;
    const uint8_t* s = segment(&len);
    const uint8_t* e = s + len;
    while (s < e) {
      if (e - s < 17) fail("bad DHT segment length");
      int tc = *s >> 4, th = *s & 15;
      ++s;
      if (tc > 1 || th > 3) fail("bad DHT segment");
      uint8_t counts[17] = {};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = *s++;
      if (total > 256 || e - s < total) fail("bad DHT segment length");
      (tc ? ac[th] : dc[th]).build(counts, s, total);
      s += total;
    }
  }

  void read_sof() {
    if (frame) fail("more than one frame header");
    int len;
    const uint8_t* s = segment(&len);
    if (len < 6) fail("bad SOF segment length");
    int precision = s[0];
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    int nf = s[5];
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples are not supported (8-bit only)");
    if (height == 0) fail("a frame whose height comes in a DNL marker is not supported");
    if (width == 0) fail("bad frame size (width 0)");
    if (nf == 4) fail("4-component (CMYK/YCCK) JPEGs are not supported");
    if (nf != 1 && nf != 3) fail(std::to_string(nf) + "-component JPEGs are not supported");
    if (len != 6 + 3 * nf) fail("bad SOF segment length");
    comps.resize(nf);
    for (int i = 0; i < nf; ++i) {
      Component& c = comps[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component in the frame header");
    }
    if (nf == 1) {
      comps[0].h = comps[0].v = 1;  // one component: its MCU is one block
    } else {
      const Component &y = comps[0], &cb = comps[1], &cr = comps[2];
      bool luma_ok = (y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) || (y.h == 2 && y.v == 2);
      if (!luma_ok || cb.h != 1 || cb.v != 1 || cr.h != 1 || cr.v != 1) {
        char buf[96];
        std::snprintf(buf, sizeof(buf),
                      "chroma subsampling %dx%d,%dx%d,%dx%d is not supported "
                      "(4:4:4, 4:2:2 and 4:2:0 only)",
                      y.h, y.v, cb.h, cb.v, cr.h, cr.v);
        fail(buf);
      }
    }
    hmax = vmax = 1;
    for (const Component& c : comps) {
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
      c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
    }
    frame = true;
  }

  void read_app(int marker) {
    int len;
    const uint8_t* s = segment(&len);
    if (marker == 0xE0 && len >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = s[11];
    }
  }

  // the colour space libjpeg's default_decompress_parms infers
  void check_colour() {
    if (comps.size() != 3) return;
    if (jfif) return;
    if (adobe) {
      if (adobe_transform != 1)
        fail("Adobe APP14 transform " + std::to_string(adobe_transform) +
             " (not YCbCr) is not supported");
      return;
    }
    if (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B')
      fail("RGB-coded JPEGs (component ids R, G, B) are not supported");
  }

  void decode_block(BitReader& br, Component& c, int brow, int bcol) {
    int16_t coef[64] = {};
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = decode_huffman(br, hd);
    if (s > 15) fail("corrupt entropy data (bad DC category)");
    int diff = s ? extend(br.get(s), s) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = decode_huffman(br, ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt entropy data (coefficient run past the block)");
        coef[kNaturalOrder[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, quant[c.tq],
               c.plane.data() + static_cast<int64_t>(brow) * 8 * c.stride + bcol * 8, c.stride);
  }

  void expect_restart(BitReader& br, int* next_rst) {
    if (br.overrun()) fail("corrupt entropy data (a restart interval ran past its data)");
    p = br.p;
    int m = next_marker();
    if (m != 0xD0 + *next_rst)
      fail(m < 0 ? "truncated file (the data ends before a restart marker)"
                 : "corrupt entropy data (missing or misordered restart marker)");
    *next_rst = (*next_rst + 1) & 7;
    br.reset();
    br.p = p;
    for (Component& c : comps) c.pred = 0;
  }

  void read_scan() {
    if (!frame) fail("a scan before the frame header");
    check_colour();
    int len;
    const uint8_t* s = segment(&len);
    int ns = len ? s[0] : 0;
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail("bad SOS segment");
    if (ns != static_cast<int>(comps.size()))
      fail("a sequential frame in one scan per component is not supported "
           "(one interleaved scan only)");
    for (int i = 0; i < ns; ++i) {
      Component& c = comps[i];
      int tables = s[2 + 2 * i];
      if (s[1 + 2 * i] != c.id) fail("the scan's components differ from the frame's");
      c.td = tables >> 4;
      c.ta = tables & 15;
      if (c.td > 3 || c.ta > 3 || !dc[c.td].defined || !ac[c.ta].defined)
        fail("a scan uses an undefined Huffman table");
      if (!quant_defined[c.tq]) fail("a component uses an undefined quantization table");
      c.pred = 0;
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahl = s[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahl != 0) fail("bad spectral selection for a sequential scan");

    BitReader br;
    br.p = p;
    br.end = end;
    int next_rst = 0, left = restart_interval;
    auto mcu_done = [&](bool last) {
      if (br.overrun())
        fail(br.p >= end ? "image file is truncated (entropy data ends early)"
                         : "corrupt entropy data (a marker inside the scan's data)");
      if (restart_interval && !last && --left == 0) {
        expect_restart(br, &next_rst);
        left = restart_interval;
      }
    };
    // one component (h = v = 1): an MCU is a block, so this loop is also the
    // non-interleaved order
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        for (Component& c : comps)
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) decode_block(br, c, my * c.v + v, mx * c.h + h);
        mcu_done(my == mcuy - 1 && mx == mcux - 1);
      }
    p = br.p;
    scanned = true;
  }

  void read_headers_to_frame() {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    p += 2;
    for (;;) {
      int m = next_marker();
      if (m < 0) fail("truncated file (no frame header)");
      if (handle_marker(m)) return;
    }
  }

  // true once the frame header has been read
  bool handle_marker(int m) {
    switch (m) {
      case 0xC0:
      case 0xC1:
        read_sof();
        return true;
      case 0xC2:
        fail("progressive JPEGs are not supported (baseline only)");
      case 0xC3:
        fail("lossless JPEGs are not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        fail("hierarchical JPEGs are not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
      case 0xCC:
        fail("arithmetic-coded JPEGs are not supported");
      case 0xC4:
        read_dht();
        return false;
      case 0xDB:
        read_dqt();
        return false;
      case 0xDD: {
        int len;
        const uint8_t* s = segment(&len);
        if (len != 2) fail("bad DRI segment");
        restart_interval = (s[0] << 8) | s[1];
        return false;
      }
      case 0xD8:
        fail("a second SOI marker");
      case 0xD9:
        fail("truncated file (EOI before the frame header)");
      case 0xDA:
        fail("a scan before the frame header");
      case 0xDC:
        fail("DNL markers are not supported");
      case 0x01:
      case 0xD0:
      case 0xD1:
      case 0xD2:
      case 0xD3:
      case 0xD4:
      case 0xD5:
      case 0xD6:
      case 0xD7:
        return false;  // parameterless; libjpeg skips them here too
      default:
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
          read_app(m);
          return false;
        }
        char buf[40];
        std::snprintf(buf, sizeof(buf), "unsupported marker 0xFF%02X", m);
        fail(buf);
    }
  }

  void read_scans() {
    for (;;) {
      int m = next_marker();
      if (m < 0) fail("image file is truncated (no EOI marker)");
      if (m == 0xD9) {
        if (!scanned) fail("image file is truncated (EOI before the scan)");
        return;
      }
      if (m == 0xDA) {
        if (scanned) fail("a second scan in a sequential frame");
        read_scan();
      } else if (m == 0xC0 || m == 0xC1) {
        fail("more than one frame header");
      } else {
        handle_marker(m);
      }
    }
  }

  // fancy upsampling (jdsample.c) of one output row of a chroma plane;
  // `sums` holds dw ints
  void upsample_row(const Component& c, int row, uint8_t* out, int* sums) const {
    const int rh = vmax / c.v, cw = hmax / c.h;  // 1 or 2 each
    const int dw = c.dw;
    const uint8_t* in0 = c.plane.data() + static_cast<int64_t>(row / rh) * c.stride;
    if (cw == 1) {  // fullsize
      std::memcpy(out, in0, width);
      return;
    }
    if (dw <= 2) {  // h2v1_upsample / h2v2_upsample: replication
      for (int x = 0; x < width; ++x) out[x] = in0[x >> 1];
      return;
    }
    // h2v1_fancy_upsample: 3/4 nearer + 1/4 further, biases 1 and 2, the
    // edge pixels repeated. h2v2_fancy_upsample: the same over column sums
    // of 3/4 nearer row + 1/4 further row (9/16, 3/16, 3/16, 1/16), biases
    // 8 and 7; the rows above the top and below the bottom repeat the edge
    // rows
    int shift = 2, even = 1, odd = 2;
    if (rh == 1) {
      for (int k = 0; k < dw; ++k) sums[k] = in0[k];
    } else {
      int i = row >> 1;
      int j = (row & 1) ? (i + 1 < c.dh ? i + 1 : i) : (i > 0 ? i - 1 : 0);
      const uint8_t* in1 = c.plane.data() + static_cast<int64_t>(j) * c.stride;
      for (int k = 0; k < dw; ++k) sums[k] = in0[k] * 3 + in1[k];
      shift = 4, even = 8, odd = 7;
    }
    // output 2k blends column k with k - 1, output 2k + 1 with k + 1
    auto blend = [&](int here, int there, int bias) {
      return static_cast<uint8_t>((here * 3 + there + bias) >> shift);
    };
    uint8_t tail[2];
    uint8_t* last = 2 * dw > width ? tail : out + 2 * (dw - 1);  // odd widths end early
    out[0] = blend(sums[0], sums[0], even);
    out[1] = blend(sums[0], sums[1], odd);
    for (int k = 1; k < dw - 1; ++k) {
      out[2 * k] = blend(sums[k], sums[k - 1], even);
      out[2 * k + 1] = blend(sums[k], sums[k + 1], odd);
    }
    last[0] = blend(sums[dw - 1], sums[dw - 2], even);
    last[1] = blend(sums[dw - 1], sums[dw - 1], odd);
    if (last == tail) out[2 * (dw - 1)] = tail[0];
  }

  void convert(uint8_t* out) const {
    const uint8_t* rl = range_limit().sample;
    if (comps.size() == 1) {
      const Component& g = comps[0];
      for (int y = 0; y < height; ++y) {
        const uint8_t* in = g.plane.data() + static_cast<int64_t>(y) * g.stride;
        uint8_t* o = out + static_cast<int64_t>(y) * width * 3;
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
      }
      return;
    }
    // jdcolor.c's build_ycc_rgb_table: SCALEBITS 16, ONE_HALF folded into Cb->G
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    std::vector<uint8_t> cb(width), cr(width);
    std::vector<int> sums(width);
    const Component& yc = comps[0];
    for (int y = 0; y < height; ++y) {
      const uint8_t* yr = yc.plane.data() + static_cast<int64_t>(y) * yc.stride;
      upsample_row(comps[1], y, cb.data(), sums.data());
      upsample_row(comps[2], y, cr.data(), sums.data());
      uint8_t* o = out + static_cast<int64_t>(y) * width * 3;
      for (int x = 0; x < width; ++x) {
        int l = yr[x], b = cb[x], r = cr[x];
        o[3 * x] = rl[l + cr_r[r]];
        o[3 * x + 1] = rl[l + static_cast<int>((cb_g[b] + cr_g[r]) >> kScale)];
        o[3 * x + 2] = rl[l + cb_b[b]];
      }
    }
  }
};

int report(const JpegError& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.msg.c_str());
  return 1;
}

}  // namespace

extern "C" {

int msr3d_jpeg_dims(const uint8_t* buf, int64_t n, int32_t* height, int32_t* width, char* err,
                    int errlen) {
  try {
    Decoder d(buf, n);
    d.read_headers_to_frame();
    *height = d.height;
    *width = d.width;
    return 0;
  } catch (const JpegError& e) {
    return report(e, err, errlen);
  }
}

int msr3d_jpeg_decode(const uint8_t* buf, int64_t n, uint8_t* out, int32_t height, int32_t width,
                      char* err, int errlen) {
  try {
    Decoder d(buf, n);
    d.read_headers_to_frame();
    if (d.height != height || d.width != width) fail("output size differs from the frame's");
    d.read_scans();
    d.convert(out);
    return 0;
  } catch (const JpegError& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
