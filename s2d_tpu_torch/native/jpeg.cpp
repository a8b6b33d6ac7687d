// A JPEG codec of the port's own (C ABI, loaded via ctypes by
// s2d_tpu_torch/native/__init__.py): the card's machine has neither cv2 nor
// PIL, and every registered dataset (YTVIS JPEGImages, COCO, ImageNet, VOC,
// UVO) is JPEG.
//
// The decoder returns what cv2.imread(path, IMREAD_COLOR)[..., ::-1] returns,
// byte for byte, by following libjpeg-turbo 3's default decompression:
//   - baseline and extended sequential (SOF0/SOF1, SOF9) and progressive
//     (SOF2, SOF10) files, Huffman or arithmetic coded (jdarith.c's QM
//     decoder, its DAC conditioning), 8-bit samples, 1, 3 or 4 components,
//     any integral sampling ratio (blocks in an MCU up to 10), restart
//     intervals, byte stuffing and fill bytes;
//   - lossless Huffman files (SOF3) of 8-bit samples, 3 or 4 components
//     sampled 1x1: the 7 predictors and the point transform of jdlossls.c;
//   - the integer "islow" IDCT of jidctint.c, as libjpeg-turbo's AVX2 code
//     (what cv2 runs on x86-64) computes it, down to its 16-bit wraps and
//     saturations on damaged data;
//   - jdcoefct.c's block smoothing of a progressive file whose first 10
//     coefficients are not all known to their last bit (a file cut before
//     its last scans): each iMCU row with the coefficient bits of the scan
//     that last reached it, the 5x5 DC window for the AC estimates, and the
//     DC itself re-estimated where no AC scan ran yet;
//   - fancy upsampling (jdsample.c: the h2v1, h2v2 and h1v2 triangle
//     filters), run over whole component planes with their first and last
//     rows and columns repeated, as jdmainct.c's context rows repeat them;
//     box replication for a plane 2 samples wide or less, and for every
//     other ratio (int_upsample), as libjpeg-turbo does there;
//   - the fixed-point YCbCr -> RGB of jdcolor.c; an Adobe APP14 transform 0,
//     or component ids 'R', 'G', 'B' without a JFIF marker, is RGB; grey is
//     replicated to 3 channels; 4 components are CMYK (Adobe transform 0 or
//     no Adobe marker) or YCCK (jdcolor.c's ycck_cmyk_convert), and CMYK
//     goes to RGB as OpenCV's icvCvt_CMYK2BGR_8u_C4C3R does.
// The EXIF orientation (the first APP1 segment, as cv2 reads it) is
// returned by s2d_jpeg_header; the caller applies it.
//
// Refused, with a reason (status 1, ValueError in Python), where cv2 returns
// no image either: hierarchical (SOF5-7, SOF13-15) and arithmetic lossless
// (SOF11) files, a height set by a DNL marker, 12- and 16-bit samples, 2
// components, grey or subsampled lossless files, fractional sampling ratios.
//
// Damaged data reads as libjpeg reads it, where cv2.imread still returns an
// image (with a warning): a scan whose data ends early (a cut file, a stray
// marker) decodes its current block on zero bits and leaves the rest of the
// scan as it was (zero coefficients in a first scan) up to a restart marker
// it finds; a missing or out-of-order restart marker goes through
// jpeg_resync_to_restart's rules; a code no Huffman table holds takes 17
// bits and reads as symbol 0; a component no scan holds is mid-grey.
// Raised as damaged (status 2, OSError): what stops libjpeg with an error (a
// file cut in its headers, an unknown marker, a bad table).
//
// The encoder writes baseline files: Annex K quantization tables scaled as
// libjpeg's jpeg_quality_scaling, the Annex K Huffman tables, libjpeg's
// fixed-point RGB -> YCbCr, its box downsampling and islow forward DCT;
// 4:4:4, 4:2:2, 4:2:0 or grey.
//
// Build: g++ -O3 -shared -fPIC at first use, into build/s2d_tpu_torch/.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  int status;  // 1 refused, 2 damaged
  std::string reason;
};

[[noreturn]] void refuse(const std::string& why) { throw Failure{1, why}; }
[[noreturn]] void damaged(const std::string& why) { throw Failure{2, why}; }

// jpeg_natural_order: zigzag index -> natural (row-major) index; 16 extra
// entries so that a corrupt run past 63 lands on 63, as in libjpeg
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t counts[16];
  uint8_t vals[256];
  uint8_t look_len[1 << kLookBits];
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];

  void load(const uint8_t* c, const uint8_t* symbols, int total) {
    std::memcpy(counts, c, 16);
    std::memcpy(vals, symbols, total);
    defined = true;
  }
  // the decoding tables, checked as jpeg_make_d_derived_tbl checks them when
  // a scan starts to use the table: no all-ones code, DC symbols <= 15 (16
  // in a lossless file)
  void prepare(bool dc, int max_dc = 15) {
    std::memset(look_len, 0, sizeof(look_len));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (dc && vals[k] > max_dc) damaged("a DC Huffman table with a symbol too large");
        if (l <= kLookBits) {
          const int shift = kLookBits - l;
          for (int e = 0; e < (1 << shift); ++e) {
            look_len[(code << shift) | e] = (uint8_t)l;
            look_sym[(code << shift) | e] = vals[k];
          }
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (counts[l - 1] && code >= (1 << l)) damaged("a Huffman table whose codes do not fit");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
  }
};

// Entropy-coded data: bytes with 0xFF 0x00 stuffing, until a marker. Past a
// marker (or the end of the file) the reader hands out zero bits and counts
// them; a decode that consumed any of them read past its data.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;        // bits in acc, from the top
  int pad = 0;      // of them, zero bits appended past the data
  bool stopped = false;  // reached a marker or the end of the file

  void fill() {
    while (n <= 56) {
      uint32_t byte = 0;
      if (stopped) {
        pad += 8;
      } else if (p >= end) {
        stopped = true;
        pad += 8;
      } else if (*p != 0xFF) {
        byte = *p++;
      } else {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) ++q;  // fill bytes
        if (q < end && *q == 0x00) {
          byte = 0xFF;
          p = q + 1;
        } else {
          stopped = true;  // p stays on the marker's last 0xFF
          p = q - 1;
          pad += 8;
        }
      }
      acc |= (uint64_t)byte << (56 - n);
      n += 8;
    }
  }
  int bits(int s) {  // 0 < s <= 16
    if (n < s) fill();
    const int v = (int)(acc >> (64 - s));
    acc <<= s;
    n -= s;
    return v;
  }
  int bit() { return bits(1); }
  int decode(const HuffTable& t) {
    if (n < 17) fill();
    const int look = (int)(acc >> (64 - kLookBits));
    const int len = t.look_len[look];
    if (len) {
      acc <<= len;
      n -= len;
      return t.look_sym[look];
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int code = (int)(acc >> (64 - l));
      if (code <= t.maxcode[l]) {
        acc <<= l;
        n -= l;
        return t.vals[t.valoffset[l] + code];
      }
    }
    // no code of 16 bits or fewer: libjpeg takes 17 bits and the symbol 0
    acc <<= 17;
    n -= 17;
    return 0;
  }
  bool overran() const { return n < pad; }
  // drop the bits left in the buffer (libjpeg's byte alignment at a
  // restart or the end of a scan); p is where the data stopped
  void reset() {
    acc = 0;
    n = 0;
    pad = 0;
    stopped = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------ arithmetic coding

// jaricom.c's jpeg_aritab (Table D.2 of T.81): Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
const int32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

// jdarith.c's arith_decode over entropy-coded bytes; past a marker (or the
// end of the file) it reads zero bytes, as libjpeg does after it meets one
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: 2 bytes to read first; -1: a bad code stopped the scan
  bool marker = false;

  int get() {
    if (marker) return 0;
    if (p >= end) {
      marker = true;
      return 0;
    }
    const int d = *p++;
    if (d != 0xFF) return d;
    const uint8_t* q = p;
    while (q < end && *q == 0xFF) ++q;
    if (q < end && *q == 0x00) {
      p = q + 1;
      return 0xFF;
    }
    marker = true;  // p stays on the marker's last 0xFF
    p = q - 1;
    return 0;
  }
  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | get();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// ----------------------------------------------------------- the decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks in the padded (MCU-grid) plane
  int wblocks = 0, hblocks = 0;  // blocks that hold image samples
  int dw = 0, dh = 0;          // downsampled size in samples
  bool latched = false;
  int16_t quant[64] = {};          // zero until latched: an unseen component is mid-grey
  // progressive: the bit position each coefficient (zigzag order) is known
  // to, and before the last scan that held this component (jdphuff.c)
  int coef_bits[64], prev_coef_bits[64];
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint16_t> samples;  // lossless: dw * dh undifferenced samples
  int dc_table = 0, ac_table = 0;
  int last_dc = 0, dc_context = 0;
};

constexpr int kSavedCoefs = 10;  // jdcoefct.c's SAVED_COEFS

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  bool progressive = false, arithmetic = false, lossless = false;
  bool have_frame = false, have_scan = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool saw_app1 = false;
  int restart_interval = 0;
  Component comp[4];
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int eobrun = 0;
  // arithmetic conditioning (DAC; SOI's defaults) and statistics bins
  uint8_t arith_dc_l[16], arith_dc_u[16], arith_ac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  int scans = 0;           // input_scan_number
  int last_good_row = 0;   // jdmaster's last_good_iMCU_row
  int point_transform = 0;  // lossless: the last scan's Al
  std::vector<uint8_t> padded;  // the file and what libjpeg reads past its end

  Decoder(const uint8_t* d, size_t s) : data(d), size(s) {
    std::fill(arith_dc_l, arith_dc_l + 16, 0);
    std::fill(arith_dc_u, arith_dc_u + 16, 1);
    std::fill(arith_ac_k, arith_ac_k + 16, 5);
  }

  int u8() {
    if (pos >= size) damaged("the file ends inside a marker segment");
    return data[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  // the next marker code, skipping any bytes that are not one (libjpeg's
  // next_marker); -1 at the end of the file
  int next_marker() {
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      if (pos >= size) return -1;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) return -1;
      const int c = data[pos++];
      if (c != 0) return c;
    }
  }

  void read_exif(const uint8_t* seg, size_t len) {
    // cv2: the first APP1 segment, its TIFF header 6 bytes in, IFD0's 0x0112
    if (len <= 6) return;
    const uint8_t* t = seg + 6;
    const size_t tl = len - 6;
    if (tl < 8) return;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto g16 = [&](size_t o) -> int {
      if (o + 2 > tl) return -1;
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto g32 = [&](size_t o) -> int64_t {
      if (o + 4 > tl) return -1;
      return le ? ((int64_t)t[o] | ((int64_t)t[o + 1] << 8) | ((int64_t)t[o + 2] << 16) |
                   ((int64_t)t[o + 3] << 24))
                : (((int64_t)t[o] << 24) | ((int64_t)t[o + 1] << 16) |
                   ((int64_t)t[o + 2] << 8) | (int64_t)t[o + 3]);
    };
    if (g16(2) != 0x2A) return;
    const int64_t ifd = g32(4);
    if (ifd < 0) return;
    const int entries = g16((size_t)ifd);
    if (entries < 0) return;
    for (int e = 0; e < entries; ++e) {
      const size_t at = (size_t)ifd + 2 + 12 * (size_t)e;
      const int tag = g16(at);
      if (tag < 0) return;
      if (tag == 0x0112) {
        const int value = g16(at + 8);
        if (value < 0) return;
        orientation = value;
      }
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) damaged("a quantization table id past 3");
      for (int k = 0; k < 64; ++k) {
        const int v = pq ? u16() : u8();
        qtables[tq][kNatural[k]] = (uint16_t)v;
      }
      qdefined[tq] = true;
    }
    if (pos != end) damaged("a quantization table segment of the wrong length");
  }

  void read_dht(size_t end) {
    while (end - pos > 16) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (th > 3 || tc > 1) damaged("a Huffman table id past 3");
      uint8_t counts[16];
      int total = 0;
      for (int l = 0; l < 16; ++l) total += counts[l] = (uint8_t)u8();
      if (total > 256 || pos + total > end) damaged("a Huffman table longer than its segment");
      (tc ? ac[th] : dc[th]).load(counts, data + pos, total);
      pos += total;
    }
    if (pos != end) damaged("a Huffman table segment of the wrong length");
  }

  // jdmarker.c's get_dac
  void read_dac(size_t end) {
    while (pos < end) {
      const int index = u8(), val = u8();
      if (index >= 32) damaged("an arithmetic conditioning table id past 15");
      if (index >= 16) {
        arith_ac_k[index - 16] = (uint8_t)val;
      } else {
        arith_dc_l[index] = (uint8_t)(val & 15);
        arith_dc_u[index] = (uint8_t)(val >> 4);
        if (arith_dc_l[index] > arith_dc_u[index])
          damaged("an arithmetic DC conditioning range with L past U");
      }
    }
    if (pos != end) damaged("an arithmetic conditioning segment of the wrong length");
  }

  void read_sof(int marker, size_t end) {
    if (have_frame) damaged("a second frame header");
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker >= 0xC9;
    lossless = marker == 0xC3;
    const int precision = u8();
    if (precision != 8) refuse(std::to_string(precision) + "-bit samples (only 8-bit is read)");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) refuse("a height defined by a DNL marker");
    if (width == 0) damaged("a frame of width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) refuse(std::to_string(ncomp) + " components");
    if (lossless && ncomp == 1) refuse("a grey lossless file");
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = u8();
      const int hv = u8();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = u8();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4)
        damaged("a sampling factor outside 1..4");
      if (comp[c].tq > 3) damaged("a quantization table id past 3");
      hmax = std::max(hmax, comp[c].h);
      vmax = std::max(vmax, comp[c].v);
    }
    if (pos != end) damaged("a frame header of the wrong length");
    for (int c = 0; c < ncomp; ++c) {
      if (hmax % comp[c].h || vmax % comp[c].v)
        refuse("sampling factors " + std::to_string(comp[c].h) + "x" +
               std::to_string(comp[c].v) + " against " + std::to_string(hmax) + "x" +
               std::to_string(vmax) + " (a fractional ratio)");
    }
    if (lossless && (hmax > 1 || vmax > 1)) refuse("a lossless file with subsampled components");
    const int unit = lossless ? 1 : 8;  // a lossless data unit is one sample
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    if ((int64_t)mcux * mcuy * hmax * vmax * 64 * ncomp > ((int64_t)1 << 31))
      refuse("an image of more than 2^31 samples");
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
      if (lossless) {
        k.samples.assign((size_t)k.dw * k.dh, 0);
        continue;
      }
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.wblocks = (k.dw + 7) / 8;
      k.hblocks = (k.dh + 7) / 8;
      k.coef.assign((size_t)k.bw * k.bh * 64, 0);
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
      std::fill(k.prev_coef_bits, k.prev_coef_bits + 64, -1);
    }
    have_frame = true;
  }

  // the file followed by the fake EOI markers (0xFF 0xD9, over and over)
  // that libjpeg's source managers hand out past its end, to `need` bytes
  void extend_past_end(size_t need) {
    if (need <= size) return;
    if (padded.empty()) padded.assign(data, data + size);
    while (padded.size() < need) {
      padded.push_back(0xFF);
      padded.push_back(0xD9);
    }
    data = padded.data();
    size = padded.size();
  }

  // the segments up to the first scan (header) or the end of the file,
  // decoding each scan
  void parse(bool header) {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) damaged("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m < 0) {
        if (header) damaged("the file ends before its first scan");
        return;  // no EOI: libjpeg's source manager inserts one here
      }
      if (m == 0xD9) {
        if (header) damaged("the image ends before its first scan");
        return;
      }
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // ignored, as libjpeg
      if (m == 0xD8) damaged("a second SOI marker");
      // markers libjpeg does not know stop it with an error
      if (m < 0xC0 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD))
        damaged("an unknown marker " + std::to_string(m));
      const size_t seg = pos;
      // libjpeg reads a segment that runs past the end of the file on
      // through the EOI markers its source manager inserts there, and fails
      // only where those bytes make the segment wrong (a scan header's last
      // bytes, a Huffman table's last values read as 0xFF 0xD9 may pass)
      extend_past_end(seg + 4);
      const int len = u16();
      if (len < 2) damaged("a marker segment shorter than its length field");
      if (seg + len > size) {
        // it skips an APPn or COM segment to the end of the file
        if (!header && ((m >= 0xE0 && m <= 0xEF) || m == 0xFE)) return;
        extend_past_end(seg + len + 2);
      }
      const size_t end = seg + len;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
        read_sof(m, end);
      } else if (m >= 0xC5 && m <= 0xC7) {
        refuse("a hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xCB) {
        refuse("an arithmetic-coded lossless JPEG (SOF11)");
      } else if (m >= 0xCD && m <= 0xCF) {
        refuse("a hierarchical arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xC8) {
        refuse("a JPG extension (SOF marker 0xC8)");
      } else if (m == 0xCC) {
        read_dac(end);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
        if (len != 4) damaged("a restart interval segment of the wrong length");
        restart_interval = u16();
      } else if (m == 0xE0) {
        if (len - 2 >= 14 && std::memcmp(data + seg + 2, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xE1) {
        if (!saw_app1 && !have_scan) read_exif(data + seg + 2, len - 2);
        saw_app1 = true;
      } else if (m == 0xEE) {
        if (len - 2 >= 12 && std::memcmp(data + seg + 2, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[seg + 2 + 11];
        }
      } else if (m == 0xDA) {
        if (!have_frame) damaged("a scan before the frame header");
        if (header) return;
        pos = end;  // scan() re-reads the segment
        const bool whole = scan(seg + 2, end) == ncomp;
        // a sequential file whose first scan holds every component is
        // decoded from that scan alone, and libjpeg reads what follows it
        // only after the image is out (cv2 returns the image whatever it
        // finds there)
        if (!progressive && !have_scan && whole) return;
        have_scan = true;
        continue;
      }
      pos = end;
    }
  }

  // -------------------------------------------------------------- scans

  int16_t* block(Component& k, int bx, int by) {
    return k.coef.data() + ((size_t)by * k.bw + bx) * 64;
  }

  void decode_baseline(BitReader& br, Component& k, int16_t* b) {
    const HuffTable& dt = dc[k.dc_table];
    const HuffTable& at = ac[k.ac_table];
    int s = br.decode(dt);
    int diff = 0;
    if (s) {
      if (s > 16) damaged("a DC difference of more than 16 bits");
      diff = extend(br.bits(s), s);
    }
    k.last_dc += diff;
    b[0] = (int16_t)k.last_dc;
    for (int i = 1; i < 64; ++i) {
      const int rs = br.decode(at);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        b[kNatural[i]] = (int16_t)extend(br.bits(s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void decode_dc_first(BitReader& br, Component& k, int16_t* b, int al) {
    int s = br.decode(dc[k.dc_table]);
    int diff = 0;
    if (s) {
      if (s > 16) damaged("a DC difference of more than 16 bits");
      diff = extend(br.bits(s), s);
    }
    k.last_dc += diff;
    b[0] = (int16_t)((unsigned)k.last_dc << al);
  }

  void decode_dc_refine(BitReader& br, int16_t* b, int al) {
    if (br.bit()) b[0] = (int16_t)(b[0] | (1 << al));
  }

  void decode_ac_first(BitReader& br, Component& k, int16_t* b, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const HuffTable& at = ac[k.ac_table];
    for (int i = ss; i <= se; ++i) {
      const int rs = br.decode(at);
      const int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        i += r;
        b[kNatural[i]] = (int16_t)((unsigned)extend(br.bits(s), s) << al);
      } else {
        if (r == 15) {
          i += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          --eobrun;
          break;
        }
      }
    }
  }

  void decode_ac_refine(BitReader& br, Component& k, int16_t* b, int ss, int se, int al) {
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun == 0) {
      const HuffTable& at = ac[k.ac_table];
      for (; i <= se; ++i) {
        const int rs = br.decode(at);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* c = b + kNatural[i];
          if (*c != 0) {
            if (br.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          } else {
            if (--r < 0) break;
          }
          ++i;
        } while (i <= se);
        if (s) b[kNatural[i]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = b + kNatural[i];
        if (*c != 0 && br.bit() && (*c & p1) == 0)
          *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  // jdarith.c: a DC difference (Figures F.19-F.24) into k.last_dc; false on
  // a magnitude overflow, which stops the scan (ct = -1)
  bool arith_dc(ArithReader& ar, Component& k) {
    const int tbl = k.dc_table;
    uint8_t* st = dc_stats[tbl] + k.dc_context;
    if (ar.decode(st) == 0) {
      k.dc_context = 0;
      return true;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < (int)((1L << arith_dc_l[tbl]) >> 1)) k.dc_context = 0;
    else if (m > (int)((1L << arith_dc_u[tbl]) >> 1)) k.dc_context = 12 + sign * 4;
    else k.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    k.last_dc = (k.last_dc + v) & 0xffff;
    return true;
  }

  // jdarith.c: AC coefficients ss..se of a block (Figure F.20)
  void arith_ac(ArithReader& ar, Component& k, int16_t* b, int ss, int se, int al) {
    const int tbl = k.ac_table;
    for (int i = ss; i <= se; ++i) {
      uint8_t* st = ac_stats[tbl] + 3 * (i - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++i > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
      const int sign = ar.decode(fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0) {
        if (ar.decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (i <= arith_ac_k[tbl] ? 189 : 217);
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) {
              ar.ct = -1;  // magnitude overflow
              return;
            }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      b[kNatural[i]] = (int16_t)((unsigned)v << al);
    }
  }

  void arith_ac_refine(ArithReader& ar, Component& k, int16_t* b, int ss, int se, int al) {
    const int tbl = k.ac_table;
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (b[kNatural[kex]]) break;
    for (int i = ss; i <= se; ++i) {
      uint8_t* st = ac_stats[tbl] + 3 * (i - 1);
      if (i > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* c = b + kNatural[i];
        if (*c) {
          if (ar.decode(st + 2)) *c = (int16_t)(*c < 0 ? *c + m1 : *c + p1);
          break;
        }
        if (ar.decode(st + 1)) {
          *c = (int16_t)(ar.decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++i > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
    }
  }

  // jpeg_resync_to_restart at a restart interval's end, from `at` (where the
  // entropy decoder stopped): returns where the next interval's data starts,
  // or where the decoder meets a marker at once (found = false)
  const uint8_t* restart(const uint8_t* at, int next_rst, bool& found) {
    pos = (size_t)(at - data);
    // the end of the file reads as an EOI marker, as libjpeg's source
    // manager inserts one there
    auto marker = [&]() { const int m = next_marker(); return m < 0 ? 0xD9 : m; };
    int m = marker();
    found = m == 0xD0 + next_rst;
    while (!found) {
      const auto rst = [&](int d) { return 0xD0 + ((next_rst + d) & 7); };
      if (m >= 0xC0 && (m < 0xD0 || m > 0xD7)) break;  // leave it unread
      if (m >= 0xD0 && m <= 0xD7 && (m == rst(1) || m == rst(2))) break;
      if (m < 0xC0 || m == rst(7) || m == rst(6)) {
        m = marker();  // scan on to the next marker
        continue;
      }
      found = true;  // the expected one, or one too far away: taken as it
    }
    if (found) return data + pos;
    return pos >= size && m == 0xD9 ? data + size : data + pos - 2;
  }

  // decodes one scan; returns its number of components
  int scan(size_t at, size_t end) {
    pos = at;
    ++scans;
    const int ns = u8();
    if (ns < 1 || ns > 4) damaged("a scan of " + std::to_string(ns) + " components");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = u8();
      const int tables = u8();
      Component* found = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) found = &comp[c];
      if (!found) damaged("a scan names a component the frame does not have");
      found->dc_table = tables >> 4;
      found->ac_table = tables & 15;
      sc[i] = found;
    }
    const int ss = u8(), se = u8(), ahal = u8();
    const int ah = ahal >> 4, al = ahal & 15;
    if (pos != end) damaged("a scan header of the wrong length");
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13 ||
          (ah != 0 && al != ah - 1))
        damaged("a progressive scan with a bad spectral band or point transform");
    }  // a sequential scan's Ss, Se, Ah and Al are ignored, as libjpeg ignores them
    if (lossless) {
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        damaged("a lossless scan with a bad predictor or point transform");
      return scan_lossless(sc, ns, ss, al);
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) damaged("an MCU of more than 10 blocks");
    }
    const bool needs_dc = !progressive || (ss == 0 && ah == 0);
    const bool needs_ac = !progressive || ss > 0;
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (!k.latched) {
        if (!qdefined[k.tq]) damaged("a component's quantization table is not defined");
        for (int j = 0; j < 64; ++j) k.quant[j] = (int16_t)qtables[k.tq][j];
        k.latched = true;
      }
      if (arithmetic) {
        if (needs_dc) std::memset(dc_stats[k.dc_table], 0, sizeof(dc_stats[0]));
        if (needs_ac) std::memset(ac_stats[k.ac_table], 0, sizeof(ac_stats[0]));
      } else {
        // a table is checked only where the scan uses it, as libjpeg checks it
        if (needs_dc && (k.dc_table > 3 || !dc[k.dc_table].defined))
          damaged("a scan uses an undefined DC table");
        if (needs_ac && (k.ac_table > 3 || !ac[k.ac_table].defined))
          damaged("a scan uses an undefined AC table");
        if (needs_dc) dc[k.dc_table].prepare(true);
        if (needs_ac) ac[k.ac_table].prepare(false);
      }
      k.last_dc = 0;
      k.dc_context = 0;
      if (progressive) {
        for (int c = std::min(ss, 1); c <= std::max(se, 9); ++c)
          k.prev_coef_bits[c] = scans > 1 ? k.coef_bits[c] : 0;
        std::fill(k.coef_bits + ss, k.coef_bits + se + 1, al);
      }
    }
    eobrun = 0;
    BitReader br;
    br.p = data + pos;
    br.end = data + size;
    ArithReader ar;
    ar.p = data + pos;
    ar.end = data + size;

    int units_x, units_y;
    if (ns == 1) {
      units_x = sc[0]->wblocks;
      units_y = sc[0]->hblocks;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const int64_t units = (int64_t)units_x * units_y;
    int next_rst = 0;
    // libjpeg's insufficient_data: set once a block took bits past the
    // scan's data; the blocks after it are not decoded, until a restart
    // marker is found (the arithmetic decoder reads zeros instead)
    bool insufficient = false;
    for (int64_t u = 0; u < units; ++u) {
      const int ux = (int)(u % units_x), uy = (int)(u / units_x);
      if (!insufficient) last_good_row = ns == 1 ? uy / sc[0]->v : uy;
      if (restart_interval && u > 0 && u % restart_interval == 0) {
        bool found;
        if (arithmetic) {
          ar.p = restart(ar.p, next_rst, found);
          ar.marker = !found;
          ar.reset();
        } else {
          const uint8_t* q = br.p;
          br.reset();  // byte-align, then the restart marker
          br.p = restart(q, next_rst, found);
          if (found) insufficient = false;
        }
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->last_dc = sc[i]->dc_context = 0;
        eobrun = 0;
        if (arithmetic)
          for (int i = 0; i < ns; ++i) {
            if (needs_dc) std::memset(dc_stats[sc[i]->dc_table], 0, sizeof(dc_stats[0]));
            if (needs_ac) std::memset(ac_stats[sc[i]->ac_table], 0, sizeof(ac_stats[0]));
          }
      }
      if (insufficient) continue;
      // a bad arithmetic code stops the decoder until the next restart; a DC
      // refinement goes on regardless, as jdarith.c's does
      if (arithmetic && ar.ct == -1 && !(progressive && ss == 0 && ah != 0)) continue;
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int nh = ns == 1 ? 1 : k.h, nv = ns == 1 ? 1 : k.v;
        for (int by = 0; by < nv; ++by)
          for (int bx = 0; bx < nh; ++bx) {
            int16_t* b = block(k, ux * nh + bx, uy * nv + by);
            if (arithmetic) {
              if (progressive && ss == 0 && ah != 0) {
                if (ar.decode(fixed_bin)) b[0] = (int16_t)(b[0] | (1 << al));
              } else if (ar.ct == -1) {
                continue;
              } else if (progressive && ss == 0) {
                if (arith_dc(ar, k)) b[0] = (int16_t)((unsigned)k.last_dc << al);
              } else if (progressive && ah == 0) {
                arith_ac(ar, k, b, ss, se, al);
              } else if (progressive) {
                arith_ac_refine(ar, k, b, ss, se, al);
              } else if (arith_dc(ar, k)) {
                b[0] = (int16_t)k.last_dc;
                arith_ac(ar, k, b, 1, 63, 0);
              }
            } else if (!progressive) {
              decode_baseline(br, k, b);
            } else if (ss == 0 && ah == 0) {
              decode_dc_first(br, k, b, al);
            } else if (ss == 0) {
              decode_dc_refine(br, b, al);
            } else if (ah == 0) {
              decode_ac_first(br, k, b, ss, se, al);
            } else {
              decode_ac_refine(br, k, b, ss, se, al);
            }
          }
      }
      if (!arithmetic) insufficient = br.overran();
    }
    pos = (size_t)((arithmetic ? ar.p : br.p) - data);
    return ns;
  }

  // a lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): a row at a time,
  // each sample its predictor plus a Huffman-coded difference, modulo 2^16
  int scan_lossless(Component** sc, int ns, int psv, int pt) {
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (k.dc_table > 3 || !dc[k.dc_table].defined) damaged("a scan uses an undefined DC table");
      dc[k.dc_table].prepare(true, 16);
    }
    const int w = sc[0]->dw, rows = sc[0]->dh;
    if (restart_interval % w) damaged("a lossless restart interval that is not whole rows");
    const int rows_per_interval = restart_interval / w;
    BitReader br;
    br.p = data + pos;
    br.end = data + size;
    std::vector<int> diff((size_t)w * ns);
    int next_rst = 0;
    bool insufficient = false, first_row = true;
    for (int y = 0; y < rows; ++y) {
      if (rows_per_interval && y > 0 && y % rows_per_interval == 0) {
        const uint8_t* q = br.p;
        br.reset();
        bool found;
        br.p = restart(q, next_rst, found);
        if (found) insufficient = false;
        next_rst = (next_rst + 1) & 7;
        first_row = true;
      }
      std::fill(diff.begin(), diff.end(), 0);
      if (!insufficient) {
        for (int x = 0; x < w && !insufficient; ++x) {
          for (int i = 0; i < ns; ++i) {
            const int s = br.decode(dc[sc[i]->dc_table]);
            int d = 0;
            if (s == 16) d = 32768;
            else if (s) d = extend(br.bits(s), s);
            diff[(size_t)i * w + x] = d;
          }
          insufficient = br.overran();
        }
      }
      for (int i = 0; i < ns; ++i) {
        uint16_t* cur = sc[i]->samples.data() + (size_t)y * w;
        const uint16_t* prev = cur - w;
        const int* d = diff.data() + (size_t)i * w;
        for (int x = 0; x < w; ++x) {
          int pred;
          if (first_row) {
            pred = x == 0 ? 1 << (8 - pt - 1) : cur[x - 1];
          } else if (x == 0) {
            pred = prev[0];
          } else {
            const int ra = cur[x - 1], rb = prev[x], rc = prev[x - 1];
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
          }
          cur[x] = (uint16_t)((d[x] + pred) & 0xFFFF);
        }
      }
      first_row = false;
    }
    for (int i = 0; i < ns; ++i) sc[i]->latched = true;
    point_transform = pt;
    pos = (size_t)(br.p - data);
    return ns;
  }

  // ---------------------------------------------------------- the output

  static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

  // jidctint.c's jpeg_idct_islow as libjpeg-turbo's AVX2 code computes it
  // (jidctint-avx2.asm), which is what cv2 runs on x86-64: the same
  // arithmetic, but the dequantized coefficients, the intermediate rows and
  // the sums it forms with 16-bit adds (in0 +- in4, in7 + in3, in5 + in1)
  // wrap to 16 bits, the pass-1 outputs saturate to 16 bits, and the output
  // saturates to -128..127 before the +128 (the C code wraps it through its
  // range-limit table instead). The two agree on every block whose values
  // fit; only damaged data tells them apart. out: 8 rows of `stride` bytes.
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                      F2562 = 20995, F3072 = 25172;
    auto w16 = [](int32_t v) { return (int32_t)(int16_t)v; };
    auto s16 = [](int32_t v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; };
    // one 1-D pass over 8 values x[0..7] (int16 each) -> 8 sums before the descale
    auto pass = [&](const int32_t* x, int64_t* o) {
      const int32_t tmp2 = x[2] * F0541 + x[6] * (F0541 - F1847);
      const int32_t tmp3 = x[2] * (F0541 + F0765) + x[6] * F0541;
      const int32_t tmp0 = w16(x[0] + x[4]) * (1 << CB);
      const int32_t tmp1 = w16(x[0] - x[4]) * (1 << CB);
      const int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      const int32_t z3 = w16(x[7] + x[3]), z4 = w16(x[5] + x[1]);
      const int32_t z3m = z3 * (F1175 - F1961) + z4 * F1175;
      const int32_t z4m = z3 * F1175 + z4 * (F1175 - F0390);
      const int32_t o0 = x[7] * (F0298 - F0899) + x[1] * -F0899 + z3m;
      const int32_t o3 = x[7] * -F0899 + x[1] * (F1501 - F0899) + z4m;
      const int32_t o1 = x[5] * (F2053 - F2562) + x[3] * -F2562 + z4m;
      const int32_t o2 = x[5] * -F2562 + x[3] * (F3072 - F2562) + z3m;
      o[0] = (int64_t)t10 + o3;
      o[7] = (int64_t)t10 - o3;
      o[1] = (int64_t)t11 + o2;
      o[6] = (int64_t)t11 - o2;
      o[2] = (int64_t)t12 + o1;
      o[5] = (int64_t)t12 - o1;
      o[3] = (int64_t)t13 + o0;
      o[4] = (int64_t)t13 - o0;
    };
    int32_t deq[64];
    bool ac_zero = true;
    for (int i = 0; i < 64; ++i) {
      deq[i] = w16((int32_t)in[i] * q[i]);
      if (i >= 8 && in[i] != 0) ac_zero = false;
    }
    int32_t ws[64];
    if (ac_zero) {  // every column's AC terms zero: the block's shortcut
      for (int c = 0; c < 8; ++c)
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = w16(deq[c] * (1 << P1));
    } else {
      for (int c = 0; c < 8; ++c) {
        int32_t x[8];
        int64_t o[8];
        for (int r = 0; r < 8; ++r) x[r] = deq[r * 8 + c];
        pass(x, o);
        for (int r = 0; r < 8; ++r)
          ws[r * 8 + c] = s16((int32_t)((o[r] + (1 << (CB - P1 - 1))) >> (CB - P1)));
      }
    }
    for (int r = 0; r < 8; ++r) {
      int64_t o[8];
      pass(ws + r * 8, o);
      uint8_t* row = out + (size_t)r * stride;
      constexpr int S = CB + P1 + 3;
      for (int c = 0; c < 8; ++c) {
        int32_t v = (int32_t)((o[c] + ((int64_t)1 << (S - 1))) >> S);
        v = v < -128 ? -128 : v > 127 ? 127 : v;
        row[c] = (uint8_t)(v + 128);
      }
    }
  }

  // jdcoefct.c's smoothing_ok: whether libjpeg smooths this progressive
  // file's blocks (its first 10 coefficients not all known to bit 0), with
  // each component's coefficient bits latched (now, and before its last scan)
  bool smoothing_ok(int latch[4][kSavedCoefs], int prev_latch[4][kSavedCoefs]) const {
    bool useful = false;
    for (int c = 0; c < ncomp; ++c) {
      const Component& k = comp[c];
      if (!k.latched) return false;
      for (int i : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})  // Q00..Q30 of jdcoefct.c
        if (k.quant[i] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      latch[c][0] = k.coef_bits[0];
      for (int i = 1; i < kSavedCoefs; ++i) {
        prev_latch[c][i] = scans > 1 ? k.prev_coef_bits[i] : -1;
        latch[c][i] = k.coef_bits[i];
        useful |= k.coef_bits[i] != 0;
      }
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data for one component: each block's
  // coefficients with the first ones estimated from the DC values around it
  // (rows and columns chosen as libjpeg chooses them, edges included), into
  // `px` (the padded plane, pw samples a row)
  void smooth_idct(Component& k, const int* cur_bits, const int* prev_bits, uint8_t* px, int pw) {
    const int v = k.v, total = mcuy, last_col = k.wblocks - 1;
    const int64_t q00 = (uint16_t)k.quant[0], q01 = (uint16_t)k.quant[1],
                  q10 = (uint16_t)k.quant[8], q20 = (uint16_t)k.quant[16],
                  q11 = (uint16_t)k.quant[9], q02 = (uint16_t)k.quant[2],
                  q03 = (uint16_t)k.quant[3], q12 = (uint16_t)k.quant[10],
                  q21 = (uint16_t)k.quant[17], q30 = (uint16_t)k.quant[24];
    int16_t ws[64];
    for (int row = 0; row < total; ++row) {
      int block_rows = v;
      if (row == total - 1) {
        block_rows = k.hblocks % v;
        if (block_rows == 0) block_rows = v;
      }
      // an iMCU row past the last that the last scan decoded takes the bits
      // from before that scan
      const int* bits = row > last_good_row ? prev_bits : cur_bits;
      bool change_dc = true;
      for (int i = 1; i < kSavedCoefs; ++i) change_dc &= bits[i] == -1;
      const int image_block_rows = block_rows * total;
      for (int br = 0; br < block_rows; ++br) {
        const int arow = row * v + br;
        const int image_block_row = row * block_rows + br;
        int rows[5];
        rows[2] = arow;
        rows[1] = image_block_row > 0 ? arow - 1 : arow;
        rows[0] = image_block_row > 1 ? arow - 2 : rows[1];
        rows[3] = image_block_row < image_block_rows - 1 ? arow + 1 : arow;
        rows[4] = image_block_row < image_block_rows - 2 ? arow + 2 : rows[3];
        int dcv[5][5];  // DC01..DC25 of jdcoefct.c, a row of 5 each
        for (int r = 0; r < 5; ++r)
          for (int c = 0; c < 5; ++c) dcv[r][c] = block(k, 0, rows[r])[0];
        for (int bn = 0; bn <= last_col; ++bn) {
          if (bn == 0 && bn < last_col)
            for (int r = 0; r < 5; ++r) dcv[r][3] = block(k, 1, rows[r])[0];
          if (bn + 1 < last_col)
            for (int r = 0; r < 5; ++r) dcv[r][4] = block(k, bn + 2, rows[r])[0];
          std::memcpy(ws, block(k, bn, arow), sizeof(ws));
          const int64_t DC01 = dcv[0][0], DC02 = dcv[0][1], DC03 = dcv[0][2], DC04 = dcv[0][3],
                        DC05 = dcv[0][4], DC06 = dcv[1][0], DC07 = dcv[1][1], DC08 = dcv[1][2],
                        DC09 = dcv[1][3], DC10 = dcv[1][4], DC11 = dcv[2][0], DC12 = dcv[2][1],
                        DC13 = dcv[2][2], DC14 = dcv[2][3], DC15 = dcv[2][4], DC16 = dcv[3][0],
                        DC17 = dcv[3][1], DC18 = dcv[3][2], DC19 = dcv[3][3], DC20 = dcv[3][4],
                        DC21 = dcv[4][0], DC22 = dcv[4][1], DC23 = dcv[4][2], DC24 = dcv[4][3],
                        DC25 = dcv[4][4];
          // an estimate goes only where the coefficient is still zero and
          // not known to its last bit, clamped below the bit known
          auto estimate = [&](int zz, int nat, int64_t q, int64_t sum) {
            const int al = bits[zz];
            if (al == 0 || ws[nat] != 0) return;
            const int64_t num = q00 * sum;
            int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            ws[nat] = (int16_t)(num >= 0 ? pred : -pred);
          };
          estimate(1, 1, q01, change_dc
              ? -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25
              : -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
          estimate(2, 8, q10, change_dc
              ? -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 +
                DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25
              : -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
          estimate(3, 16, q20, change_dc
              ? DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                2 * DC17 + 7 * DC18 + 2 * DC19 + DC23
              : -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
          estimate(4, 9, q11, change_dc
              ? -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25
              : DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                DC06 + 10 * DC07 - 10 * DC09);
          estimate(5, 2, q02, change_dc
              ? 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19
              : -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
          if (change_dc) {
            estimate(6, 3, q03, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            estimate(7, 10, q12, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            estimate(8, 17, q21, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            estimate(9, 24, q30, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            // the DC itself, from a Gaussian-like 5x5 kernel
            const int64_t num =
                q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                       6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                       152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                       6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                       2 * DC25);
            const int pred = (int)(((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8));
            ws[0] = (int16_t)(num >= 0 ? pred : -pred);
          }
          idct_islow(ws, k.quant, px + (size_t)arow * 8 * pw + bn * 8, pw);
          for (int r = 0; r < 5; ++r)
            for (int c = 0; c < 4; ++c) dcv[r][c] = dcv[r][c + 1];
        }
      }
    }
  }

  // a component's samples (dh rows of dw) from its coefficients, smoothed
  // where `bits` is given
  std::vector<uint8_t> plane(Component& k, const int* bits, const int* prev_bits) {
    std::vector<uint8_t> out((size_t)k.dw * k.dh);
    if (lossless) {  // jdlossls.c's simple_upscale: the point transform undone
      for (size_t i = 0; i < out.size(); ++i) out[i] = (uint8_t)(k.samples[i] << point_transform);
      return out;
    }
    const int pw = k.bw * 8;
    std::vector<uint8_t> px((size_t)pw * k.bh * 8);
    if (bits) {
      smooth_idct(k, bits, prev_bits, px.data(), pw);
    } else {
      for (int by = 0; by < k.hblocks; ++by)
        for (int bx = 0; bx < k.wblocks; ++bx)
          idct_islow(block(k, bx, by), k.quant, px.data() + (size_t)by * 8 * pw + bx * 8, pw);
    }
    for (int y = 0; y < k.dh; ++y) std::memcpy(out.data() + (size_t)y * k.dw,
                                               px.data() + (size_t)y * pw, k.dw);
    return out;
  }

  // jdsample.c: the plane at the output size (width x height)
  std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, const Component& k) {
    const int rh = hmax / k.h, rv = vmax / k.v, dw = k.dw, dh = k.dh;
    if (rh == 1 && rv == 1) return in;
    std::vector<uint8_t> out((size_t)width * height);
    std::vector<uint8_t> row((size_t)rh * dw + 2);
    auto put = [&](int y, const uint8_t* r) {
      if (y < height) std::memcpy(out.data() + (size_t)y * width, r, width);
    };
    const bool fancy = (rh == 2 && rv == 1 && dw > 2) || (rh == 1 && rv == 2) ||
                       (rh == 2 && rv == 2 && dw > 2);
    if (!fancy) {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      for (int y = 0; y < dh; ++y) {
        const uint8_t* s = in.data() + (size_t)y * dw;
        uint8_t* o = row.data();
        for (int x = 0; x < dw; ++x)
          for (int e = 0; e < rh; ++e) o[rh * x + e] = s[x];
        for (int e = 0; e < rv; ++e) put(rv * y + e, o);
      }
    } else if (rh == 2 && rv == 1) {
      for (int y = 0; y < dh; ++y) {
        const uint8_t* s = in.data() + (size_t)y * dw;
        uint8_t* o = row.data();
        o[0] = s[0];
        o[1] = (uint8_t)((s[0] * 3 + s[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          const int v = s[x] * 3;
          o[2 * x] = (uint8_t)((v + s[x - 1] + 1) >> 2);
          o[2 * x + 1] = (uint8_t)((v + s[x + 1] + 2) >> 2);
        }
        o[2 * dw - 2] = (uint8_t)((s[dw - 1] * 3 + s[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = s[dw - 1];
        put(y, o);
      }
    } else if (rh == 1 && rv == 2) {
      for (int y = 0; y < dh; ++y) {
        const uint8_t* s = in.data() + (size_t)y * dw;
        for (int v = 0; v < 2; ++v) {
          const int other = v == 0 ? std::max(y - 1, 0) : std::min(y + 1, dh - 1);
          const uint8_t* t = in.data() + (size_t)other * dw;
          const int bias = v == 0 ? 1 : 2;
          uint8_t* o = row.data();
          for (int x = 0; x < dw; ++x) o[x] = (uint8_t)((s[x] * 3 + t[x] + bias) >> 2);
          put(2 * y + v, o);
        }
      }
    } else {  // 2 x 2
      for (int y = 0; y < dh; ++y) {
        const uint8_t* s = in.data() + (size_t)y * dw;
        for (int v = 0; v < 2; ++v) {
          uint8_t* o = row.data();
          const int other = v == 0 ? std::max(y - 1, 0) : std::min(y + 1, dh - 1);
          const uint8_t* t = in.data() + (size_t)other * dw;
          int this_sum = s[0] * 3 + t[0];
          int next_sum = s[1] * 3 + t[1];
          o[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
          o[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          int last_sum = this_sum;
          this_sum = next_sum;
          for (int x = 2; x < dw; ++x) {
            next_sum = s[x] * 3 + t[x];
            o[2 * x - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
            o[2 * x - 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
          }
          o[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          o[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
          put(2 * y + v, o);
        }
      }
    }
    return out;
  }

  void finish(uint8_t* rgb) {
    int latch[4][kSavedCoefs], prev_latch[4][kSavedCoefs];
    const bool smooth = progressive && smoothing_ok(latch, prev_latch);
    std::vector<uint8_t> p[4];
    for (int c = 0; c < ncomp; ++c)
      p[c] = upsample(plane(comp[c], smooth ? latch[c] : nullptr, prev_latch[c]), comp[c]);
    const size_t n = (size_t)width * height;
    if (ncomp == 1) {
      for (size_t i = 0; i < n; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = p[0][i];
      return;
    }
    bool is_rgb, is_ycc;
    if (ncomp == 4) {  // jdapimin.c: CMYK, or YCCK for any Adobe transform but 0
      is_rgb = false;
      is_ycc = adobe && adobe_transform != 0;
    } else {
      if (jfif) is_rgb = false;
      else if (adobe) is_rgb = adobe_transform == 0;
      else is_rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
      is_ycc = !is_rgb;
    }
    if (is_rgb) {
      for (size_t i = 0; i < n; ++i) {
        rgb[3 * i] = p[0][i];
        rgb[3 * i + 1] = p[1][i];
        rgb[3 * i + 2] = p[2][i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table
    constexpr int SB = 16;
    constexpr int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    if (ncomp == 3) {
      for (size_t i = 0; i < n; ++i) {
        const int y = p[0][i], cb = p[1][i], cr = p[2][i];
        rgb[3 * i] = clamp255(y + cr_r[cr]);
        rgb[3 * i + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
        rgb[3 * i + 2] = clamp255(y + cb_b[cb]);
      }
      return;
    }
    for (size_t i = 0; i < n; ++i) {
      int c = p[0][i], m = p[1][i], y = p[2][i];
      const int k = p[3][i];
      if (is_ycc) {  // jdcolor.c's ycck_cmyk_convert
        const int yy = c, cb = m, cr = y;
        c = clamp255(255 - (yy + cr_r[cr]));
        m = clamp255(255 - (yy + (int)((cb_g[cb] + cr_g[cr]) >> SB)));
        y = clamp255(255 - (yy + cb_b[cb]));
      }
      // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R: B, G, R = y, m, c
      rgb[3 * i] = (uint8_t)(k - ((255 - c) * k >> 8));
      rgb[3 * i + 1] = (uint8_t)(k - ((255 - m) * k >> 8));
      rgb[3 * i + 2] = (uint8_t)(k - ((255 - y) * k >> 8));
    }
  }
};

void set_reason(char* buf, int cap, const std::string& why) {
  if (cap <= 0) return;
  std::snprintf(buf, (size_t)cap, "%s", why.c_str());
}

// ----------------------------------------------------------- the encoder

const uint8_t kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCodes {
  uint16_t code[256];
  uint8_t len[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(len, 0, sizeof(len));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
        code[vals[k]] = (uint16_t)c;
        len[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int bits) {
    if (bits == 0) return;
    acc = (acc << bits) | (v & ((1u << bits) - 1));
    n += bits;
    while (n >= 8) {
      const uint8_t b = (uint8_t)(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
  }
  void flush() {
    if (n > 0) put(0x7F, 8 - n);  // pad with ones
  }
};

// jfdctint.c's jpeg_fdct_islow, on samples centred at 0; output scaled by 8
void fdct_islow(int* d) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  auto desc = [](int64_t v, int s) { return (int)((v + ((int64_t)1 << (s - 1))) >> s); };
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      const int st = pass == 0 ? 1 : 8;
      int* p = pass == 0 ? d + i * 8 : d + i;
      const int64_t tmp0 = p[0] + p[7 * st], tmp7 = p[0] - p[7 * st];
      const int64_t tmp1 = p[st] + p[6 * st], tmp6 = p[st] - p[6 * st];
      const int64_t tmp2 = p[2 * st] + p[5 * st], tmp5 = p[2 * st] - p[5 * st];
      const int64_t tmp3 = p[3 * st] + p[4 * st], tmp4 = p[3 * st] - p[4 * st];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                    tmp12 = tmp1 - tmp2;
      const int s = pass == 0 ? CB - P1 : CB + P1;
      if (pass == 0) {
        p[0] = (int)((tmp10 + tmp11) * (1 << P1));
        p[4 * st] = (int)((tmp10 - tmp11) * (1 << P1));
      } else {
        p[0] = desc(tmp10 + tmp11, P1);
        p[4 * st] = desc(tmp10 - tmp11, P1);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * st] = desc(z1 + tmp13 * F0765, s);
      p[6 * st] = desc(z1 + tmp12 * -F1847, s);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * F1175;
      const int64_t t4 = tmp4 * F0298, t5 = tmp5 * F2053, t6 = tmp6 * F3072, t7 = tmp7 * F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * st] = desc(t4 + z1 + z3, s);
      p[5 * st] = desc(t5 + z2 + z4, s);
      p[3 * st] = desc(t6 + z2 + z3, s);
      p[st] = desc(t7 + z1 + z4, s);
    }
  }
}

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t>& o, int tc_th, const uint8_t* bits, const uint8_t* vals) {
  int total = 0;
  for (int i = 0; i < 16; ++i) total += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put_u16(o, 2 + 1 + 16 + total);
  o.push_back((uint8_t)tc_th);
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + total);
}

void encode(const uint8_t* img, int h, int w, int channels, int quality, int sub,
            std::vector<uint8_t>& o) {
  quality = std::min(std::max(quality, 1), 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qt[2][64];  // natural order
  for (int i = 0; i < 64; ++i) {
    qt[0][i] = std::min(std::max((kLumaQ[i] * scale + 50) / 100, 1), 255);
    qt[1][i] = std::min(std::max((kChromaQ[i] * scale + 50) / 100, 1), 255);
  }
  const int nc = channels == 1 ? 1 : 3;
  const int hs = nc == 1 || sub == 0 ? 1 : 2;             // luma's factors
  const int vs = nc == 1 || sub != 2 ? 1 : 2;
  // planes: Y, Cb, Cr at full size (libjpeg's rgb_ycc_convert)
  std::vector<uint8_t> planes[3];
  const size_t n = (size_t)h * w;
  for (int c = 0; c < nc; ++c) planes[c].resize(n);
  if (nc == 1) {
    std::memcpy(planes[0].data(), img, n);
  } else {
    constexpr int SB = 16;
    constexpr int64_t HALF = (int64_t)1 << (SB - 1), OFF = (int64_t)128 << SB;
    auto fix = [](double x) { return (int64_t)(x * (1 << SB) + 0.5); };
    const int64_t a = fix(0.29900), b = fix(0.58700), c = fix(0.11400), d = fix(0.16874),
                  e = fix(0.33126), f = fix(0.5), g = fix(0.41869), k = fix(0.08131);
    for (size_t i = 0; i < n; ++i) {
      const int64_t r = img[3 * i], gg = img[3 * i + 1], bb = img[3 * i + 2];
      planes[0][i] = (uint8_t)((a * r + b * gg + c * bb + HALF) >> SB);
      planes[1][i] = (uint8_t)((-d * r - e * gg + f * bb + OFF + HALF - 1) >> SB);
      planes[2][i] = (uint8_t)((f * r - g * gg - k * bb + OFF + HALF - 1) >> SB);
    }
  }
  const int mcuw = 8 * hs, mcuh = 8 * vs;
  const int mx = (w + mcuw - 1) / mcuw, my = (h + mcuh - 1) / mcuh;
  // each plane padded to whole MCUs by repeating its last column and row,
  // chroma downsampled with libjpeg's alternating bias
  const int pw = mx * mcuw, ph = my * mcuh;
  std::vector<uint8_t> padded[3];
  int cw[3], chh[3];
  for (int c = 0; c < nc; ++c) {
    std::vector<uint8_t> full((size_t)pw * ph);
    for (int y = 0; y < ph; ++y)
      for (int x = 0; x < pw; ++x)
        full[(size_t)y * pw + x] = planes[c][(size_t)std::min(y, h - 1) * w + std::min(x, w - 1)];
    if (c == 0 || (hs == 1 && vs == 1)) {
      padded[c] = std::move(full);
      cw[c] = pw;
      chh[c] = ph;
      continue;
    }
    cw[c] = pw / hs;
    chh[c] = ph / vs;
    padded[c].resize((size_t)cw[c] * chh[c]);
    for (int y = 0; y < chh[c]; ++y) {
      int bias = vs == 2 ? 1 : 0;
      for (int x = 0; x < cw[c]; ++x) {
        int sum = 0;
        for (int dy = 0; dy < vs; ++dy)
          for (int dx = 0; dx < hs; ++dx) sum += full[(size_t)(y * vs + dy) * pw + x * hs + dx];
        const int cnt = hs * vs;
        padded[c][(size_t)y * cw[c] + x] =
            (uint8_t)(cnt == 4 ? (sum + bias) >> 2 : (sum + bias) >> 1);
        bias ^= cnt == 4 ? 3 : 1;  // 1, 2, 1, 2 ... (h2v2); 0, 1, 0, 1 ... (h2v1)
      }
    }
  }
  // headers
  o.push_back(0xFF);
  o.push_back(0xD8);
  const uint8_t app0[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), app0, app0 + sizeof(app0));
  for (int t = 0; t < (nc == 1 ? 1 : 2); ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put_u16(o, 67);
    o.push_back((uint8_t)t);
    for (int k = 0; k < 64; ++k) o.push_back((uint8_t)qt[t][kNatural[k]]);
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put_u16(o, 8 + 3 * nc);
  o.push_back(8);
  put_u16(o, h);
  put_u16(o, w);
  o.push_back((uint8_t)nc);
  for (int c = 0; c < nc; ++c) {
    o.push_back((uint8_t)(c + 1));
    o.push_back((uint8_t)(c == 0 ? (hs << 4) | vs : 0x11));
    o.push_back((uint8_t)(c == 0 ? 0 : 1));
  }
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put_u16(o, 6 + 2 * nc);
  o.push_back((uint8_t)nc);
  for (int c = 0; c < nc; ++c) {
    o.push_back((uint8_t)(c + 1));
    o.push_back((uint8_t)(c == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);
  HuffCodes hdc[2], hac[2];
  hdc[0].build(kDcLumaBits, kDcVals);
  hac[0].build(kAcLumaBits, kAcLumaVals);
  hdc[1].build(kDcChromaBits, kDcVals);
  hac[1].build(kAcChromaBits, kAcChromaVals);
  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  auto nbits = [](int v) {
    v = v < 0 ? -v : v;
    int s = 0;
    while (v) {
      ++s;
      v >>= 1;
    }
    return s;
  };
  auto emit_block = [&](int c, int bx, int by) {
    const int t = c == 0 ? 0 : 1;
    int d[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        d[y * 8 + x] = (int)padded[c][(size_t)(by * 8 + y) * cw[c] + bx * 8 + x] - 128;
    fdct_islow(d);
    int q[64];
    for (int i = 0; i < 64; ++i) {
      const int div = qt[t][i] * 8;
      int v = d[i];
      if (v < 0) {
        v = -v;
        v = (v + (div >> 1)) / div;
        v = -v;
      } else {
        v = (v + (div >> 1)) / div;
      }
      q[i] = v;
    }
    const int diff = q[0] - last_dc[c];
    last_dc[c] = q[0];
    int s = nbits(diff);
    bw.put(hdc[t].code[s], hdc[t].len[s]);
    bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), s);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      const int v = q[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(hac[t].code[0xF0], hac[t].len[0xF0]);
        run -= 16;
      }
      s = nbits(v);
      const int sym = (run << 4) | s;
      bw.put(hac[t].code[sym], hac[t].len[sym]);
      bw.put((uint32_t)(v < 0 ? v - 1 : v), s);
      run = 0;
    }
    if (run > 0) bw.put(hac[t].code[0x00], hac[t].len[0x00]);
  };
  for (int my_ = 0; my_ < my; ++my_)
    for (int mx_ = 0; mx_ < mx; ++mx_) {
      for (int y = 0; y < vs; ++y)
        for (int x = 0; x < hs; ++x) emit_block(0, mx_ * hs + x, my_ * vs + y);
      for (int c = 1; c < nc; ++c) emit_block(c, mx_, my_);
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

}  // namespace

extern "C" {

// info[0..3] = height, width, components, EXIF orientation (1 without one).
// Returns 0, 1 (refused) or 2 (damaged), with the reason in `reason`.
int s2d_jpeg_header(const uint8_t* data, int64_t size, int32_t* info, char* reason, int cap) {
  try {
    Decoder d(data, (size_t)size);
    d.parse(true);
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    info[3] = d.orientation;
    return 0;
  } catch (const Failure& f) {
    set_reason(reason, cap, f.reason);
    return f.status;
  } catch (const std::bad_alloc&) {
    set_reason(reason, cap, "out of memory");
    return 2;
  }
}

// Decodes into rgb (height * width * 3 bytes, as s2d_jpeg_header gave them),
// before the EXIF orientation. Returns as s2d_jpeg_header.
int s2d_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* rgb, int32_t height,
                    int32_t width, char* reason, int cap) {
  try {
    Decoder d(data, (size_t)size);
    d.parse(false);
    if (!d.have_frame) damaged("no frame header");
    if (d.height != height || d.width != width) damaged("the frame size changed");
    d.finish(rgb);
    return 0;
  } catch (const Failure& f) {
    set_reason(reason, cap, f.reason);
    return f.status;
  } catch (const std::bad_alloc&) {
    set_reason(reason, cap, "out of memory");
    return 2;
  }
}

// (h, w, channels) uint8 (channels 1 or 3, RGB) -> a baseline JPEG in out.
// subsampling: 0 4:4:4, 1 4:2:2, 2 4:2:0 (ignored for grey). Returns its
// length, or -(the length needed) when cap is too small.
int64_t s2d_jpeg_encode(const uint8_t* img, int32_t h, int32_t w, int32_t channels,
                        int32_t quality, int32_t subsampling, uint8_t* out, int64_t cap) {
  std::vector<uint8_t> o;
  try {
    encode(img, h, w, channels, quality, subsampling, o);
  } catch (const std::bad_alloc&) {
    return 0;
  }
  if ((int64_t)o.size() > cap) return -(int64_t)o.size();
  std::memcpy(out, o.data(), o.size());
  return (int64_t)o.size();
}

}  // extern "C"
