// A JPEG codec of the port's own (C ABI, loaded via ctypes by
// s2d_tpu_torch/native/__init__.py): the card's machine has neither cv2 nor
// PIL, and every registered dataset (YTVIS JPEGImages, COCO, ImageNet, VOC,
// UVO) is JPEG.
//
// The decoder returns what cv2.imread(path, IMREAD_COLOR)[..., ::-1] returns,
// byte for byte, by following libjpeg-turbo's default decompression:
//   - baseline and extended sequential Huffman (SOF0/SOF1) and progressive
//     Huffman (SOF2), 8-bit samples, 1 or 3 components, sampling factors
//     up to 2x2, restart intervals, byte stuffing and fill bytes;
//   - the integer "islow" IDCT of jidctint.c, as libjpeg-turbo's AVX2 code
//     (what cv2 runs on x86-64) computes it, down to its 16-bit wraps and
//     saturations on damaged data;
//   - fancy upsampling (jdsample.c: the h2v1, h2v2 and h1v2 triangle
//     filters), run over whole component planes with their first and last
//     rows and columns repeated, as jdmainct.c's context rows repeat them;
//     box replication for a plane 2 samples wide or less, as libjpeg-turbo
//     does there;
//   - the fixed-point YCbCr -> RGB of jdcolor.c; an Adobe APP14 transform 0,
//     or component ids 'R', 'G', 'B' without a JFIF marker, is RGB; grey is
//     replicated to 3 channels.
// The EXIF orientation (the first APP1 segment, as cv2 reads it) is
// returned by s2d_jpeg_header; the caller applies it.
//
// Refused, with a reason (status 1, ValueError in Python): arithmetic
// coding (SOF9-SOF15), lossless (SOF3), hierarchical, a height set by a DNL
// marker, 12- and 16-bit samples, 2 or 4 components (CMYK, YCCK), sampling
// ratios other than 1 and 2.
//
// Damaged data reads as libjpeg reads it, where cv2.imread still returns an
// image (with a warning): a scan whose data ends early (a cut file, a stray
// marker) decodes its current block on zero bits and leaves the rest of the
// scan as it was (zero coefficients in a first scan) up to a restart marker
// it finds; a missing or out-of-order restart marker goes through
// jpeg_resync_to_restart's rules; a code no Huffman table holds takes 17
// bits and reads as symbol 0; a component no scan holds is mid-grey.
// Raised as damaged (status 2, OSError): what stops libjpeg with an error (a
// file cut in its headers, an unknown marker, a bad table), and a
// progressive file that lacks scans of its first 10 coefficients, whose
// blocks libjpeg smooths (jdcoefct.c's decompress_smooth_data), which the
// port does not.
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
  // a scan starts to use the table: no all-ones code, DC symbols <= 15
  void prepare(bool dc) {
    std::memset(look_len, 0, sizeof(look_len));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (dc && vals[k] > 15) damaged("a DC Huffman table with a symbol past 15");
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

// ----------------------------------------------------------- the decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks in the padded (MCU-grid) plane
  int wblocks = 0, hblocks = 0;  // blocks that hold image samples
  int dw = 0, dh = 0;          // downsampled size in samples
  bool latched = false;
  int16_t quant[64] = {};          // zero until latched: an unseen component is mid-grey
  int coef_bits[64];               // progressive: the bit position each coefficient is known to
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int dc_table = 0, ac_table = 0;
  int last_dc = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  bool progressive = false, have_frame = false, have_scan = false;
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

  Decoder(const uint8_t* d, size_t s) : data(d), size(s) {}

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
  }

  void read_dht(size_t end) {
    while (pos < end) {
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
  }

  void read_sof(int marker) {
    if (have_frame) damaged("a second frame header");
    progressive = marker == 0xC2;
    const int precision = u8();
    if (precision != 8) refuse(std::to_string(precision) + "-bit samples (only 8-bit is read)");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) refuse("a height defined by a DNL marker");
    if (width == 0) damaged("a frame of width 0");
    if (ncomp == 4) refuse("4 components (CMYK or YCCK)");
    if (ncomp != 1 && ncomp != 3) refuse(std::to_string(ncomp) + " components");
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
    for (int c = 0; c < ncomp; ++c) {
      const int rh = hmax / comp[c].h, rv = vmax / comp[c].v;
      if (hmax % comp[c].h || vmax % comp[c].v || rh > 2 || rv > 2)
        refuse("sampling factors " + std::to_string(comp[c].h) + "x" +
               std::to_string(comp[c].v) + " against " + std::to_string(hmax) + "x" +
               std::to_string(vmax) + " (only ratios 1 and 2 are read)");
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    if ((int64_t)mcux * mcuy * hmax * vmax * 64 * ncomp > ((int64_t)1 << 31))
      refuse("an image of more than 2^31 samples");
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
      k.wblocks = (k.dw + 7) / 8;
      k.hblocks = (k.dh + 7) / 8;
      k.coef.assign((size_t)k.bw * k.bh * 64, 0);
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
    }
    have_frame = true;
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
      if (m == 0xD9) return;
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // ignored, as libjpeg
      if (m == 0xD8) damaged("a second SOI marker");
      // markers libjpeg does not know stop it with an error
      if (m < 0xC0 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD))
        damaged("an unknown marker " + std::to_string(m));
      const size_t seg = pos;
      const int len = u16();
      if (len < 2 || seg + len > size) {
        // libjpeg skips an APPn or COM segment to the end of the file, where
        // its source manager inserts an EOI; any other segment fails
        if (!header && ((m >= 0xE0 && m <= 0xEF) || m == 0xFE)) return;
        damaged("a marker segment longer than the file");
      }
      const size_t end = seg + len;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
      } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xC7)) {
        refuse("a lossless or hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m >= 0xC9 && m <= 0xCF && m != 0xCC) {
        refuse("arithmetic coding (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xC8 || m == 0xCC) {
        refuse("arithmetic coding (DAC) or a JPG extension");
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
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

  // decodes one scan; returns its number of components
  int scan(size_t at, size_t end) {
    pos = at;
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
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13)
        damaged("a progressive scan with a bad spectral band or point transform");
    }  // a sequential scan's Ss, Se, Ah and Al are ignored, as libjpeg ignores them
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (!k.latched) {
        if (!qdefined[k.tq]) damaged("a component's quantization table is not defined");
        for (int j = 0; j < 64; ++j) k.quant[j] = (int16_t)qtables[k.tq][j];
        k.latched = true;
      }
      const bool needs_dc = !progressive || (ss == 0 && ah == 0);
      const bool needs_ac = !progressive || ss > 0;
      // a table is checked only where the scan uses it, as libjpeg checks it
      if (needs_dc && (k.dc_table > 3 || !dc[k.dc_table].defined))
        damaged("a scan uses an undefined DC table");
      if (needs_ac && (k.ac_table > 3 || !ac[k.ac_table].defined))
        damaged("a scan uses an undefined AC table");
      if (needs_dc) dc[k.dc_table].prepare(true);
      if (needs_ac) ac[k.ac_table].prepare(false);
      k.last_dc = 0;
      if (progressive) std::fill(k.coef_bits + ss, k.coef_bits + se + 1, al);
    }
    eobrun = 0;
    BitReader br;
    br.p = data + pos;
    br.end = data + size;

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
    // marker is found
    bool insufficient = false;
    for (int64_t u = 0; u < units; ++u) {
      if (restart_interval && u > 0 && u % restart_interval == 0) {
        // byte-align, then the restart marker (anything before it skipped)
        const uint8_t* q = br.p;
        br.reset();
        pos = (size_t)(q - data);
        // the end of the file reads as an EOI marker, as libjpeg's source
        // manager inserts one there
        auto marker = [&]() { const int m = next_marker(); return m < 0 ? 0xD9 : m; };
        int m = marker();
        bool found = m == 0xD0 + next_rst;
        while (!found) {  // jdmarker.c's jpeg_resync_to_restart
          const auto rst = [&](int d) { return 0xD0 + ((next_rst + d) & 7); };
          if (m >= 0xC0 && (m < 0xD0 || m > 0xD7)) break;  // leave it unread
          if (m >= 0xD0 && m <= 0xD7 && (m == rst(1) || m == rst(2))) break;
          if (m < 0xC0 || m == rst(7) || m == rst(6)) {
            m = marker();  // scan on to the next marker
            continue;
          }
          found = true;  // the expected one, or one too far away: taken as it
        }
        if (found) {
          br.p = data + pos;
          insufficient = false;
        } else {
          // the decoder meets the marker at once: the interval takes zero bits
          br.p = pos >= size && m == 0xD9 ? data + size : data + pos - 2;
        }
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
        eobrun = 0;
      }
      if (insufficient) continue;
      const int ux = (int)(u % units_x), uy = (int)(u / units_x);
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int nh = ns == 1 ? 1 : k.h, nv = ns == 1 ? 1 : k.v;
        for (int by = 0; by < nv; ++by)
          for (int bx = 0; bx < nh; ++bx) {
            int16_t* b = block(k, ux * nh + bx, uy * nv + by);
            if (!progressive) decode_baseline(br, k, b);
            else if (ss == 0 && ah == 0) decode_dc_first(br, k, b, al);
            else if (ss == 0) decode_dc_refine(br, b, al);
            else if (ah == 0) decode_ac_first(br, k, b, ss, se, al);
            else decode_ac_refine(br, k, b, ss, se, al);
          }
      }
      insufficient = br.overran();
    }
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

  // a component's samples (dh rows of dw) from its coefficients
  std::vector<uint8_t> plane(Component& k) {
    const int pw = k.bw * 8;
    std::vector<uint8_t> px((size_t)pw * k.bh * 8);
    for (int by = 0; by < k.hblocks; ++by)
      for (int bx = 0; bx < k.wblocks; ++bx)
        idct_islow(block(k, bx, by), k.quant, px.data() + (size_t)by * 8 * pw + bx * 8, pw);
    std::vector<uint8_t> out((size_t)k.dw * k.dh);
    for (int y = 0; y < k.dh; ++y) std::memcpy(out.data() + (size_t)y * k.dw,
                                               px.data() + (size_t)y * pw, k.dw);
    return out;
  }

  // jdsample.c: the plane at the output size (width x height)
  std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, const Component& k) {
    const int rh = hmax / k.h, rv = vmax / k.v, dw = k.dw, dh = k.dh;
    if (rh == 1 && rv == 1) return in;
    std::vector<uint8_t> out((size_t)width * height);
    std::vector<uint8_t> row(2 * (size_t)dw + 2);
    auto put = [&](int y, const uint8_t* r) {
      if (y < height) std::memcpy(out.data() + (size_t)y * width, r, width);
    };
    if (rh == 2 && rv == 1) {
      for (int y = 0; y < dh; ++y) {
        const uint8_t* s = in.data() + (size_t)y * dw;
        uint8_t* o = row.data();
        if (dw > 2) {
          o[0] = s[0];
          o[1] = (uint8_t)((s[0] * 3 + s[1] + 2) >> 2);
          for (int x = 1; x < dw - 1; ++x) {
            const int v = s[x] * 3;
            o[2 * x] = (uint8_t)((v + s[x - 1] + 1) >> 2);
            o[2 * x + 1] = (uint8_t)((v + s[x + 1] + 2) >> 2);
          }
          o[2 * dw - 2] = (uint8_t)((s[dw - 1] * 3 + s[dw - 2] + 1) >> 2);
          o[2 * dw - 1] = s[dw - 1];
        } else {
          for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = s[x];
        }
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
          if (dw > 2) {
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
          } else {
            for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = s[x];
          }
          put(2 * y + v, o);
        }
      }
    }
    return out;
  }

  // jdcoefct.c's smoothing_ok: whether libjpeg would smooth the blocks of
  // this progressive file (its first 10 coefficients not all known to bit 0)
  bool would_smooth() const {
    bool useful = false;
    for (int c = 0; c < ncomp; ++c) {
      const Component& k = comp[c];
      if (!k.latched || k.coef_bits[0] < 0) return false;
      for (int i : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})  // Q00..Q30 of jdcoefct.c
        if (k.quant[i] == 0) return false;
      for (int i = 1; i < 10; ++i) useful |= k.coef_bits[i] != 0;
    }
    return useful;
  }

  void finish(uint8_t* rgb) {
    if (progressive && would_smooth())
      damaged("a progressive file without all the scans of its first coefficients "
              "(libjpeg smooths such blocks)");
    if (ncomp == 1) {
      const std::vector<uint8_t> g = plane(comp[0]);
      for (size_t i = 0, n = (size_t)width * height; i < n; ++i)
        rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> p[3];
    for (int c = 0; c < 3; ++c) p[c] = upsample(plane(comp[c]), comp[c]);
    bool is_rgb;
    if (jfif) is_rgb = false;
    else if (adobe) is_rgb = adobe_transform == 0;
    else is_rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    const size_t n = (size_t)width * height;
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
    for (size_t i = 0; i < n; ++i) {
      const int y = p[0][i], cb = p[1][i], cr = p[2][i];
      rgb[3 * i] = clamp255(y + cr_r[cr]);
      rgb[3 * i + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
      rgb[3 * i + 2] = clamp255(y + cb_b[cb]);
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
