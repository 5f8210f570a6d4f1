// Baseline JPEG decode and encode on the host, behind a plain C interface
// (loaded through ctypes by align3r_tpu_torch/utils/jpeg.py; built with
// `c++ -O3 -shared -fPIC -std=c++17`).
//
// The decoder gives the bits of libjpeg-turbo's default decompression, which
// OpenCV's imread and Pillow both run:
//   - Huffman-coded sequential DCT (SOF0, SOF1), 8-bit samples, 1 or 3
//     components, sampling factors whose ratio to the largest is 1:1, 2:1
//     (4:2:2) or 2:2 (4:2:0), restart markers, any image size;
//   - the ISLOW integer IDCT (jidctint.c) and its range-limit table;
//   - "fancy" upsampling (jdsample.c h2v1 / h2v2 with their alternating
//     rounding, the top and bottom rows repeated as context; plain
//     replication where the component is at most 2 samples wide);
//   - YCbCr -> RGB through jdcolor.c's fixed-point tables (ONE_HALF
//     rounding); a 3-component file is YCbCr unless an Adobe marker says
//     transform 0, or, without JFIF or Adobe markers, its ids are 'R' 'G' 'B'.
// Anything else (progressive, arithmetic-coded, lossless, 12-bit, CMYK,
// other samplings) is reported as unsupported with its SOF marker, so that
// the caller can hand the file to an imaging library.
//
// The encoder writes baseline JFIF: the standard quantization tables scaled
// by quality (jcparam.c's rule), the standard Huffman tables, 4:4:4, 4:2:2
// or 4:2:0 chroma (libjpeg's box averages with alternating bias), a float
// forward DCT.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the end lands on 63, as in jutils.c
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

struct Error {
  int status = kOk;
  int sof = 0;
  std::string msg;
  bool fail(int s, const std::string& m) {
    if (status == kOk) {
      status = s;
      msg = m;
    }
    return false;
  }
};

// ------------------------------------------------------------ Huffman

struct Huff {
  bool defined = false;
  uint8_t look_len[256];
  uint8_t look_val[256];
  int maxcode[18];
  int mincode[17];
  int valptr[17];
  uint8_t vals[256];
};

bool build_huff(Huff& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(t.look_len, 0, sizeof t.look_len);
  std::memcpy(t.vals, vals, nvals);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    t.valptr[l] = k;
    t.mincode[l] = code;
    for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
      if (l <= 8) {
        int shift = 8 - l;
        for (int j = 0; j < (1 << shift); ++j) {
          t.look_len[(code << shift) | j] = (uint8_t)l;
          t.look_val[(code << shift) | j] = vals[k];
        }
      }
    }
    t.maxcode[l] = counts[l - 1] ? code - 1 : -1;
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  t.defined = true;
  return true;
}

// ---------------------------------------------------------- bit reader

struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // bits left-aligned at bit 63
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0) {
            b = 0xFF;
            p += 2;
          } else {
            at_marker = true;  // p stays on the marker; feed zeros, as libjpeg
          }
        } else {
          b = *p++;
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    fill();
    int v = (int)(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  int decode(const Huff& t) {
    fill();
    int look = (int)(buf >> 56);
    int l = t.look_len[look];
    if (l) {
      buf <<= l;
      cnt -= l;
      return t.look_val[look];
    }
    for (l = 9; l <= 16; ++l) {
      int code = (int)(buf >> (64 - l));
      if (code <= t.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return t.vals[t.valptr[l] + code - t.mincode[l]];
      }
    }
    buf <<= 16;  // corrupt data: libjpeg warns and decodes 0
    cnt -= 16;
    return 0;
  }
  // drop the buffered bits and step past the next marker if it is a RSTn
  void restart() {
    buf = 0;
    cnt = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) ++p;
    if (p + 1 < end) p += 2;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------------- ISLOW IDCT

const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// jdmaster.c prepare_range_limit_table, post-IDCT half: sample of x & 1023
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; ++v)
      t[v] = v < 128 ? (uint8_t)(v + 128) : v < 512 ? 255 : v < 896 ? 0 : (uint8_t)(v - 896);
  }
};
const RangeLimit kRange;

// one 8x8 block of coefficients (natural order) and its quantization table
// -> 8x8 samples at out (row stride `stride`), as jpeg_idct_islow
void idct_islow(const int16_t* coef, const int* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = (int)(in[0] * qt[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
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
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, sh);
    w[56] = (int)descale(tmp10 - tmp3, sh);
    w[8] = (int)descale(tmp11 + tmp2, sh);
    w[48] = (int)descale(tmp11 - tmp2, sh);
    w[16] = (int)descale(tmp12 + tmp1, sh);
    w[40] = (int)descale(tmp12 - tmp1, sh);
    w[24] = (int)descale(tmp13 + tmp0, sh);
    w[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = kRange.t[(int)descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

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
    o[0] = kRange.t[(int)descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.t[(int)descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.t[(int)descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.t[(int)descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.t[(int)descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.t[(int)descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.t[(int)descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.t[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ---------------------------------------------------------------- decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;  // samples of the component inside the image
  int bw = 0, bh = 0;  // blocks of its plane (whole MCUs)
  int pred = 0;
  std::vector<uint8_t> plane;
};

struct Header {
  int width = 0, height = 0, ncomp = 0, sof = 0, precision = 8;
  int exif_off = -1, exif_len = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart = 0;
  int hmax = 1, vmax = 1;
  Component comp[4];
  int qt[4][64];
  bool qdef[4] = {false, false, false, false};
  Huff dc[4], ac[4];
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

const char* sof_name(int m) {
  switch (m) {
    case 0xC0: return "SOF0 baseline";
    case 0xC1: return "SOF1 extended sequential";
    case 0xC2: return "SOF2 progressive";
    case 0xC3: return "SOF3 lossless";
    case 0xC5: return "SOF5 differential sequential";
    case 0xC6: return "SOF6 differential progressive";
    case 0xC7: return "SOF7 differential lossless";
    case 0xC9: return "SOF9 arithmetic sequential";
    case 0xCA: return "SOF10 arithmetic progressive";
    case 0xCB: return "SOF11 arithmetic lossless";
    case 0xCD: return "SOF13 arithmetic differential sequential";
    case 0xCE: return "SOF14 arithmetic differential progressive";
    case 0xCF: return "SOF15 arithmetic differential lossless";
  }
  return "unknown SOF";
}

bool parse_sof(Header& hd, const uint8_t* s, int len, int marker, Error& err) {
  hd.sof = marker;
  if (len < 6) return err.fail(kCorrupt, "short SOF segment");
  hd.precision = s[0];
  hd.height = be16(s + 1);
  hd.width = be16(s + 3);
  hd.ncomp = s[5];
  if (marker != 0xC0 && marker != 0xC1)
    return err.fail(kUnsupported, std::string(sof_name(marker)) + " is not read");
  if (hd.precision != 8)
    return err.fail(kUnsupported, std::to_string(hd.precision) + "-bit samples are not read");
  if (hd.ncomp != 1 && hd.ncomp != 3)
    return err.fail(kUnsupported,
                    std::to_string(hd.ncomp) + " components (CMYK / YCCK) are not read");
  if (hd.width == 0 || hd.height == 0)
    return err.fail(kUnsupported, "a height given by a DNL marker is not read");
  if (len < 6 + 3 * hd.ncomp) return err.fail(kCorrupt, "short SOF segment");
  hd.hmax = hd.vmax = 1;
  for (int i = 0; i < hd.ncomp; ++i) {
    Component& c = hd.comp[i];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i] & 3;
    if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
      return err.fail(kUnsupported, "sampling factors above 2 are not read");
    hd.hmax = std::max(hd.hmax, c.h);
    hd.vmax = std::max(hd.vmax, c.v);
  }
  for (int i = 0; i < hd.ncomp; ++i) {
    Component& c = hd.comp[i];
    int rh = hd.hmax / c.h, rv = hd.vmax / c.v;
    if (!((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2)))
      return err.fail(kUnsupported, "sampling other than 4:4:4, 4:2:2 and 4:2:0 is not read");
    int mcux = (hd.width + 8 * hd.hmax - 1) / (8 * hd.hmax);
    int mcuy = (hd.height + 8 * hd.vmax - 1) / (8 * hd.vmax);
    c.dw = (hd.width * c.h + hd.hmax - 1) / hd.hmax;
    c.dh = (hd.height * c.v + hd.vmax - 1) / hd.vmax;
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
  }
  return true;
}

// walk the markers up to the first SOS (or EOI); stops at the frame header
// when `frame_only`
bool parse_markers(Header& hd, const uint8_t* d, size_t n, size_t& pos, bool frame_only,
                   Error& err, int* sos_marker) {
  while (pos + 1 < n) {
    if (d[pos] != 0xFF) {  // garbage between segments: skip, as libjpeg does
      ++pos;
      continue;
    }
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) break;
    int m = d[pos++];
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xD9) {
      *sos_marker = 0xD9;
      return true;
    }
    if (pos + 2 > n) return err.fail(kCorrupt, "truncated marker segment");
    int len = be16(d + pos);
    if (len < 2 || pos + len > n) return err.fail(kCorrupt, "truncated marker segment");
    const uint8_t* s = d + pos + 2;
    int sl = len - 2;
    if (m == 0xDA) {
      *sos_marker = 0xDA;
      pos += 2;  // pos now at the SOS segment's body
      return true;
    }
    if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (!parse_sof(hd, s, sl, m, err)) return false;
      if (frame_only) {
        pos += len;
        *sos_marker = m;
        return true;
      }
    } else if (m == 0xDB) {
      int i = 0;
      while (i < sl) {
        int pq = s[i] >> 4, tq = s[i] & 3;
        int sz = pq ? 128 : 64;
        if (i + 1 + sz > sl) return err.fail(kCorrupt, "short DQT segment");
        for (int k = 0; k < 64; ++k)
          hd.qt[tq][kNatural[k]] = pq ? be16(s + i + 1 + 2 * k) : s[i + 1 + k];
        hd.qdef[tq] = true;
        i += 1 + sz;
      }
    } else if (m == 0xC4) {
      int i = 0;
      while (i + 17 <= sl) {
        int tc = s[i] >> 4, th = s[i] & 3;
        int total = 0;
        for (int k = 0; k < 16; ++k) total += s[i + 1 + k];
        if (total > 256 || i + 17 + total > sl) return err.fail(kCorrupt, "bad DHT segment");
        Huff& t = tc ? hd.ac[th] : hd.dc[th];
        if (!build_huff(t, s + i + 1, s + i + 17, total))
          return err.fail(kCorrupt, "bad Huffman table");
        i += 17 + total;
      }
    } else if (m == 0xDD) {
      if (sl < 2) return err.fail(kCorrupt, "short DRI segment");
      hd.restart = be16(s);
    } else if (m == 0xE0) {
      if (sl >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) hd.jfif = true;
    } else if (m == 0xE1) {
      if (hd.exif_off < 0 && sl >= 6 && std::memcmp(s, "Exif\0\0", 6) == 0) {
        hd.exif_off = (int)(s + 6 - d);
        hd.exif_len = sl - 6;
      }
    } else if (m == 0xEE) {
      if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        hd.adobe = true;
        hd.adobe_transform = s[11];
      }
    }
    pos += len;
  }
  *sos_marker = 0;
  return true;
}

bool decode_scan(Header& hd, const uint8_t* d, size_t n, size_t& pos, Error& err) {
  if (!hd.ncomp) return err.fail(kCorrupt, "SOS before SOF");
  int len = be16(d + pos - 2);
  const uint8_t* s = d + pos;
  int ns = s[0];
  if (ns < 1 || ns > hd.ncomp || len < 6 + 2 * ns) return err.fail(kCorrupt, "bad SOS segment");
  Component* sc[4];
  for (int i = 0; i < ns; ++i) {
    int id = s[1 + 2 * i];
    sc[i] = nullptr;
    for (int c = 0; c < hd.ncomp; ++c)
      if (hd.comp[c].id == id) sc[i] = &hd.comp[c];
    if (!sc[i]) return err.fail(kCorrupt, "SOS names an unknown component");
    sc[i]->td = s[2 + 2 * i] >> 4;
    sc[i]->ta = s[2 + 2 * i] & 3;
    if (!hd.dc[sc[i]->td].defined || !hd.ac[sc[i]->ta].defined)
      return err.fail(kCorrupt, "SOS uses an undefined Huffman table");
    if (!hd.qdef[sc[i]->tq]) return err.fail(kCorrupt, "undefined quantization table");
    sc[i]->pred = 0;
    if (sc[i]->plane.empty()) sc[i]->plane.assign((size_t)sc[i]->bw * sc[i]->bh * 64, 0);
  }
  pos += len - 2;
  Bits bits{d + pos, d + n};

  int16_t coef[64];
  auto block = [&](Component& c, int bx, int by) {
    std::memset(coef, 0, sizeof coef);
    int t = bits.decode(hd.dc[c.td]);
    int diff = t ? extend(bits.get(t), t) : 0;
    c.pred += diff;
    coef[0] = (int16_t)c.pred;
    const Huff& ac = hd.ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = bits.decode(ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        coef[kNatural[std::min(k, 79)]] = (int16_t)extend(bits.get(sz), sz);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, hd.qt[c.tq], c.plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
  };

  int left = hd.restart;
  auto restart_point = [&]() {
    if (!hd.restart) return;
    if (left == 0) {
      bits.restart();
      for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      left = hd.restart;
    }
    --left;
  };
  if (ns == 1) {
    Component& c = *sc[0];
    int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx) {
        restart_point();
        block(c, bx, by);
      }
  } else {
    int mcux = (hd.width + 8 * hd.hmax - 1) / (8 * hd.hmax);
    int mcuy = (hd.height + 8 * hd.vmax - 1) / (8 * hd.vmax);
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        restart_point();
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) block(c, mx * c.h + h, my * c.v + v);
        }
      }
  }
  // continue the marker walk at the next marker after the entropy-coded data
  const uint8_t* p = bits.p;
  while (p + 1 < d + n && !(p[0] == 0xFF && p[1] != 0 && !(p[1] >= 0xD0 && p[1] <= 0xD7)))
    ++p;
  pos = (size_t)(p - d);
  return true;
}

// the component at full resolution over the image: (H, W), jdsample.c's rules
void upsample(const Header& hd, const Component& c, uint8_t* up) {
  const int W = hd.width, H = hd.height;
  const int rh = hd.hmax / c.h, rv = hd.vmax / c.v;
  const int stride = c.bw * 8;
  const uint8_t* pl = c.plane.data();
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(up + (size_t)y * W, pl + (size_t)y * stride, W);
    return;
  }
  const int dw = c.dw, dh = c.dh;
  if (dw <= 2) {  // h2v1_upsample / h2v2_upsample: replication
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) up[(size_t)y * W + x] = pl[(size_t)(y / rv) * stride + x / rh];
    return;
  }
  if (rv == 1) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = pl + (size_t)y * stride;
      uint8_t* o = up + (size_t)y * W;
      for (int x = 0; x < W; ++x) {
        int cc = x >> 1;
        int v;
        if (!(x & 1))
          v = cc == 0 ? in[0] : (in[cc] * 3 + in[cc - 1] + 1) >> 2;
        else
          v = cc == dw - 1 ? in[cc] : (in[cc] * 3 + in[cc + 1] + 2) >> 2;
        o[x] = (uint8_t)v;
      }
    }
    return;
  }
  // h2v2_fancy_upsample; the rows above the first and below the last real
  // row repeat them (jdmainct.c's context pointers)
  std::vector<int> sum(dw);
  for (int y = 0; y < H; ++y) {
    int i = y >> 1;
    int j = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
    const uint8_t* in0 = pl + (size_t)i * stride;
    const uint8_t* in1 = pl + (size_t)j * stride;
    for (int cc = 0; cc < dw; ++cc) sum[cc] = in0[cc] * 3 + in1[cc];
    uint8_t* o = up + (size_t)y * W;
    for (int x = 0; x < W; ++x) {
      int cc = x >> 1;
      int v;
      if (!(x & 1))
        v = cc == 0 ? (sum[0] * 4 + 8) >> 4 : (sum[cc] * 3 + sum[cc - 1] + 8) >> 4;
      else
        v = cc == dw - 1 ? (sum[cc] * 4 + 7) >> 4 : (sum[cc] * 3 + sum[cc + 1] + 7) >> 4;
      o[x] = (uint8_t)v;
    }
  }
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

bool read_header(const uint8_t* d, size_t n, Header& hd, Error& err) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return err.fail(kCorrupt, "not a JPEG file");
  size_t pos = 2;
  int m = 0;
  if (!parse_markers(hd, d, n, pos, true, err, &m)) return false;
  if (!hd.sof) return err.fail(kCorrupt, "no frame header");
  return true;
}

}  // namespace

extern "C" {

// info: width, height, components, SOF marker, Exif TIFF offset (-1 if
// none), its length. Returns 0, 1 (unsupported; info[3] names the SOF) or 2
// (not a readable JPEG); err gets a message.
int a3r_jpeg_header(const uint8_t* data, long long n, int* info, char* err_out, int err_len) {
  Header hd;
  Error err;
  bool ok = read_header(data, (size_t)n, hd, err);
  info[0] = hd.width;
  info[1] = hd.height;
  info[2] = hd.ncomp;
  info[3] = hd.sof;
  info[4] = hd.exif_off;
  info[5] = hd.exif_len;
  if (!ok) std::snprintf(err_out, err_len, "%s", err.msg.c_str());
  return ok ? kOk : err.status;
}

// decode into out: (H, W) for one component, (H, W, 3) RGB for three
int a3r_jpeg_decode(const uint8_t* data, long long n, uint8_t* out, char* err_out, int err_len) {
  Header hd;
  Error err;
  const uint8_t* d = data;
  size_t pos = 2;
  bool ok = read_header(d, (size_t)n, hd, err);
  if (ok) {
    pos = 2;
    int m = 0;
    bool scanned = false;
    while (ok) {
      ok = parse_markers(hd, d, (size_t)n, pos, false, err, &m);
      if (!ok || m != 0xDA) break;
      ok = decode_scan(hd, d, (size_t)n, pos, err);
      scanned = true;
    }
    if (ok && !scanned) ok = err.fail(kCorrupt, "no scan");
  }
  if (!ok) {
    std::snprintf(err_out, err_len, "%s", err.msg.c_str());
    return err.status;
  }
  const int W = hd.width, H = hd.height;
  for (int c = 0; c < hd.ncomp; ++c)
    if (hd.comp[c].plane.empty()) hd.comp[c].plane.assign((size_t)hd.comp[c].bw * hd.comp[c].bh * 64, 0);
  if (hd.ncomp == 1) {
    upsample(hd, hd.comp[0], out);
    return kOk;
  }
  std::vector<uint8_t> up[3];
  for (int c = 0; c < 3; ++c) {
    up[c].resize((size_t)W * H);
    upsample(hd, hd.comp[c], up[c].data());
  }
  bool rgb;
  if (hd.jfif)
    rgb = false;
  else if (hd.adobe)
    rgb = hd.adobe_transform == 0;
  else
    rgb = hd.comp[0].id == 82 && hd.comp[1].id == 71 && hd.comp[2].id == 66;
  const size_t np = (size_t)W * H;
  for (size_t i = 0; i < np; ++i) {
    int y = up[0][i], cb = up[1][i], cr = up[2][i];
    uint8_t* o = out + 3 * i;
    if (rgb) {
      o[0] = (uint8_t)y;
      o[1] = (uint8_t)cb;
      o[2] = (uint8_t)cr;
      continue;
    }
    o[0] = clamp255(y + kColor.cr_r[cr]);
    o[1] = clamp255(y + (int)((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
    o[2] = clamp255(y + kColor.cb_b[cb]);
  }
  return kOk;
}

}  // extern "C"

// ---------------------------------------------------------------- encoder

namespace {

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct ECode {
  uint16_t code[256];
  uint8_t size[256];
  ECode(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof size);
    int code_ = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code_) {
        code[vals[k]] = (uint16_t)code_;
        size[vals[k]] = (uint8_t)l;
      }
      code_ <<= 1;
    }
  }
};

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nbits = 0;
  void byte(int b) { out.push_back((uint8_t)b); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 255);
  }
  void bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++nbits == 8) {
        out.push_back((uint8_t)acc);
        if (acc == 0xFF) out.push_back(0);
        acc = 0;
        nbits = 0;
      }
    }
  }
  void flush() {
    while (nbits) bits(1, 1);
  }
};

void quality_table(const uint8_t* base, int quality, uint8_t* q) {
  quality = std::max(1, std::min(100, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)base[i] * scale + 50) / 100;
    q[i] = (uint8_t)std::max(1L, std::min(255L, t));
  }
}

struct Dct {
  double c[8][8];
  Dct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u ? std::sqrt(0.25) : std::sqrt(0.125)) * std::cos((2 * x + 1) * u * M_PI / 16);
  }
};
const Dct kDct;

void encode_block(Writer& w, const uint8_t* src, int stride, const uint8_t* q, int& pred,
                  const ECode& dc, const ECode& ac) {
  double f[8][8], t[8][8];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) f[y][x] = src[(size_t)y * stride + x] - 128.0;
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int x = 0; x < 8; ++x) s += kDct.c[u][x] * f[y][x];
      t[y][u] = s;
    }
  int z[64];
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int y = 0; y < 8; ++y) s += kDct.c[v][y] * t[y][u];
      z[v * 8 + u] = (int)std::lround(s / q[v * 8 + u]);
    }
  auto put = [&](const ECode& tab, int sym) { w.bits(tab.code[sym], tab.size[sym]); };
  auto magnitude = [](int v, int& bits) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
      ++n;
      a >>= 1;
    }
    bits = v < 0 ? v + (1 << n) - 1 : v;
    return n;
  };
  int diff = z[0] - pred, bits;
  pred = z[0];
  int n = magnitude(diff, bits);
  put(dc, n);
  w.bits((uint32_t)bits, n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = z[kNatural[k]];
    if (!v) {
      ++run;
      continue;
    }
    while (run > 15) {
      put(ac, 0xF0);
      run -= 16;
    }
    n = magnitude(v, bits);
    put(ac, (run << 4) | n);
    w.bits((uint32_t)bits, n);
    run = 0;
  }
  if (run) put(ac, 0x00);
}

}  // namespace

extern "C" {

// img: (h, w) gray or (h, w, 3) RGB uint8; sub: 0 4:4:4, 1 4:2:2, 2 4:2:0.
// *out is malloc'd (free it with a3r_jpeg_free). Returns 0, or 2 for bad
// arguments.
int a3r_jpeg_encode(const uint8_t* img, int w, int h, int nc, int quality, int sub,
                    uint8_t** out, long long* out_len) {
  if (w < 1 || h < 1 || w > 65535 || h > 65535 || (nc != 1 && nc != 3) || sub < 0 || sub > 2)
    return kCorrupt;
  const int hmax = nc == 3 && sub ? 2 : 1, vmax = nc == 3 && sub == 2 ? 2 : 1;
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  const int PW = mcux * 8 * hmax, PH = mcuy * 8 * vmax;
  // full-resolution planes over whole MCUs, the edges repeated
  std::vector<uint8_t> full[3];
  for (int c = 0; c < nc; ++c) full[c].resize((size_t)PW * PH);
  for (int y = 0; y < PH; ++y)
    for (int x = 0; x < PW; ++x) {
      const uint8_t* p = img + ((size_t)std::min(y, h - 1) * w + std::min(x, w - 1)) * nc;
      size_t i = (size_t)y * PW + x;
      if (nc == 1) {
        full[0][i] = p[0];
        continue;
      }
      const int64_t r = p[0], g = p[1], b = p[2], half = 1 << 15, off = (int64_t)128 << 16;
      auto fix = [](double v) { return (int64_t)(v * 65536 + 0.5); };
      full[0][i] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16);
      full[1][i] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16);
      full[2][i] = (uint8_t)((fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16);
    }
  // chroma planes: box averages with libjpeg's alternating bias
  const int CW = PW / hmax, CH = PH / vmax;
  std::vector<uint8_t> chroma[3];
  for (int c = 1; c < nc; ++c) {
    if (hmax == 1) {
      chroma[c] = full[c];
      continue;
    }
    chroma[c].resize((size_t)CW * CH);
    for (int y = 0; y < CH; ++y)
      for (int x = 0; x < CW; ++x) {
        const uint8_t* r0 = full[c].data() + (size_t)(y * vmax) * PW + 2 * x;
        int v;
        if (vmax == 2) {
          const uint8_t* r1 = r0 + PW;
          v = (r0[0] + r0[1] + r1[0] + r1[1] + 1 + (x & 1)) >> 2;
        } else {
          v = (r0[0] + r0[1] + (x & 1)) >> 1;
        }
        chroma[c][(size_t)y * CW + x] = (uint8_t)v;
      }
  }
  uint8_t ql[64], qc[64];
  quality_table(kStdLumaQ, quality, ql);
  quality_table(kStdChromaQ, quality, qc);
  static const ECode dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals),
      dcc(kDcChromaBits, kDcVals), acc(kAcChromaBits, kAcChromaVals);

  Writer wr;
  wr.word(0xFFD8);
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  wr.word(0xFFE0);
  wr.word(2 + sizeof jfif);
  for (uint8_t b : jfif) wr.byte(b);
  const int nq = nc == 3 ? 2 : 1;
  wr.word(0xFFDB);
  wr.word(2 + 65 * nq);
  for (int t = 0; t < nq; ++t) {
    wr.byte(t);
    for (int k = 0; k < 64; ++k) wr.byte((t ? qc : ql)[kNatural[k]]);
  }
  wr.word(0xFFC0);
  wr.word(8 + 3 * nc);
  wr.byte(8);
  wr.word(h);
  wr.word(w);
  wr.byte(nc);
  for (int c = 0; c < nc; ++c) {
    wr.byte(c + 1);
    wr.byte(c ? 0x11 : (hmax << 4) | vmax);
    wr.byte(c ? 1 : 0);
  }
  auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
    int total = 0;
    for (int k = 0; k < 16; ++k) total += bits[k];
    wr.word(0xFFC4);
    wr.word(2 + 17 + total);
    wr.byte((cls << 4) | id);
    for (int k = 0; k < 16; ++k) wr.byte(bits[k]);
    for (int k = 0; k < total; ++k) wr.byte(vals[k]);
  };
  dht(0, 0, kDcLumaBits, kDcVals);
  dht(1, 0, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    dht(0, 1, kDcChromaBits, kDcVals);
    dht(1, 1, kAcChromaBits, kAcChromaVals);
  }
  wr.word(0xFFDA);
  wr.word(6 + 2 * nc);
  wr.byte(nc);
  for (int c = 0; c < nc; ++c) {
    wr.byte(c + 1);
    wr.byte(c ? 0x11 : 0x00);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);
  int pred[3] = {0, 0, 0};
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      for (int v = 0; v < vmax; ++v)
        for (int hh = 0; hh < hmax; ++hh) {
          int x0 = (mx * hmax + hh) * 8, y0 = (my * vmax + v) * 8;
          encode_block(wr, full[0].data() + (size_t)y0 * PW + x0, PW, ql, pred[0], dcl, acl);
        }
      for (int c = 1; c < nc; ++c)
        encode_block(wr, chroma[c].data() + (size_t)(my * 8) * CW + mx * 8, CW, qc, pred[c],
                     dcc, acc);
    }
  wr.flush();
  wr.word(0xFFD9);
  *out_len = (long long)wr.out.size();
  *out = (uint8_t*)std::malloc(wr.out.size());
  if (!*out) return kCorrupt;
  std::memcpy(*out, wr.out.data(), wr.out.size());
  return kOk;
}

void a3r_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
