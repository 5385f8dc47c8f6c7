// Baseline JPEG decoder, host code with a plain C interface, written to
// give byte for byte what libjpeg-turbo gives with its decompression
// defaults (as Pillow runs it): sequential Huffman-coded 8-bit frames
// (SOF0 / SOF1) of 1 or 3 components, sampling factors 1 or 2 on each
// axis, restart intervals, any number of sequential scans; the "islow"
// integer IDCT (jidctint.c, in the widths of its x86-64 SIMD form), fancy
// upsampling (jdsample.c's triangle filters, not the merged upsampler) and
// jdcolor.c's fixed-point YCbCr -> RGB. Greyscale is copied to three channels.
//
//   p3d_jpeg_decode(data, n, out, width, height) -> 0 or an error code
//
// decodes the n bytes at data into out, an HWC uint8 RGB buffer of
// width x height (the caller reads the frame header first and allocates
// it). The error codes are listed in `enum Err`; utils/jpeg.py names them.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Err {
  OK = 0,
  E_NOT_JPEG = 1,      // no SOI marker
  E_TRUNCATED = 2,     // a segment runs past the end of the data
  E_PROGRESSIVE = 3,   // SOF2 / SOF6
  E_ARITHMETIC = 4,    // SOF9-11, 13-15
  E_LOSSLESS = 5,      // SOF3 / SOF7
  E_HIERARCHICAL = 6,  // SOF5-7, DHP, EXP
  E_PRECISION = 7,     // sample precision other than 8
  E_COMPONENTS = 8,    // component count other than 1 or 3
  E_SAMPLING = 9,      // a sampling factor outside 1-2
  E_BAD_DATA = 10,     // a malformed segment or entropy-coded data
  E_NO_FRAME = 11,     // SOS before SOF, or no SOS
  E_SIZE = 12,         // the caller's size differs from the frame's
  E_TABLE = 13,        // a scan uses a table that was never defined
  E_DNL = 14,          // height 0 (defined by a DNL marker)
};

// zigzag index -> natural index, 16 extra entries for a corrupt run
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  uint8_t vals[256];
  int maxcode[18];    // largest code of each length, -1 if none
  int valptr[17];     // index into vals of the first code of each length
  int mincode[17];
  uint16_t look[512];  // 9-bit prefix -> (length << 8) | symbol, 0 if longer
};

bool build_huff(Huff& h, const uint8_t* counts, const uint8_t* symbols,
                int nsym) {
  if (nsym > 256) return false;
  std::memcpy(h.vals, symbols, nsym);
  std::memset(h.look, 0, sizeof(h.look));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    const int n = counts[len - 1];
    if (n) {
      h.valptr[len] = k;
      h.mincode[len] = code;
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (len <= 9) {
          const int shift = 9 - len;
          for (int f = 0; f < (1 << shift); ++f)
            h.look[(code << shift) | f] = uint16_t((len << 8) | h.vals[k]);
        }
      }
      h.maxcode[len] = code - 1;
      if (code > (1 << len)) return false;
    } else {
      h.maxcode[len] = -1;
    }
    code <<= 1;
  }
  h.maxcode[17] = 0x7FFFFFFF;
  h.defined = true;
  return true;
}

// Entropy-coded data reader: bytes left-aligned in a 64-bit accumulator,
// 0xFF 0x00 unstuffed; at a marker it stops and supplies zero bits (as
// libjpeg does).
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      unsigned b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const unsigned nb = (p + 1 < end) ? p[1] : 0xD9;
          if (nb == 0x00) {
            p += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= uint64_t(b) << (56 - n);
      n += 8;
    }
  }
  int get(int k) {  // k in 1..16
    if (n < k) fill();
    const int v = int(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }
  void reset() {
    acc = 0;
    n = 0;
    at_marker = false;
  }
};

inline int decode(Bits& b, const Huff& h) {
  if (b.n < 16) b.fill();
  const uint16_t e = h.look[b.acc >> 55];
  if (e) {
    const int len = e >> 8;
    b.acc <<= len;
    b.n -= len;
    return e & 0xFF;
  }
  const int peek = int(b.acc >> 48);
  for (int len = 10; len <= 16; ++len) {
    const int code = peek >> (16 - len);
    if (h.maxcode[len] >= 0 && code <= h.maxcode[len] &&
        code >= h.mincode[len]) {
      b.acc <<= len;
      b.n -= len;
      return h.vals[h.valptr[len] + code - h.mincode[len]];
    }
  }
  return -1;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Comp {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int dw, dh;          // downsampled size (jdinput.c)
  int bw, bh;          // plane size in blocks
  std::vector<uint8_t> plane;  // bw * 8 x bh * 8 samples
  int pred = 0;
};

// The "islow" IDCT (jidctint.c's algorithm: CONST_BITS 13, PASS1_BITS 2)
// in the integer widths of libjpeg-turbo's x86-64 SIMD form, which Pillow
// runs: the dequantised coefficients, in0 +- in4 and the odd part's z3 =
// in7 + in3, z4 = in5 + in1 wrap in 16 bits; products and sums wrap in 32;
// each pass's outputs saturate to 16 bits, the result to [-128, 127] (the
// C form's range-limit table wraps there instead); a block whose
// coefficient rows 1-7 are zero takes pass 1 as the DC shifted left in 16
// bits. For any block an encoder of 8-bit samples writes, this equals the
// C form.
inline int32_t wrap16(int64_t x) { return int16_t(uint16_t(uint64_t(x))); }
inline int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : x > 32767 ? 32767 : x;
}

// one 1-D pass on x[0..7] (16-bit values) at stride `step` in, outputs at
// stride `ostep`, descaled by `shift` and saturated to 16 bits
inline void idct_1d(const int32_t* x, int step, int32_t* o, int ostep,
                    int shift) {
  const int64_t i0 = x[0], i1 = x[step], i2 = x[2 * step],
                i3 = x[3 * step], i4 = x[4 * step], i5 = x[5 * step],
                i6 = x[6 * step], i7 = x[7 * step];
  const int64_t t0 = wrap16(i0 + i4) * 8192, t1 = wrap16(i0 - i4) * 8192;
  const int64_t tmp3 = i2 * (4433 + 6270) + i6 * 4433;
  const int64_t tmp2 = i2 * 4433 + i6 * (4433 - 15137);
  const int64_t t10 = t0 + tmp3, t13 = t0 - tmp3, t11 = t1 + tmp2,
                t12 = t1 - tmp2;
  const int64_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
  const int64_t z3p = z3 * (9633 - 16069) + z4 * 9633;
  const int64_t z4p = z3 * 9633 + z4 * (9633 - 3196);
  const int64_t o0 = i7 * (2446 - 7373) + i1 * -7373 + z3p;
  const int64_t o1 = i5 * (16819 - 20995) + i3 * -20995 + z4p;
  const int64_t o2 = i5 * -20995 + i3 * (25172 - 20995) + z3p;
  const int64_t o3 = i7 * -7373 + i1 * (12299 - 7373) + z4p;
  const int64_t r = int64_t(1) << (shift - 1);
  const int64_t v[8] = {t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                        t13 - o0, t12 - o1, t11 - o2, t10 - o3};
  for (int k = 0; k < 8; ++k)
    o[k * ostep] = sat16(int32_t(uint32_t(uint64_t(v[k] + r))) >> shift);
}

// coef: 64 coefficients (natural order, 16-bit), q their quantisers
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t deq[64], ws[64], px[64];
  bool ac = false;
  for (int k = 0; k < 64; ++k) {
    deq[k] = wrap16(int64_t(coef[k]) * q[k]);
    if (k >= 8 && coef[k]) ac = true;
  }
  if (ac) {
    for (int c = 0; c < 8; ++c) idct_1d(deq + c, 8, ws + c, 8, 11);
  } else {
    for (int c = 0; c < 8; ++c) {
      const int32_t dc = wrap16(int64_t(deq[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
    }
  }
  for (int r = 0; r < 8; ++r) idct_1d(ws + 8 * r, 1, px + 8 * r, 1, 18);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      const int32_t v = px[8 * r + c];
      out[r * stride + c] = uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) +
                                    128);
    }
}

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Comp> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;

  int u16(const uint8_t* q) { return (q[0] << 8) | q[1]; }

  int parse_sof(const uint8_t* s, int len, int marker) {
    if (marker == 0xC2 || marker == 0xC6) return E_PROGRESSIVE;
    if (marker == 0xC3 || marker == 0xC7) return E_LOSSLESS;
    if (marker == 0xC5) return E_HIERARCHICAL;
    if (marker >= 0xC9) return E_ARITHMETIC;
    if (len < 6) return E_BAD_DATA;
    if (s[0] != 8) return E_PRECISION;
    height = u16(s + 1);
    width = u16(s + 3);
    const int nc = s[5];
    if (height == 0) return E_DNL;
    if (width == 0) return E_BAD_DATA;
    if (nc != 1 && nc != 3) return E_COMPONENTS;
    if (len < 6 + 3 * nc) return E_BAD_DATA;
    comps.resize(nc);
    hmax = vmax = 1;
    for (int i = 0; i < nc; ++i) {
      Comp& c = comps[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2) return E_SAMPLING;
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Comp& c : comps) {
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.plane.assign(size_t(c.bw) * 8 * size_t(c.bh) * 8, 0);
    }
    frame = true;
    return OK;
  }

  int parse_dqt(const uint8_t* s, int len) {
    int i = 0;
    while (i < len) {
      const int pq = s[i] >> 4, tq = s[i] & 15;
      if (tq > 3 || pq > 1) return E_BAD_DATA;
      const int n = pq ? 128 : 64;
      if (i + 1 + n > len) return E_BAD_DATA;
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] =
            uint16_t(pq ? u16(s + i + 1 + 2 * k) : s[i + 1 + k]);
      qt_defined[tq] = true;
      i += 1 + n;
    }
    return OK;
  }

  int parse_dht(const uint8_t* s, int len) {
    int i = 0;
    while (i < len) {
      if (i + 17 > len) return E_BAD_DATA;
      const int tc = s[i] >> 4, th = s[i] & 15;
      if (tc > 1 || th > 3) return E_BAD_DATA;
      int nsym = 0;
      for (int k = 0; k < 16; ++k) nsym += s[i + 1 + k];
      if (i + 17 + nsym > len) return E_BAD_DATA;
      if (!build_huff(tc ? ac[th] : dc[th], s + i + 1, s + i + 17, nsym))
        return E_BAD_DATA;
      i += 17 + nsym;
    }
    return OK;
  }

  // one block: Huffman-decode, then IDCT with its table into the plane
  int block(Bits& b, Comp& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huff& hd = dc[c.dc_tbl];
    const Huff& ha = ac[c.ac_tbl];
    int s = decode(b, hd);
    if (s < 0 || s > 11) return E_BAD_DATA;
    if (s) {
      const int r = b.get(s);
      c.pred += extend(r, s);
    }
    coef[0] = int16_t(c.pred);  // JCOEF is 16-bit
    for (int k = 1; k < 64; ++k) {
      const int rs = decode(b, ha);
      if (rs < 0) return E_BAD_DATA;
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (s > 10) return E_BAD_DATA;
        coef[kNatural[k]] = int16_t(extend(b.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    const int stride = c.bw * 8;
    idct_islow(coef, qt[c.tq],
               c.plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
    return OK;
  }

  int scan(const uint8_t* s, int len) {
    if (!frame) return E_NO_FRAME;
    if (len < 1) return E_BAD_DATA;
    const int ns = s[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return E_BAD_DATA;
    std::vector<Comp*> sc;
    for (int i = 0; i < ns; ++i) {
      Comp* c = nullptr;
      for (Comp& k : comps)
        if (k.id == s[1 + 2 * i]) c = &k;
      if (!c) return E_BAD_DATA;
      c->dc_tbl = s[2 + 2 * i] >> 4;
      c->ac_tbl = s[2 + 2 * i] & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3 || !dc[c->dc_tbl].defined ||
          !ac[c->ac_tbl].defined || !qt_defined[c->tq])
        return E_TABLE;
      c->pred = 0;
      sc.push_back(c);
    }
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahl = s[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahl != 0) return E_PROGRESSIVE;
    Bits b;
    b.p = p;
    b.end = end;
    // a scan of one component is not interleaved: an MCU is one block,
    // over the component's own size in blocks
    const bool single = ns == 1;
    const int nx = single ? (sc[0]->dw + 7) / 8 : mcux;
    const int ny = single ? (sc[0]->dh + 7) / 8 : mcuy;
    const long long total = (long long)nx * ny;
    int next_rst = 0;
    for (long long m = 0; m < total; ++m) {
      if (restart && m > 0 && m % restart == 0) {
        // discard the partial byte, find RSTn, reset the predictors
        b.reset();
        while (b.p + 1 < end && b.p[0] == 0xFF && b.p[1] == 0xFF) ++b.p;
        if (b.p + 1 < end && b.p[0] == 0xFF &&
            b.p[1] == 0xD0 + next_rst) {
          b.p += 2;
        }
        next_rst = (next_rst + 1) & 7;
        for (Comp* c : sc) c->pred = 0;
      }
      const int mx = int(m % nx), my = int(m / nx);
      if (single) {
        const int err = block(b, *sc[0], mx, my);
        if (err) return err;
      } else {
        for (Comp* c : sc)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h) {
              const int err = block(b, *c, mx * c->h + h, my * c->v + v);
              if (err) return err;
            }
      }
    }
    p = b.p;
    return OK;
  }

  int run() {
    p = data;
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) return E_NOT_JPEG;
    p += 2;
    bool scanned = false;
    for (;;) {
      // the next marker, past any fill bytes or stray data
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) break;
      const int marker = *p++;
      if (marker == 0xD9) break;  // EOI
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (end - p < 2) return E_TRUNCATED;
      const int len = u16(p) - 2;
      if (len < 0 || end - p - 2 < len) return E_TRUNCATED;
      const uint8_t* s = p + 2;
      p += 2 + len;
      int err = OK;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
          marker != 0xC8 && marker != 0xCC) {
        if (frame) return E_BAD_DATA;
        err = parse_sof(s, len, marker);
      } else if (marker == 0xC4) {
        err = parse_dht(s, len);
      } else if (marker == 0xCC) {
        err = E_ARITHMETIC;
      } else if (marker == 0xDB) {
        err = parse_dqt(s, len);
      } else if (marker == 0xDD) {
        if (len < 2) return E_BAD_DATA;
        restart = u16(s);
      } else if (marker == 0xDE || marker == 0xDF) {
        err = E_HIERARCHICAL;
      } else if (marker == 0xE0) {
        if (len >= 5 && !std::memcmp(s, "JFIF", 5)) jfif = true;
      } else if (marker == 0xEE) {
        if (len >= 12 && !std::memcmp(s, "Adobe", 5)) {
          adobe = true;
          adobe_transform = s[11];
        }
      } else if (marker == 0xDA) {
        err = scan(s, len);
        scanned = true;
      }
      if (err) return err;
    }
    if (!frame || !scanned) return E_NO_FRAME;
    return OK;
  }

  // one output row of component c upsampled to the image width (fancy
  // upsampling, jdsample.c; rows outside the component clamp to its edge,
  // as jdmainct.c's context pointers do)
  void upsample_row(const Comp& c, int y, int* tmp, uint8_t* out) const {
    const int stride = c.bw * 8;
    const int rh = vmax / c.v, rw = hmax / c.h;
    const uint8_t* plane = c.plane.data();
    const int dw = c.dw;
    if (rh == 1 && rw == 1) {
      std::memcpy(out, plane + size_t(y) * stride, width);
      return;
    }
    if (rh == 1) {  // h2v1
      const uint8_t* in = plane + size_t(y) * stride;
      if (dw > 2) {
        for (int x = 0; x < dw; ++x) {
          const int v3 = in[x] * 3;
          const int l = in[x > 0 ? x - 1 : 0], r = in[x + 1 < dw ? x + 1
                                                                  : dw - 1];
          tmp[2 * x] = (v3 + l + 1) >> 2;
          tmp[2 * x + 1] = (v3 + r + 2) >> 2;
        }
      } else {
        for (int x = 0; x < dw; ++x) tmp[2 * x] = tmp[2 * x + 1] = in[x];
      }
      for (int x = 0; x < width; ++x) out[x] = uint8_t(tmp[x]);
      return;
    }
    const int r = y >> 1;
    if (rw == 2 && dw <= 2) {  // h2v2 without context: box
      const uint8_t* in = plane + size_t(r) * stride;
      for (int x = 0; x < width; ++x) out[x] = in[x >> 1];
      return;
    }
    const int other = (y & 1) ? (r + 1 < c.dh ? r + 1 : c.dh - 1)
                              : (r > 0 ? r - 1 : 0);
    const uint8_t* in0 = plane + size_t(r) * stride;
    const uint8_t* in1 = plane + size_t(other) * stride;
    if (rw == 1) {  // h1v2
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x)
        out[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    // h2v2: column sums, then the horizontal triangle
    for (int x = 0; x < dw; ++x) tmp[x] = in0[x] * 3 + in1[x];
    for (int x = 0; x < dw; ++x) {
      const int t3 = tmp[x] * 3;
      const int l = tmp[x > 0 ? x - 1 : 0];
      const int rr = tmp[x + 1 < dw ? x + 1 : dw - 1];
      const int a = (t3 + l + 8) >> 4, b = (t3 + rr + 7) >> 4;
      if (2 * x < width) out[2 * x] = uint8_t(a);
      if (2 * x + 1 < width) out[2 * x + 1] = uint8_t(b);
    }
  }

  void output(uint8_t* out) const {
    const int nc = int(comps.size());
    if (nc == 1) {
      const Comp& c = comps[0];
      const int stride = c.bw * 8;
      for (int y = 0; y < height; ++y) {
        const uint8_t* in = c.plane.data() + size_t(y) * stride;
        uint8_t* o = out + size_t(y) * width * 3;
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] =
            o[3 * x + 2] = in[x];
      }
      return;
    }
    // jdapimin.c's colour-space guess: JFIF -> YCbCr; Adobe transform 0 ->
    // RGB; else component ids 'R', 'G', 'B' -> RGB; else YCbCr
    bool rgb = false;
    if (!jfif) {
      if (adobe)
        rgb = adobe_transform == 0;
      else
        rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
    }
    // jdcolor.c's tables: SCALEBITS 16, ONE_HALF rounding
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int((int64_t(91881) * x + half) >> 16);
      cb_b[i] = int((int64_t(116130) * x + half) >> 16);
      cr_g[i] = -int64_t(46802) * x;
      cb_g[i] = -int64_t(22554) * x + half;
    }
    std::vector<int> tmp(size_t(2) * (width + 16));
    std::vector<uint8_t> rows(size_t(3) * width);
    for (int y = 0; y < height; ++y) {
      for (int k = 0; k < 3; ++k)
        upsample_row(comps[k], y, tmp.data(), rows.data() + size_t(k) * width);
      const uint8_t* c0 = rows.data();
      const uint8_t* c1 = c0 + width;
      const uint8_t* c2 = c1 + width;
      uint8_t* o = out + size_t(y) * width * 3;
      if (rgb) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = c0[x];
          o[3 * x + 1] = c1[x];
          o[3 * x + 2] = c2[x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x) {
        const int yy = c0[x], cb = c1[x], cr = c2[x];
        const int r = yy + cr_r[cr];
        const int g = yy + int((cb_g[cb] + cr_g[cr]) >> 16);
        const int b = yy + cb_b[cb];
        o[3 * x] = uint8_t(r < 0 ? 0 : r > 255 ? 255 : r);
        o[3 * x + 1] = uint8_t(g < 0 ? 0 : g > 255 ? 255 : g);
        o[3 * x + 2] = uint8_t(b < 0 ? 0 : b > 255 ? 255 : b);
      }
    }
  }
};

}  // namespace

extern "C" int p3d_jpeg_decode(const uint8_t* data, long long n,
                               uint8_t* out, int width, int height) {
  Decoder d;
  d.data = data;
  d.end = data + n;
  const int err = d.run();
  if (err) return err;
  if (d.width != width || d.height != height) return E_SIZE;
  d.output(out);
  return OK;
}
