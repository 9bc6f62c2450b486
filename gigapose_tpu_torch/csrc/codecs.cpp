// Host image codecs of the port: a baseline JPEG decoder, and the TIFF LZW
// and PackBits decoders and predictor, with plain C entry points (loaded with ctypes by
// dataloader/jpeg.py and dataloader/tiff.py; ctypes releases the GIL for the
// length of each call, so threads decode in parallel).
//
// The JPEG decoder gives the bytes of libjpeg(-turbo) with its default
// decompression settings, as PIL calls it (np.asarray(Image.open(f))):
//   - the integer "islow" IDCT of jidctint.c, its outputs range-limited
//     through the post-IDCT table indexed by `value & 1023` (values past the
//     table's span wrap, as out-of-range coefficients give there);
//   - jdsample.c's fancy upsampling: h2v1 and h2v2 triangle filters with
//     their alternating rounding biases where the component is more than 2
//     samples wide (else box replication), h1v2 for 4:4:0, the rows above
//     the first and below the last real row repeated (jdmainct.c's context
//     pointers);
//   - jdcolor.c's 16-bit fixed-point YCbCr -> RGB tables;
//   - jdhuff.c's bit reader: bits are read ahead to 57 at a time, a marker
//     ends the entropy-coded data and zero bits stand in after it (and the
//     MCUs after that one stay zero up to the next restart), running out of
//     bytes without a marker is a truncated file.
// It reads SOF0 / SOF1 frames with 8-bit samples, 1 or 3 components with
// sampling factors of 1 or 2, any number of DQT (8- and 16-bit entries) and
// DHT tables, DRI restart intervals, interleaved and non-interleaved scans.
// Everything else (progressive, arithmetic, lossless, 12-bit, CMYK / YCCK,
// factors above 2) and malformed data return an error message.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw DecodeError{buf};
}

// zigzag index -> natural index, with 16 extra entries so that a corrupt run
// length past coefficient 63 lands on 63 (jutils.c's jpeg_natural_order)
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- tables

struct RangeTables {
  uint8_t post_idct[1024];  // indexed by (IDCT output) & 1023, +128 folded in
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  RangeTables() {
    // jdmaster.c prepare_range_limit_table, seen from its post-IDCT origin
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) post_idct[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) post_idct[i] = 255;
      else if (i < 896) post_idct[i] = 0;
      else post_idct[i] = static_cast<uint8_t>(i - 896);
    }
    // jdcolor.c build_ycc_rgb_table
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + kHalf);
    }
  }
};

const RangeTables kTables;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------- Huffman

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};  // codes of each length 1..16
  uint8_t vals[256] = {};
  // derived (jdhuff.c jpeg_make_d_derived_tbl)
  int64_t maxcode[18];
  int64_t valoffset[18];
  uint16_t look[256];  // (length << 8) | symbol for 8-bit prefixes; length 9: longer code
};

void derive(Huffman& h, bool dc) {
  char size[257];
  unsigned code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = h.bits[l];
    if (p + n > 256) fail("bad Huffman table");
    while (n--) size[p++] = static_cast<char>(l);
  }
  size[p] = 0;
  int nsym = p;
  unsigned code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) fail("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (h.bits[l]) {
      h.valoffset[l] = static_cast<int64_t>(p) - code_of[p];
      p += h.bits[l];
      h.maxcode[l] = code_of[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  for (int i = 0; i < 256; ++i) h.look[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= h.bits[l]; ++i, ++p) {
      int prefix = static_cast<int>(code_of[p]) << (8 - l);
      for (int c = 0; c < (1 << (8 - l)); ++c) h.look[prefix + c] = static_cast<uint16_t>((l << 8) | h.vals[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < nsym; ++i)
      if (h.vals[i] > 15) fail("bad Huffman table (DC symbol %d)", h.vals[i]);
  }
}

// ---------------------------------------------------------------- bit reader

struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;     // next byte of the file
  uint64_t buf = 0;   // right-aligned: the low `bits` bits are unread
  int bits = 0;
  int marker = 0;     // a marker met by the reader and not yet consumed
  bool insufficient = false;

  uint8_t byte() {
    if (pos >= n) fail("truncated JPEG data: the file ends inside a segment");
    return d[pos++];
  }

  // jdhuff.c jpeg_fill_bit_buffer: read ahead to 57 bits, stop at a marker;
  // past the marker zero bits stand in when `need` bits are wanted
  void fill(int need) {
    if (marker == 0) {
      while (bits < 57) {
        if (pos >= n) fail("truncated JPEG data: the entropy-coded data ends without a marker");
        int c = d[pos++];
        if (c == 0xFF) {
          do {
            if (pos >= n) fail("truncated JPEG data: the entropy-coded data ends without a marker");
            c = d[pos++];
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            marker = c;
            break;
          }
        }
        buf = (buf << 8) | static_cast<unsigned>(c);
        bits += 8;
      }
      if (marker == 0) return;
    }
    if (need > bits) {
      insufficient = true;
      buf <<= 57 - bits;
      bits = 57;
    }
  }

  int get(int nb) {
    if (bits < nb) fill(nb);
    bits -= nb;
    return static_cast<int>((buf >> bits) & ((uint64_t(1) << nb) - 1));
  }

  // jdhuff.h HUFF_DECODE: an 8-bit lookahead, else bit by bit
  int decode(const Huffman& h) {
    if (bits < 8) {
      fill(0);
      if (bits < 8) return decode_slow(h, 1);  // only after a marker
    }
    int look = static_cast<int>((buf >> (bits - 8)) & 0xFF);
    int nb = h.look[look] >> 8;
    if (nb > 8) return decode_slow(h, 9);
    bits -= nb;
    return h.look[look] & 0xFF;
  }

  int decode_slow(const Huffman& h, int l) {
    int64_t code = get(l);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;  // a corrupt code: libjpeg fakes a zero
    return h.vals[static_cast<int>(code + h.valoffset[l])];
  }

  // jdmarker.c next_marker: skip to the next FF xx with xx neither 00 nor FF
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }
};

// ---------------------------------------------------------------- frame

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // Huffman tables of the current scan
  int bw = 0, bh = 0;       // blocks in the MCU-padded grid
  int dw = 0, dh = 0;       // downsampled width and height (real samples)
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples after the IDCT
  int dc = 0;
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  uint16_t qt[4][64] = {};  // natural order
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool frame = false;
};

int u16(BitReader& r) {
  int a = r.byte();
  return (a << 8) | r.byte();
}

void read_dqt(BitReader& r, Jpeg& j, int len) {
  size_t end = r.pos + len;
  while (r.pos < end) {
    int pq = r.byte();
    int tq = pq & 15, prec = pq >> 4;
    if (tq > 3 || prec > 1) fail("bad DQT segment");
    for (int i = 0; i < 64; ++i) j.qt[tq][kNatural[i]] = static_cast<uint16_t>(prec ? u16(r) : r.byte());
    j.qt_defined[tq] = true;
  }
  if (r.pos != end) fail("bad DQT segment length");
}

void read_dht(BitReader& r, Jpeg& j, int len) {
  size_t end = r.pos + len;
  while (r.pos < end) {
    int tc_th = r.byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail("bad DHT segment");
    Huffman& h = tc ? j.ac[th] : j.dc[th];
    int count = 0;
    h.bits[0] = 0;
    for (int l = 1; l <= 16; ++l) count += (h.bits[l] = r.byte());
    if (count > 256) fail("bad DHT segment");
    for (int i = 0; i < count; ++i) h.vals[i] = r.byte();
    h.defined = true;
  }
  if (r.pos != end) fail("bad DHT segment length");
}

void read_sof(BitReader& r, Jpeg& j, int marker, int len) {
  if (j.frame) fail("a second SOF marker");
  int precision = r.byte();
  j.height = u16(r);
  j.width = u16(r);
  j.ncomp = r.byte();
  if (precision != 8) fail("%d-bit JPEG (only 8-bit samples are read)", precision);
  if (j.height <= 0 || j.width <= 0)
    fail("JPEG of %d x %d (a DNL height is not read)", j.width, j.height);
  if (j.ncomp == 4) fail("4-component (CMYK or YCCK) JPEG");
  if (j.ncomp != 1 && j.ncomp != 3) fail("%d-component JPEG", j.ncomp);
  if (len != 6 + 3 * j.ncomp) fail("bad SOF%d segment length", marker - 0xC0);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.id = r.byte();
    int hv = r.byte();
    k.h = hv >> 4;
    k.v = hv & 15;
    k.tq = r.byte();
    if (k.h < 1 || k.v < 1 || k.h > 4 || k.v > 4) fail("bad sampling factors %dx%d", k.h, k.v);
    if (k.h > 2 || k.v > 2) fail("sampling factors %dx%d (above 2)", k.h, k.v);
    if (k.tq > 3) fail("bad quantization table number %d", k.tq);
  }
  j.hmax = j.vmax = 1;
  for (int c = 0; c < j.ncomp; ++c) {
    j.hmax = std::max(j.hmax, j.comp[c].h);
    j.vmax = std::max(j.vmax, j.comp[c].v);
  }
  j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.bw = j.mcux * k.h;
    k.bh = j.mcuy * k.v;
    k.dw = (j.width * k.h + j.hmax - 1) / j.hmax;
    k.dh = (j.height * k.v + j.vmax - 1) / j.vmax;
  }
  j.frame = true;
}

void read_app(BitReader& r, Jpeg& j, int marker, int len) {
  const uint8_t* p = r.d + r.pos;
  if (r.pos + len > r.n) fail("truncated JPEG data: the file ends inside a segment");
  if (marker == 0xE0 && len >= 14 && !memcmp(p, "JFIF\0", 5)) j.jfif = true;
  if (marker == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
    j.adobe = true;
    j.adobe_transform = p[11];
  }
  r.pos += len;
}

// ---------------------------------------------------------------- entropy decoding

void decode_block(BitReader& r, Component& k, const Huffman& dc, const Huffman& ac, int16_t* block) {
  int s = r.decode(dc);
  if (s) {
    int bitsv = r.get(s);
    s = bitsv < (1 << (s - 1)) ? bitsv - (1 << s) + 1 : bitsv;
  }
  if ((k.dc >= 0 && s > INT32_MAX - k.dc) || (k.dc < 0 && s < INT32_MIN - k.dc)) fail("bad DC coefficient");
  k.dc += s;
  block[0] = static_cast<int16_t>(k.dc);
  for (int i = 1; i < 64; ++i) {
    int rs = r.decode(ac);
    int run = rs >> 4;
    s = rs & 15;
    if (s) {
      i += run;
      int bitsv = r.get(s);
      s = bitsv < (1 << (s - 1)) ? bitsv - (1 << s) + 1 : bitsv;
      block[kNatural[i]] = static_cast<int16_t>(s);
    } else {
      if (run != 15) break;
      i += 15;
    }
  }
}

// jdmarker.c read_restart_marker + jpeg_resync_to_restart
void restart(BitReader& r, int& next_rst) {
  r.bits = 0;
  if (r.marker == 0) r.marker = r.next_marker();
  int want = next_rst;
  if (r.marker == 0xD0 + want) {
    r.marker = 0;
  } else {
    for (;;) {
      int m = r.marker, action;
      if (m < 0xC0) action = 2;
      else if (m < 0xD0 || m > 0xD7) action = 3;
      else if (m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7)) action = 3;
      else if (m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) {
        r.marker = 0;
        break;
      }
      if (action == 3) break;
      r.marker = r.next_marker();
    }
  }
  next_rst = (next_rst + 1) & 7;
}

void read_scan(BitReader& r, Jpeg& j, int len) {
  if (!j.frame) fail("SOS before SOF");
  int ns = r.byte();
  if (ns < 1 || ns > j.ncomp || len != 4 + 2 * ns) fail("bad SOS segment");
  Component* sc[3];
  for (int i = 0; i < ns; ++i) {
    int id = r.byte(), t = r.byte();
    Component* k = nullptr;
    for (int c = 0; c < j.ncomp; ++c)
      if (j.comp[c].id == id) k = &j.comp[c];
    if (!k) fail("SOS names an unknown component %d", id);
    k->td = t >> 4;
    k->ta = t & 15;
    if (k->td > 3 || k->ta > 3) fail("bad Huffman table number");
    if (!j.dc[k->td].defined || !j.ac[k->ta].defined) fail("a scan uses an undefined Huffman table");
    derive(j.dc[k->td], true);
    derive(j.ac[k->ta], false);
    if (!j.qt_defined[k->tq]) fail("a component uses an undefined quantization table");
    sc[i] = k;
  }
  r.byte();  // Ss, Se, Ah / Al: fixed for a sequential scan
  r.byte();
  r.byte();
  int blocks = 0;
  for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
  if (ns > 1 && blocks > 10) fail("too many blocks in an MCU");
  for (int i = 0; i < ns; ++i) {
    Component& k = *sc[i];
    k.dc = 0;
    if (k.coef.empty()) k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
  }
  r.buf = 0;
  r.bits = 0;
  r.marker = 0;
  r.insufficient = false;
  int units_x, units_y;
  if (ns == 1) {
    Component& k = *sc[0];
    units_x = (k.dw + 7) / 8;
    units_y = (k.dh + 7) / 8;
  } else {
    units_x = j.mcux;
    units_y = j.mcuy;
  }
  int to_go = j.restart_interval, next_rst = 0;
  for (int my = 0; my < units_y; ++my) {
    for (int mx = 0; mx < units_x; ++mx) {
      if (j.restart_interval) {
        if (to_go == 0) {
          restart(r, next_rst);
          for (int i = 0; i < ns; ++i) sc[i]->dc = 0;
          to_go = j.restart_interval;
          if (r.marker == 0) r.insufficient = false;
        }
      }
      if (!r.insufficient) {
        if (ns == 1) {
          Component& k = *sc[0];
          decode_block(r, k, j.dc[k.td], j.ac[k.ta], &k.coef[(size_t(my) * k.bw + mx) * 64]);
        } else {
          for (int i = 0; i < ns; ++i) {
            Component& k = *sc[i];
            for (int by = 0; by < k.v; ++by)
              for (int bx = 0; bx < k.h; ++bx) {
                size_t b = size_t(my * k.v + by) * k.bw + (mx * k.h + bx);
                decode_block(r, k, j.dc[k.td], j.ac[k.ta], &k.coef[b * 64]);
              }
          }
        }
      }
      if (j.restart_interval) --to_go;
    }
  }
}

// ---------------------------------------------------------------- IDCT (jidctint.c)

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dcval = (int(ip[0]) * qp[0]) * (1 << kPass1Bits);
      for (int i = 0; i < 8; ++i) wp[8 * i] = dcval;
      continue;
    }
    int64_t z2 = int(ip[16]) * qp[16], z3 = int(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int(ip[0]) * qp[0];
    z3 = int(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits), tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = int(ip[56]) * qp[56];
    tmp1 = int(ip[40]) * qp[40];
    tmp2 = int(ip[24]) * qp[24];
    tmp3 = int(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    wp[0] = int(descale(t10 + tmp3, n));
    wp[56] = int(descale(t10 - tmp3, n));
    wp[8] = int(descale(t11 + tmp2, n));
    wp[48] = int(descale(t11 - tmp2, n));
    wp[16] = int(descale(t12 + tmp1, n));
    wp[40] = int(descale(t12 - tmp1, n));
    wp[24] = int(descale(t13 + tmp0, n));
    wp[32] = int(descale(t13 - tmp0, n));
  }
  const uint8_t* lim = kTables.post_idct;
  for (int rrow = 0; rrow < 8; ++rrow) {
    const int* wp = ws + 8 * rrow;
    uint8_t* op = out + size_t(rrow) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = lim[int(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int i = 0; i < 8; ++i) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits + kPass1Bits + 3;
    op[0] = lim[int(descale(t10 + tmp3, n)) & 1023];
    op[7] = lim[int(descale(t10 - tmp3, n)) & 1023];
    op[1] = lim[int(descale(t11 + tmp2, n)) & 1023];
    op[6] = lim[int(descale(t11 - tmp2, n)) & 1023];
    op[2] = lim[int(descale(t12 + tmp1, n)) & 1023];
    op[5] = lim[int(descale(t12 - tmp1, n)) & 1023];
    op[3] = lim[int(descale(t13 + tmp0, n)) & 1023];
    op[4] = lim[int(descale(t13 - tmp0, n)) & 1023];
  }
}

// ---------------------------------------------------------------- upsampling (jdsample.c)

// One component at the full size (height x width), row-major, from its
// plane. rh, rv: the upsampling ratios (1 or 2).
void upsample(const Jpeg& j, const Component& k, uint8_t* out) {
  const int W = j.width, H = j.height;
  const int rh = j.hmax / k.h, rv = j.vmax / k.v;
  const int stride = k.bw * 8;
  const uint8_t* p = k.plane.data();
  const int dw = k.dw, dh = k.dh;
  auto row = [&](int y) { return p + size_t(y < 0 ? 0 : (y >= dh ? dh - 1 : y)) * stride; };
  std::vector<uint8_t> line(size_t(2) * (k.bw * 8) + 2);
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; ++y) memcpy(out + size_t(y) * W, p + size_t(y) * stride, W);
    return;
  }
  if (rh == 2 && rv == 1) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = p + size_t(y) * stride;
      uint8_t* o = line.data();
      if (dw > 2) {  // h2v1_fancy_upsample
        int v = in[0];
        *o++ = static_cast<uint8_t>(v);
        *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = in[x] * 3;
          *o++ = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          *o++ = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        v = in[dw - 1];
        *o++ = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
        *o++ = static_cast<uint8_t>(v);
      } else {
        for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = in[x];
      }
      memcpy(out + size_t(y) * W, line.data(), W);
    }
    return;
  }
  if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = (y & 1) ? row(iy + 1) : row(iy - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + size_t(y) * W;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return;
  }
  // rh == 2 && rv == 2
  for (int y = 0; y < H; ++y) {
    int iy = y >> 1;
    uint8_t* o = line.data();
    if (dw > 2) {  // h2v2_fancy_upsample
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = (y & 1) ? row(iy + 1) : row(iy - 1);
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 2; x < dw; ++x) {
        next_sum = in0[x] * 3 + in1[x];
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
    } else {  // h2v2_upsample: box
      const uint8_t* in = p + size_t(iy) * stride;
      for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = in[x];
    }
    memcpy(out + size_t(y) * W, line.data(), W);
  }
}

// ---------------------------------------------------------------- whole file

void parse(BitReader& r, Jpeg& j, uint8_t* out) {
  if (r.n < 2 || r.d[0] != 0xFF || r.d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
  r.pos = 2;
  bool scanned = false, multi_scan = false;
  for (;;) {
    int m = r.marker ? r.marker : r.next_marker();
    r.marker = 0;
    if (m == 0xD9) {  // EOI
      if (!scanned) fail("JPEG without image data");
      break;
    }
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn / TEM: no parameters
    if (m == 0xD8) fail("a second SOI marker");
    int len = u16(r) - 2;
    if (len < 0) fail("bad marker segment length");
    if (r.pos + len > r.n) fail("truncated JPEG data: the file ends inside a segment");
    switch (m) {
      case 0xC0:
      case 0xC1:
        read_sof(r, j, m, len);
        if (out == nullptr) return;
        break;
      case 0xC2: fail("progressive JPEG (SOF2)");
      case 0xC3: fail("lossless JPEG (SOF3)");
      case 0xC5: case 0xC6: case 0xC7: fail("hierarchical JPEG (SOF%d)", m - 0xC0);
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        fail("arithmetic-coded JPEG (SOF%d)", m - 0xC0);
      case 0xCC: fail("arithmetic-coded JPEG (DAC marker)");
      case 0xC4: read_dht(r, j, len); break;
      case 0xDB: read_dqt(r, j, len); break;
      case 0xDD:
        if (len != 2) fail("bad DRI segment");
        j.restart_interval = u16(r);
        break;
      case 0xDA: {
        size_t start = r.pos;
        int ns = r.d[start];
        if (!j.frame) fail("SOS before SOF");
        if (!scanned && ns < j.ncomp) multi_scan = true;
        read_scan(r, j, len);
        scanned = true;
        if (!multi_scan) goto done;
        break;
      }
      default:
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
          read_app(r, j, m, len);
        } else {
          fail("unknown JPEG marker 0x%02X", m);
        }
    }
  }
done:
  // IDCT of every block into the component planes
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    if (k.coef.empty()) k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
    int16_t q[64];
    for (int i = 0; i < 64; ++i) q[i] = static_cast<int16_t>(j.qt[k.tq][i]);
    int stride = k.bw * 8;
    k.plane.assign(size_t(stride) * k.bh * 8, 0);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(&k.coef[(size_t(by) * k.bw + bx) * 64], q, &k.plane[size_t(by) * 8 * stride + bx * 8], stride);
  }
  const size_t npix = size_t(j.width) * j.height;
  if (j.ncomp == 1) {
    upsample(j, j.comp[0], out);
    return;
  }
  std::vector<uint8_t> full(npix * 3);
  for (int c = 0; c < 3; ++c) upsample(j, j.comp[c], full.data() + c * npix);
  bool rgb;  // jdapimin.c default_decompress_parms
  if (j.jfif) rgb = false;
  else if (j.adobe) rgb = j.adobe_transform == 0;
  else rgb = j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66;
  const uint8_t *y = full.data(), *cb = y + npix, *cr = cb + npix;
  if (rgb) {
    for (size_t i = 0; i < npix; ++i) {
      out[3 * i] = y[i];
      out[3 * i + 1] = cb[i];
      out[3 * i + 2] = cr[i];
    }
    return;
  }
  for (size_t i = 0; i < npix; ++i) {
    int Y = y[i], B = cb[i], R = cr[i];
    out[3 * i] = clamp255(Y + kTables.cr_r[R]);
    out[3 * i + 1] = clamp255(Y + static_cast<int>((int64_t(kTables.cb_g[B]) + kTables.cr_g[R]) >> 16));
    out[3 * i + 2] = clamp255(Y + kTables.cb_b[B]);
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// The frame's size: 0 on success, else 1 and a message in `err`.
int gp_jpeg_header(const uint8_t* data, size_t n, int* height, int* width, int* channels,
                   char* err, int errlen) {
  try {
    BitReader r{data, n};
    Jpeg j;
    parse(r, j, nullptr);
    if (!j.frame) fail("JPEG without a frame header");
    *height = j.height;
    *width = j.width;
    *channels = j.ncomp;
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return 1;
}

// Decode into `out`, height x width x channels bytes (gp_jpeg_header's).
int gp_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen) {
  try {
    BitReader r{data, n};
    Jpeg j;
    parse(r, j, out);
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return 1;
}

// TIFF LZW (compression 5, libtiff's LZWDecode): MSB-first codes of 9-12
// bits, the width growing one code early. Each table entry is a string that
// the output already holds (its prefix's last occurrence and one byte more),
// so a code is emitted by a copy out of the output. Decodes at most `cap`
// bytes; returns the count, or -1 with a message in `err`.
int64_t gp_tiff_lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err, int errlen) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4096 + 1024;
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) {
    set_error(err, errlen, "old-style (LSB-first) TIFF LZW");
    return -1;
  }
  std::vector<size_t> pos(kSize);   // where the entry's string starts in dst
  std::vector<int32_t> len(kSize, 1);
  size_t out = 0, ip = 0;
  uint64_t acc = 0;
  int nacc = 0, nbits = 9, free_ent = kFirst, old = -1;
  auto next_code = [&](int& code) {
    while (nacc < nbits) {
      if (ip >= n) return false;
      acc = (acc << 8) | src[ip++];
      nacc += 8;
    }
    nacc -= nbits;
    code = static_cast<int>((acc >> nacc) & ((1u << nbits) - 1));
    return true;
  };
  auto corrupt = [&]() {
    set_error(err, errlen, "corrupt TIFF LZW data");
    return int64_t(-1);
  };
  int code;
  while (out < cap && next_code(code)) {
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        nbits = 9;
        if (!next_code(code)) code = kEoi;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return corrupt();
      dst[out++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (old < 0 || code > free_ent || free_ent >= kSize) return corrupt();
    // the new entry: old's string (just written) and the first byte of
    // code's, which the copy below writes right after it
    pos[free_ent] = out - len[old];
    len[free_ent] = len[old] + 1;
    if (++free_ent > (1 << nbits) - 2 && nbits < 12) ++nbits;
    if (code < 256) {
      dst[out++] = static_cast<uint8_t>(code);
    } else {
      size_t from = pos[code], count = std::min<size_t>(len[code], cap - out);
      for (size_t i = 0; i < count; ++i) dst[out + i] = dst[from + i];  // forward: may overlap
      out += count;
    }
    old = code;
  }
  return static_cast<int64_t>(out);
}

// TIFF predictor 2 (horizontal differencing), undone in place on `rows`
// rows of `cols` pixels of `spp` samples of 1 or 2 bytes (2: the file's
// byte order, `big_endian`), wrapping as libtiff's horAcc8 / horAcc16.
void gp_tiff_unpredict(uint8_t* data, int64_t rows, int64_t cols, int spp, int bytes,
                       int big_endian) {
  const int64_t stride = cols * spp * bytes;
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* row = data + r * stride;
    if (bytes == 1) {
      for (int64_t i = spp; i < cols * spp; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - spp]);
      continue;
    }
    auto load = [&](int64_t i) {
      return big_endian ? (row[2 * i] << 8) | row[2 * i + 1] : row[2 * i] | (row[2 * i + 1] << 8);
    };
    for (int64_t i = spp; i < cols * spp; ++i) {
      unsigned v = static_cast<unsigned>(load(i) + load(i - spp)) & 0xFFFF;
      row[2 * i + (big_endian ? 0 : 1)] = static_cast<uint8_t>(v >> 8);
      row[2 * i + (big_endian ? 1 : 0)] = static_cast<uint8_t>(v);
    }
  }
}

// TIFF PackBits (compression 32773). Decodes at most `cap` bytes; returns
// the count.
int64_t gp_packbits_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t i = 0, out = 0;
  while (i < n && out < cap) {
    int c = static_cast<int8_t>(src[i++]);
    if (c < 0) {
      if (c == -128) continue;
      size_t run = size_t(1 - c);
      if (i >= n) break;
      if (run > cap - out) run = cap - out;
      memset(dst + out, src[i++], run);
      out += run;
    } else {
      size_t run = size_t(c) + 1;
      if (run > cap - out) run = cap - out;
      if (i + run > n) break;
      memcpy(dst + out, src + i, run);
      i += run;
      out += run;
    }
  }
  return static_cast<int64_t>(out);
}

}  // extern "C"
