// Host image codecs of the port: a JPEG decoder, and the TIFF LZW, PackBits
// and CCITT decoders, with plain C entry points (loaded with ctypes by
// dataloader/jpeg.py and dataloader/tiff.py; ctypes releases the GIL for the
// length of each call, so threads decode in parallel).
//
// The JPEG decoder gives the bytes of libjpeg-turbo 3 with its default
// decompression settings, as PIL calls it (np.asarray(Image.open(f))):
//   - the integer "islow" IDCT of jidctint.c, its outputs range-limited
//     through the post-IDCT table indexed by `value & 1023` (values past the
//     table's span wrap, as out-of-range coefficients give there);
//   - jdsample.c's upsampler, picked by each component's ratio to the
//     largest sampling factors: h2v1 and h2v2 triangle filters with their
//     alternating rounding biases where the component is more than 2
//     samples wide (else box replication), h1v2 for a vertical 2, box
//     replication (int_upsample) for every other integral ratio, the rows
//     above the first and below the last real row repeated (jdmainct.c's
//     context pointers); lossless files replicate only (no context rows);
//   - jdcolor.c's 16-bit fixed-point YCbCr -> RGB tables, and YCCK -> CMYK;
//   - jdhuff.c's bit reader: bits are read ahead to 57 at a time, a marker
//     ends the entropy-coded data and zero bits stand in after it (and the
//     MCUs after that one stay zero up to the next restart), running out of
//     bytes without a marker is a truncated file;
//   - jdphuff.c's four progressive scans (DC first / refine, AC first with
//     EOB runs / refine), and jdcoefct.c's block smoothing of a
//     progressive file whose coefficients are not all known to full
//     precision (the first 9 AC coefficients, and with DC only the DC too,
//     estimated from the 5 x 5 blocks' DC values around each block);
//   - jdarith.c's QM decoder (T.81 Annex D) for sequential and progressive
//     arithmetic-coded frames with their DAC conditioning;
//   - jdlossls.c / jdlhuff.c's lossless frames (SOF3): predictors 1-7, the
//     point transform, restarts every whole MCU row;
//   - the standard Huffman tables (T.81 K.3, jstdhuff.c) for tables 0 and 1
//     where a scan names a table no DHT defined (MJPEG frames).
// It reads SOF0 / SOF1 / SOF2 / SOF3 / SOF9 / SOF10 frames with 8-bit
// samples, 1, 3 or 4 components with sampling factors 1-4 whose ratios are
// integral. Everything that libjpeg refuses or PIL does not read (12-bit,
// hierarchical, lossless arithmetic, 2 components, DNL) and malformed data
// return an error message.

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

// T.81 K.3 (jstdhuff.c): the tables a scan gets where no DHT defined its own
constexpr uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},         // DC 0
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},         // DC 1
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},      // AC 0
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};     // AC 1
constexpr uint8_t kStdAcLuma[162] = {
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
constexpr uint8_t kStdAcChroma[162] = {
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

// T.81 Table D.2 (jaricom.c): Qe << 16 | next index after MPS << 8 | switch
// flag << 7 | next index after LPS; entry 113 is the fixed 0.5 estimate
constexpr uint32_t kArith[114] = {
#define V(qe, mps, sw, lps) ((uint32_t(qe) << 16) | (uint32_t(mps) << 8) | (uint32_t(sw) << 7) | uint32_t(lps))
    V(0x5a1d, 1, 1, 1),     V(0x2586, 2, 0, 14),    V(0x1114, 3, 0, 16),    V(0x080b, 4, 0, 18),
    V(0x03d8, 5, 0, 20),    V(0x01da, 6, 0, 23),    V(0x00e5, 7, 0, 25),    V(0x006f, 8, 0, 28),
    V(0x0036, 9, 0, 30),    V(0x001a, 10, 0, 33),   V(0x000d, 11, 0, 35),   V(0x0006, 12, 0, 9),
    V(0x0003, 13, 0, 10),   V(0x0001, 13, 0, 12),   V(0x5a7f, 15, 1, 15),   V(0x3f25, 16, 0, 36),
    V(0x2cf2, 17, 0, 38),   V(0x207c, 18, 0, 39),   V(0x17b9, 19, 0, 40),   V(0x1182, 20, 0, 42),
    V(0x0cef, 21, 0, 43),   V(0x09a1, 22, 0, 45),   V(0x072f, 23, 0, 46),   V(0x055c, 24, 0, 48),
    V(0x0406, 25, 0, 49),   V(0x0303, 26, 0, 51),   V(0x0240, 27, 0, 52),   V(0x01b1, 28, 0, 54),
    V(0x0144, 29, 0, 56),   V(0x00f5, 30, 0, 57),   V(0x00b7, 31, 0, 59),   V(0x008a, 32, 0, 60),
    V(0x0068, 33, 0, 62),   V(0x004e, 34, 0, 63),   V(0x003b, 35, 0, 32),   V(0x002c, 9, 0, 33),
    V(0x5ae1, 37, 1, 37),   V(0x484c, 38, 0, 64),   V(0x3a0d, 39, 0, 65),   V(0x2ef1, 40, 0, 67),
    V(0x261f, 41, 0, 68),   V(0x1f33, 42, 0, 69),   V(0x19a8, 43, 0, 70),   V(0x1518, 44, 0, 72),
    V(0x1177, 45, 0, 73),   V(0x0e74, 46, 0, 74),   V(0x0bfb, 47, 0, 75),   V(0x09f8, 48, 0, 77),
    V(0x0861, 49, 0, 78),   V(0x0706, 50, 0, 79),   V(0x05cd, 51, 0, 48),   V(0x04de, 52, 0, 50),
    V(0x040f, 53, 0, 50),   V(0x0363, 54, 0, 51),   V(0x02d4, 55, 0, 52),   V(0x025c, 56, 0, 53),
    V(0x01f8, 57, 0, 54),   V(0x01a4, 58, 0, 55),   V(0x0160, 59, 0, 56),   V(0x0125, 60, 0, 57),
    V(0x00f6, 61, 0, 58),   V(0x00cb, 62, 0, 59),   V(0x00ab, 63, 0, 61),   V(0x008f, 32, 0, 61),
    V(0x5b12, 65, 1, 65),   V(0x4d04, 66, 0, 80),   V(0x412c, 67, 0, 81),   V(0x37d8, 68, 0, 82),
    V(0x2fe8, 69, 0, 83),   V(0x293c, 70, 0, 84),   V(0x2379, 71, 0, 86),   V(0x1edf, 72, 0, 87),
    V(0x1aa9, 73, 0, 87),   V(0x174e, 74, 0, 72),   V(0x1424, 75, 0, 72),   V(0x119c, 76, 0, 74),
    V(0x0f6b, 77, 0, 74),   V(0x0d51, 78, 0, 75),   V(0x0bb6, 79, 0, 77),   V(0x0a40, 48, 0, 77),
    V(0x5832, 81, 1, 80),   V(0x4d1c, 82, 0, 88),   V(0x438e, 83, 0, 89),   V(0x3bdd, 84, 0, 90),
    V(0x34ee, 85, 0, 91),   V(0x2eae, 86, 0, 92),   V(0x299a, 87, 0, 93),   V(0x2516, 71, 0, 86),
    V(0x5570, 89, 1, 88),   V(0x4ca9, 90, 0, 95),   V(0x44d9, 91, 0, 96),   V(0x3e22, 92, 0, 97),
    V(0x3824, 93, 0, 99),   V(0x32b4, 94, 0, 99),   V(0x2e17, 86, 0, 93),   V(0x56a8, 96, 1, 95),
    V(0x4f46, 97, 0, 101),  V(0x47e5, 98, 0, 102),  V(0x41cf, 99, 0, 103),  V(0x3c3d, 100, 0, 104),
    V(0x375e, 93, 0, 99),   V(0x5231, 102, 0, 105), V(0x4c0f, 103, 0, 106), V(0x4639, 104, 0, 107),
    V(0x415e, 99, 0, 103),  V(0x5627, 106, 1, 105), V(0x50e7, 107, 0, 108), V(0x4b85, 103, 0, 109),
    V(0x5597, 109, 0, 110), V(0x504f, 107, 0, 111), V(0x5a10, 111, 1, 110), V(0x5522, 109, 0, 112),
    V(0x59eb, 111, 1, 112), V(0x5a1d, 113, 0, 113)};
#undef V

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

// jdhuff.c jpeg_make_d_derived_tbl: a table no DHT defined is the standard
// one where there is one (tables 0 and 1), installed in its slot
void derive_or_std(Huffman& h, bool dc, int no, bool lossless) {
  if (!h.defined) {
    if (no > 1) fail("a scan uses an undefined Huffman table");
    memcpy(h.bits, kStdBits[(dc ? 0 : 2) + no], 17);
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += h.bits[l];
    if (dc) {
      for (int i = 0; i < n; ++i) h.vals[i] = static_cast<uint8_t>(i);
    } else {
      memcpy(h.vals, no ? kStdAcChroma : kStdAcLuma, n);
    }
    h.defined = true;
  }
  derive(h, dc && !lossless);
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
    if (nb == 0) return 0;
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

  // the next byte of entropy-coded data for the arithmetic decoder
  // (jdarith.c get_byte + the marker test of arith_decode): 0 after a marker
  int arith_byte() {
    if (marker) return 0;
    if (pos >= n) fail("truncated JPEG data: the entropy-coded data ends without a marker");
    int c = d[pos++];
    if (c != 0xFF) return c;
    do {
      if (pos >= n) fail("truncated JPEG data: the entropy-coded data ends without a marker");
      c = d[pos++];
    } while (c == 0xFF);
    if (c == 0) return 0xFF;
    marker = c;
    return 0;
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

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---------------------------------------------------------------- arithmetic decoder

struct Arith {
  int64_t c = 0, a = 0;
  int ct = -16;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed = 113;
  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  // jdarith.c arith_decode
  int decode(BitReader& r, uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = r.arith_byte();
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kArith[sv & 0x7F];
    int64_t qe = e >> 16;
    int nm = (e >> 8) & 0xFF, nl = e & 0xFF;  // nl holds the switch flag in its bit 7
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// ---------------------------------------------------------------- frame

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // entropy tables of the current scan
  int bw = 0, bh = 0;       // blocks (lossless: samples) in the MCU-padded grid
  int wb = 0, hb = 0;       // blocks that hold real samples
  int dw = 0, dh = 0;       // downsampled width and height (real samples)
  int stride = 0;           // of `plane`
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint16_t> diff;  // lossless: bw * bh sample differences
  std::vector<uint8_t> plane;  // the component's samples after the IDCT
  uint16_t q[64] = {};         // its quantization table, latched at its first scan
  bool latched = false;
  int coef_bits[64];           // progressive: the Al of each coefficient, -1 unknown
  int dc = 0, dc_context = 0;
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, precision = 8;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  uint16_t qt[4][64] = {};  // natural order
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  uint8_t dc_L[16], dc_U[16], ac_K[16];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool frame = false, progressive = false, lossless = false, arith = false;
  Arith ar;
  Jpeg() {
    for (int i = 0; i < 16; ++i) {
      dc_L[i] = 0;
      dc_U[i] = 1;
      ac_K[i] = 5;
    }
  }
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

// jdmarker.c get_dac
void read_dac(BitReader& r, Jpeg& j, int len) {
  size_t end = r.pos + len;
  while (r.pos < end) {
    int index = r.byte(), val = r.byte();
    if (index >= 32) fail("bad DAC segment (table %d)", index);
    if (index >= 16) {
      j.ac_K[index - 16] = static_cast<uint8_t>(val);
    } else {
      j.dc_L[index] = static_cast<uint8_t>(val & 15);
      j.dc_U[index] = static_cast<uint8_t>(val >> 4);
      if (j.dc_L[index] > j.dc_U[index]) fail("bad DAC segment (value 0x%02X)", val);
    }
  }
  if (r.pos != end) fail("bad DAC segment length");
}

void read_sof(BitReader& r, Jpeg& j, int marker, int len) {
  if (j.frame) fail("a second SOF marker");
  j.progressive = marker == 0xC2 || marker == 0xCA;
  j.lossless = marker == 0xC3 || marker == 0xCB;
  j.arith = marker >= 0xC9;
  j.precision = r.byte();
  j.height = u16(r);
  j.width = u16(r);
  j.ncomp = r.byte();
  if (j.precision != 8) fail("%d-bit JPEG (only 8-bit samples are read)", j.precision);
  if (j.height <= 0 || j.width <= 0)
    fail("JPEG of %d x %d (a DNL height is not read)", j.width, j.height);
  if (j.ncomp != 1 && j.ncomp != 3 && j.ncomp != 4) fail("%d-component JPEG", j.ncomp);
  if (len != 6 + 3 * j.ncomp) fail("bad SOF%d segment length", marker - 0xC0);
  if (j.lossless && j.arith) fail("lossless arithmetic-coded JPEG (SOF11)");
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.id = r.byte();
    int hv = r.byte();
    k.h = hv >> 4;
    k.v = hv & 15;
    k.tq = r.byte();
    if (k.h < 1 || k.v < 1 || k.h > 4 || k.v > 4) fail("bad sampling factors %dx%d", k.h, k.v);
    if (k.tq > 3) fail("bad quantization table number %d", k.tq);
  }
  j.hmax = j.vmax = 1;
  for (int c = 0; c < j.ncomp; ++c) {
    j.hmax = std::max(j.hmax, j.comp[c].h);
    j.vmax = std::max(j.vmax, j.comp[c].v);
  }
  const int unit = j.lossless ? 1 : 8;
  j.mcux = (j.width + unit * j.hmax - 1) / (unit * j.hmax);
  j.mcuy = (j.height + unit * j.vmax - 1) / (unit * j.vmax);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    if (j.hmax % k.h || j.vmax % k.v)
      fail("fractional sampling ratios (%dx%d against %dx%d)", k.h, k.v, j.hmax, j.vmax);
    k.bw = j.mcux * k.h;
    k.bh = j.mcuy * k.v;
    k.dw = (j.width * k.h + j.hmax - 1) / j.hmax;
    k.dh = (j.height * k.v + j.vmax - 1) / j.vmax;
    k.wb = (k.dw + unit - 1) / unit;
    k.hb = (k.dh + unit - 1) / unit;
    for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
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

struct Scan {
  int ns = 0;
  Component* c[4];
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  int eobrun = 0;
};

// jdhuff.c decode_mcu: one sequential block
void huff_block(BitReader& r, Jpeg& j, Component& k, int16_t* block) {
  int s = r.decode(j.dc[k.td]);
  if (s) s = extend(r.get(s), s);
  if ((k.dc >= 0 && s > INT32_MAX - k.dc) || (k.dc < 0 && s < INT32_MIN - k.dc)) fail("bad DC coefficient");
  k.dc += s;
  block[0] = static_cast<int16_t>(k.dc);
  const Huffman& ac = j.ac[k.ta];
  for (int i = 1; i < 64; ++i) {
    int rs = r.decode(ac);
    int run = rs >> 4;
    s = rs & 15;
    if (s) {
      i += run;
      block[kNatural[i]] = static_cast<int16_t>(extend(r.get(s), s));
    } else {
      if (run != 15) break;
      i += 15;
    }
  }
}

// jdphuff.c decode_mcu_DC_first / _DC_refine / _AC_first / _AC_refine
void huff_dc_first(BitReader& r, Jpeg& j, Component& k, int16_t* block, int Al) {
  int s = r.decode(j.dc[k.td]);
  if (s) s = extend(r.get(s), s);
  if ((k.dc >= 0 && s > INT32_MAX - k.dc) || (k.dc < 0 && s < INT32_MIN - k.dc)) fail("bad DC coefficient");
  k.dc += s;
  block[0] = static_cast<int16_t>(static_cast<uint32_t>(k.dc) << Al);
}

void huff_dc_refine(BitReader& r, int16_t* block, int Al) {
  if (r.get(1)) block[0] = static_cast<int16_t>(block[0] | (1 << Al));
}

void huff_ac_first(BitReader& r, const Huffman& tbl, int16_t* block, Scan& s) {
  if (s.eobrun > 0) {
    --s.eobrun;
    return;
  }
  for (int k = s.Ss; k <= s.Se; ++k) {
    int rs = r.decode(tbl);
    int run = rs >> 4, size = rs & 15;
    if (size) {
      k += run;
      int v = extend(r.get(size), size);
      block[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << s.Al);
    } else if (run == 15) {
      k += 15;
    } else {
      s.eobrun = 1 << run;
      if (run) s.eobrun += r.get(run);
      --s.eobrun;
      break;
    }
  }
}

void huff_ac_refine(BitReader& r, const Huffman& tbl, int16_t* block, Scan& s) {
  const int p1 = 1 << s.Al, m1 = -1 * (1 << s.Al);
  int k = s.Ss;
  auto correct = [&](int16_t& c) {
    if (r.get(1) && (c & p1) == 0) c = static_cast<int16_t>(c >= 0 ? c + p1 : c + m1);
  };
  if (s.eobrun == 0) {
    for (; k <= s.Se; ++k) {
      int rs = r.decode(tbl);
      int run = rs >> 4, size = rs & 15, v = 0;
      if (size) {
        v = r.get(1) ? p1 : m1;
      } else if (run != 15) {
        s.eobrun = 1 << run;
        if (run) s.eobrun += r.get(run);
        break;
      }
      do {
        int16_t& c = block[kNatural[k]];
        if (c != 0) {
          correct(c);
        } else if (--run < 0) {
          break;
        }
        ++k;
      } while (k <= s.Se);
      if (v) block[kNatural[k]] = static_cast<int16_t>(v);
    }
  }
  if (s.eobrun > 0) {
    for (; k <= s.Se; ++k) {
      int16_t& c = block[kNatural[k]];
      if (c != 0) correct(c);
    }
    --s.eobrun;
  }
}

// jdarith.c: a DC difference (F.19 - F.24), with the dc_context update
int arith_dc_diff(BitReader& r, Jpeg& j, Component& k) {
  Arith& e = j.ar;
  uint8_t* st = e.dc_stats[k.td] + k.dc_context;
  if (e.decode(r, st) == 0) {
    k.dc_context = 0;
    return 0;
  }
  int sign = e.decode(r, st + 1);
  st += 2 + sign;
  int m = e.decode(r, st);
  if (m) {
    st = e.dc_stats[k.td] + 20;
    while (e.decode(r, st)) {
      if ((m <<= 1) == 0x8000) {
        e.ct = -1;  // magnitude overflow: the rest of the scan decodes nothing
        return 0;
      }
      st += 1;
    }
  }
  if (m < static_cast<int>((1L << j.dc_L[k.td]) >> 1)) k.dc_context = 0;
  else if (m > static_cast<int>((1L << j.dc_U[k.td]) >> 1)) k.dc_context = 12 + sign * 4;
  else k.dc_context = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (e.decode(r, st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

// jdarith.c: AC coefficients k0..k1 of a block (F.20); false on overflow
bool arith_ac(BitReader& r, Jpeg& j, int tbl, int16_t* block, int k0, int k1, int Al) {
  Arith& e = j.ar;
  for (int k = k0; k <= k1; ++k) {
    uint8_t* st = e.ac_stats[tbl] + 3 * (k - 1);
    if (e.decode(r, st)) break;  // EOB
    while (e.decode(r, st + 1) == 0) {
      st += 3;
      if (++k > k1) {
        e.ct = -1;  // spectral overflow
        return false;
      }
    }
    int sign = e.decode(r, &e.fixed);
    st += 2;
    int m = e.decode(r, st);
    if (m != 0 && e.decode(r, st)) {
      m <<= 1;
      st = e.ac_stats[tbl] + (k <= j.ac_K[tbl] ? 189 : 217);
      while (e.decode(r, st)) {
        if ((m <<= 1) == 0x8000) {
          e.ct = -1;  // magnitude overflow
          return false;
        }
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (e.decode(r, st)) v |= m;
    v += 1;
    if (sign) v = -v;
    block[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << Al);
  }
  return true;
}

void arith_ac_refine(BitReader& r, Jpeg& j, int tbl, int16_t* block, const Scan& s) {
  Arith& e = j.ar;
  const int p1 = 1 << s.Al, m1 = -1 * (1 << s.Al);
  int kex = s.Se;
  for (; kex > 0; --kex)
    if (block[kNatural[kex]]) break;
  for (int k = s.Ss; k <= s.Se; ++k) {
    uint8_t* st = e.ac_stats[tbl] + 3 * (k - 1);
    if (k > kex && e.decode(r, st)) break;  // EOB
    for (;;) {
      int16_t& c = block[kNatural[k]];
      if (c) {
        if (e.decode(r, st + 2)) c = static_cast<int16_t>(c < 0 ? c + m1 : c + p1);
        break;
      }
      if (e.decode(r, st + 1)) {
        c = static_cast<int16_t>(e.decode(r, &e.fixed) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > s.Se) {
        e.ct = -1;
        return;
      }
    }
  }
}

// one block (DCT frames) of the scan
void decode_unit(BitReader& r, Jpeg& j, Scan& s, Component& k, int16_t* block) {
  if (j.arith) {
    Arith& e = j.ar;
    if (e.ct == -1) return;
    if (!j.progressive) {
      int v = arith_dc_diff(r, j, k);
      if (e.ct == -1) return;
      k.dc = (k.dc + v) & 0xFFFF;
      block[0] = static_cast<int16_t>(k.dc);
      arith_ac(r, j, k.ta, block, 1, 63, 0);
    } else if (s.Ss == 0 && s.Ah == 0) {
      int v = arith_dc_diff(r, j, k);
      if (e.ct == -1) return;
      k.dc += v;
      block[0] = static_cast<int16_t>(static_cast<uint32_t>(k.dc) << s.Al);
    } else if (s.Ss == 0) {
      if (e.decode(r, &e.fixed)) block[0] = static_cast<int16_t>(block[0] | (1 << s.Al));
    } else if (s.Ah == 0) {
      arith_ac(r, j, k.ta, block, s.Ss, s.Se, s.Al);
    } else {
      arith_ac_refine(r, j, k.ta, block, s);
    }
    return;
  }
  if (!j.progressive) huff_block(r, j, k, block);
  else if (s.Ss == 0 && s.Ah == 0) huff_dc_first(r, j, k, block, s.Al);
  else if (s.Ss == 0) huff_dc_refine(r, block, s.Al);
  else if (s.Ah == 0) huff_ac_first(r, j.ac[k.ta], block, s);
  else huff_ac_refine(r, j.ac[k.ta], block, s);
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

// the scan's entropy state at its start and after each restart
void reset_entropy(Jpeg& j, Scan& s) {
  for (int i = 0; i < s.ns; ++i) {
    Component& k = *s.c[i];
    if (!j.progressive || (s.Ss == 0 && s.Ah == 0)) {
      k.dc = 0;
      k.dc_context = 0;
      if (j.arith) memset(j.ar.dc_stats[k.td], 0, 64);
    }
    if (j.arith && (!j.progressive || s.Ss)) memset(j.ar.ac_stats[k.ta], 0, 256);
  }
  s.eobrun = 0;
  if (j.arith) j.ar.reset();
}

// jdlossls.c: undo the prediction of one row of a component in place
// (diffs -> samples before the point transform), `first` for the first
// row of the image or after a restart
void undifference(Component& k, int row, bool first, int predictor, int initial) {
  uint16_t* cur = &k.diff[size_t(row) * k.bw];
  const int w = k.dw;
  if (first) {
    int32_t ra = (cur[0] + initial) & 0xFFFF;
    cur[0] = static_cast<uint16_t>(ra);
    for (int x = 1; x < w; ++x) {
      ra = (cur[x] + ra) & 0xFFFF;
      cur[x] = static_cast<uint16_t>(ra);
    }
    return;
  }
  const uint16_t* prev = cur - k.bw;
  int32_t rb = prev[0];
  int32_t ra = (cur[0] + rb) & 0xFFFF;
  cur[0] = static_cast<uint16_t>(ra);
  for (int x = 1; x < w; ++x) {
    int32_t rc = rb;
    rb = prev[x];
    int32_t p;
    switch (predictor) {
      case 1: p = ra; break;
      case 2: p = rb; break;
      case 3: p = rc; break;
      case 4: p = ra + rb - rc; break;
      case 5: p = ra + ((rb - rc) >> 1); break;
      case 6: p = rb + ((ra - rc) >> 1); break;
      default: p = (ra + rb) >> 1; break;
    }
    ra = (cur[x] + p) & 0xFFFF;
    cur[x] = static_cast<uint16_t>(ra);
  }
}

// jdlhuff.c: one sample difference
int lossless_diff(BitReader& r, const Huffman& h) {
  int s = r.decode(h);
  if (s == 0) return 0;
  if (s == 16) return 32768;
  return extend(r.get(s), s);
}

void read_scan(BitReader& r, Jpeg& j, int len) {
  if (!j.frame) fail("SOS before SOF");
  Scan s;
  s.ns = r.byte();
  if (s.ns < 1 || s.ns > j.ncomp || len != 4 + 2 * s.ns) fail("bad SOS segment");
  for (int i = 0; i < s.ns; ++i) {
    int id = r.byte(), t = r.byte();
    Component* k = nullptr;
    for (int c = 0; c < j.ncomp; ++c)
      if (j.comp[c].id == id) k = &j.comp[c];
    if (!k) fail("SOS names an unknown component %d", id);
    k->td = t >> 4;
    k->ta = t & 15;
    if (!j.arith && (k->td > 3 || k->ta > 3)) fail("bad Huffman table number");
    s.c[i] = k;
  }
  s.Ss = r.byte();
  s.Se = r.byte();
  int a = r.byte();
  s.Ah = a >> 4;
  s.Al = a & 15;
  if (j.progressive) {  // jdphuff.c / jdarith.c start_pass: the scan's parameters
    bool bad = false;
    if (s.Ss == 0) {
      bad = s.Se != 0;
    } else {
      bad = s.Ss > s.Se || s.Se > 63 || s.ns != 1;
    }
    if (s.Ah != 0 && s.Al != s.Ah - 1) bad = true;
    if (s.Al > 13) bad = true;
    if (bad) fail("bad progressive scan (Ss %d, Se %d, Ah %d, Al %d)", s.Ss, s.Se, s.Ah, s.Al);
    for (int i = 0; i < s.ns; ++i) {
      Component& k = *s.c[i];
      for (int c = s.Ss; c <= s.Se; ++c) k.coef_bits[c] = s.Al;
    }
  } else if (j.lossless) {
    if (s.Ss < 1 || s.Ss > 7 || s.Se != 0 || s.Ah != 0 || s.Al >= j.precision)
      fail("bad lossless scan (predictor %d, Se %d, Ah %d, Pt %d)", s.Ss, s.Se, s.Ah, s.Al);
  }
  for (int i = 0; i < s.ns; ++i) {
    Component& k = *s.c[i];
    if (j.arith) {
      if (k.td > 15 || k.ta > 15) fail("bad arithmetic table number");
    } else if (j.lossless) {
      derive_or_std(j.dc[k.td], true, k.td, true);
    } else if (j.progressive) {
      if (s.Ss == 0 && s.Ah == 0) derive_or_std(j.dc[k.td], true, k.td, false);
      if (s.Ss != 0) derive_or_std(j.ac[k.ta], false, k.ta, false);
    } else {
      derive_or_std(j.dc[k.td], true, k.td, false);
      derive_or_std(j.ac[k.ta], false, k.ta, false);
    }
    if (!k.latched) {  // jdinput.c latch_quant_tables
      if (!j.lossless) {
        if (!j.qt_defined[k.tq]) fail("a component uses an undefined quantization table");
        memcpy(k.q, j.qt[k.tq], sizeof k.q);
      }
      k.latched = true;
    }
    if (j.lossless) {
      if (k.diff.empty()) k.diff.assign(size_t(k.bw) * k.bh, 0);
    } else if (k.coef.empty()) {
      k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
    }
  }
  int blocks = 0;
  for (int i = 0; i < s.ns; ++i) blocks += s.c[i]->h * s.c[i]->v;
  if (s.ns > 1 && blocks > 10) fail("too many blocks in an MCU");
  r.buf = 0;
  r.bits = 0;
  r.marker = 0;
  r.insufficient = false;
  reset_entropy(j, s);
  int units_x, units_y;
  if (s.ns == 1) {
    units_x = s.c[0]->wb;
    units_y = s.c[0]->hb;
  } else {
    units_x = j.mcux;
    units_y = j.mcuy;
  }
  int next_rst = 0;
  if (j.lossless) {
    // restarts come every restart_interval / units_x whole MCU rows; a row
    // after a restart (or decoded from no data) is predicted as a first row
    const int predictor = s.Ss, initial = 1 << (j.precision - s.Al - 1);
    if (j.restart_interval && j.restart_interval % units_x)
      fail("lossless restart interval %d is no multiple of the %d MCUs of a row",
           j.restart_interval, units_x);
    const int rows_per_restart = j.restart_interval / units_x;
    int rows_to_go = rows_per_restart;
    std::vector<bool> first(size_t(s.ns), true);
    for (int my = 0; my < units_y; ++my) {
      if (j.restart_interval) {
        if (rows_to_go == 0) {
          restart(r, next_rst);
          rows_to_go = rows_per_restart;
          if (r.marker == 0) r.insufficient = false;
          for (int i = 0; i < s.ns; ++i) first[i] = true;
        }
      }
      bool empty = r.insufficient;
      for (int mx = 0; mx < units_x; ++mx) {
        for (int i = 0; i < s.ns; ++i) {
          Component& k = *s.c[i];
          int nh = s.ns == 1 ? 1 : k.h, nv = s.ns == 1 ? 1 : k.v;
          for (int by = 0; by < nv; ++by)
            for (int bx = 0; bx < nh; ++bx) {
              size_t at = size_t(my * nv + by) * k.bw + (mx * nh + bx);
              k.diff[at] = static_cast<uint16_t>(empty ? 0 : lossless_diff(r, j.dc[k.td]));
            }
        }
      }
      for (int i = 0; i < s.ns; ++i) {
        Component& k = *s.c[i];
        int nv = s.ns == 1 ? 1 : k.v;
        for (int by = 0; by < nv; ++by) {
          int row = my * nv + by;
          if (row >= k.dh) continue;
          undifference(k, row, first[i] || empty, predictor, initial);
          first[i] = false;
        }
      }
      if (j.restart_interval) --rows_to_go;
    }
    for (int i = 0; i < s.ns; ++i) {  // the point transform, into 8-bit samples
      Component& k = *s.c[i];
      k.stride = k.bw;
      k.plane.assign(size_t(k.bw) * k.bh, 0);
      for (size_t p = 0; p < k.plane.size(); ++p)
        k.plane[p] = static_cast<uint8_t>(k.diff[p] << s.Al);
    }
    return;
  }
  int to_go = j.restart_interval;
  for (int my = 0; my < units_y; ++my) {
    for (int mx = 0; mx < units_x; ++mx) {
      if (j.restart_interval) {
        if (to_go == 0) {
          restart(r, next_rst);
          reset_entropy(j, s);
          to_go = j.restart_interval;
          if (r.marker == 0) r.insufficient = false;
        }
      }
      if (!j.arith && r.insufficient) {
        // jdhuff.c / jdphuff.c: an MCU begun after the data ran out stays empty
      } else if (s.ns == 1) {
        Component& k = *s.c[0];
        decode_unit(r, j, s, k, &k.coef[(size_t(my) * k.bw + mx) * 64]);
      } else {
        for (int i = 0; i < s.ns; ++i) {
          Component& k = *s.c[i];
          for (int by = 0; by < k.v; ++by)
            for (int bx = 0; bx < k.h; ++bx) {
              size_t b = size_t(my * k.v + by) * k.bw + (mx * k.h + bx);
              decode_unit(r, j, s, k, &k.coef[b * 64]);
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

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dcval = (int(ip[0]) * int16_t(qp[0])) * (1 << kPass1Bits);
      for (int i = 0; i < 8; ++i) wp[8 * i] = dcval;
      continue;
    }
    auto deq = [&](int i) { return int64_t(int(ip[i]) * int16_t(qp[i])); };
    int64_t z2 = deq(16), z3 = deq(48);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = deq(0);
    z3 = deq(32);
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits), tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = deq(56);
    tmp1 = deq(40);
    tmp2 = deq(24);
    tmp3 = deq(8);
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

// ---------------------------------------------------------------- block smoothing (jdcoefct.c)

// natural positions of the first 9 zigzag AC coefficients, and the saved
// coefficient count of libjpeg-turbo 2.1+
constexpr int kQ01 = 1, kQ10 = 8, kQ20 = 16, kQ11 = 9, kQ02 = 2, kQ03 = 3, kQ12 = 10, kQ21 = 17,
              kQ30 = 24, kSaved = 10;

// smoothing_ok: every component's DC partly known and its quantizers
// nonzero, and some component's first 9 AC coefficients not yet exact
bool smoothing_ok(const Jpeg& j) {
  if (!j.progressive) return false;
  bool useful = false;
  for (int c = 0; c < j.ncomp; ++c) {
    const Component& k = j.comp[c];
    if (!k.latched) return false;
    const uint16_t* q = k.q;
    if (!q[0] || !q[kQ01] || !q[kQ10] || !q[kQ20] || !q[kQ11] || !q[kQ02] || !q[kQ03] ||
        !q[kQ12] || !q[kQ21] || !q[kQ30])
      return false;
    if (k.coef_bits[0] < 0) return false;
    for (int i = 1; i < kSaved; ++i)
      if (k.coef_bits[i] != 0) useful = true;
  }
  return useful;
}

inline int smooth_pred(int64_t q00, int64_t num, int64_t q, int Al) {
  num *= q00;
  int pred;
  if (num >= 0) {
    pred = static_cast<int>(((q << 7) + num) / (q << 8));
    if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
  } else {
    pred = static_cast<int>(((q << 7) - num) / (q << 8));
    if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
    pred = -pred;
  }
  return pred;
}

// decompress_smooth_data for one component: each block's estimates from
// the DC values of the 5 x 5 blocks around it, then the IDCT. Columns clamp
// at the component's last real block; rows as libjpeg-turbo clamps them,
// at block_rows * total_iMCU_rows with block_rows the rows of the block's
// own iMCU row, so that a block two rows above the last iMCU row reads the
// MCU-padding row below the image where there is one
void smooth_idct(Component& k, int imcu_rows) {
  const int* cb = k.coef_bits;
  const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 && cb[5] == -1 &&
                         cb[6] == -1 && cb[7] == -1 && cb[8] == -1 && cb[9] == -1;
  const int64_t Q00 = k.q[0], Q01 = k.q[kQ01], Q10 = k.q[kQ10], Q20 = k.q[kQ20], Q11 = k.q[kQ11],
                Q02 = k.q[kQ02], Q03 = k.q[kQ03], Q12 = k.q[kQ12], Q21 = k.q[kQ21], Q30 = k.q[kQ30];
  int16_t ws[64];
  for (int by = 0; by < k.hb; ++by) {
    const int imcu = by / k.v, block_row = by % k.v;
    const int block_rows = imcu < imcu_rows - 1 || k.hb % k.v == 0 ? k.v : k.hb % k.v;
    const int image_row = imcu * block_rows + block_row, image_rows = block_rows * imcu_rows;
    int rows[5];  // the block rows of the window, -2..2
    rows[2] = by;
    rows[1] = image_row > 0 ? by - 1 : by;
    rows[0] = image_row > 1 ? by - 2 : rows[1];
    rows[3] = image_row < image_rows - 1 ? by + 1 : by;
    rows[4] = image_row < image_rows - 2 ? by + 2 : rows[3];
    for (int& r : rows) r = std::min(r, k.bh - 1);
    for (int bx = 0; bx < k.wb; ++bx) {
      memcpy(ws, &k.coef[(size_t(by) * k.bw + bx) * 64], sizeof ws);
      int64_t D[26];  // D[1..25]: rows -2..2, columns -2..2, as DC01..DC25
      for (int r = 0; r < 5; ++r)
        for (int c = 0; c < 5; ++c) {
          int col = std::min(std::max(bx + c - 2, 0), k.wb - 1);
          D[1 + 5 * r + c] = k.coef[(size_t(rows[r]) * k.bw + col) * 64];
        }
      int Al;
      if ((Al = cb[1]) != 0 && ws[1] == 0) {
        int64_t num = change_dc
            ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
               3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
               13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25])
            : (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
        ws[1] = static_cast<int16_t>(smooth_pred(Q00, num, Q01, Al));
      }
      if ((Al = cb[2]) != 0 && ws[8] == 0) {
        int64_t num = change_dc
            ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
               13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
               3 * D[22] + 3 * D[23] + 3 * D[24] + D[25])
            : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
        ws[8] = static_cast<int16_t>(smooth_pred(Q00, num, Q10, Al));
      }
      if ((Al = cb[3]) != 0 && ws[16] == 0) {
        int64_t num = change_dc
            ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] +
               2 * D[17] + 7 * D[18] + 2 * D[19] + D[23])
            : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
        ws[16] = static_cast<int16_t>(smooth_pred(Q00, num, Q20, Al));
      }
      if ((Al = cb[4]) != 0 && ws[9] == 0) {
        int64_t num = change_dc
            ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25])
            : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] -
               D[6] + 10 * D[7] - 10 * D[9]);
        ws[9] = static_cast<int16_t>(smooth_pred(Q00, num, Q11, Al));
      }
      if ((Al = cb[5]) != 0 && ws[2] == 0) {
        int64_t num = change_dc
            ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] +
               D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19])
            : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
        ws[2] = static_cast<int16_t>(smooth_pred(Q00, num, Q02, Al));
      }
      if (change_dc) {
        if ((Al = cb[6]) != 0 && ws[3] == 0) {
          int64_t num = D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19];
          ws[3] = static_cast<int16_t>(smooth_pred(Q00, num, Q03, Al));
        }
        if ((Al = cb[7]) != 0 && ws[10] == 0) {
          int64_t num = D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19];
          ws[10] = static_cast<int16_t>(smooth_pred(Q00, num, Q12, Al));
        }
        if ((Al = cb[8]) != 0 && ws[17] == 0) {
          int64_t num = D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19];
          ws[17] = static_cast<int16_t>(smooth_pred(Q00, num, Q21, Al));
        }
        if ((Al = cb[9]) != 0 && ws[24] == 0) {
          int64_t num = D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19];
          ws[24] = static_cast<int16_t>(smooth_pred(Q00, num, Q30, Al));
        }
        int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] +
                             6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] +
                             152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] +
                             42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21] - 6 * D[22] -
                             8 * D[23] - 6 * D[24] - 2 * D[25]);
        int pred = num >= 0 ? static_cast<int>(((Q00 << 7) + num) / (Q00 << 8))
                            : -static_cast<int>(((Q00 << 7) - num) / (Q00 << 8));
        ws[0] = static_cast<int16_t>(pred);
      }
      idct_islow(ws, k.q, &k.plane[size_t(by) * 8 * k.stride + bx * 8], k.stride);
    }
  }
}

// ---------------------------------------------------------------- upsampling (jdsample.c)

// One component at the full size (height x width), row-major, from its
// plane, by the method jinit_upsampler picks for its ratios
void upsample(const Jpeg& j, const Component& k, uint8_t* out) {
  const int W = j.width, H = j.height;
  const int rh = j.hmax / k.h, rv = j.vmax / k.v;
  const int stride = k.stride;
  const uint8_t* p = k.plane.data();
  const int dw = k.dw, dh = k.dh;
  const bool fancy = !j.lossless;  // do_fancy needs a DCT scaled size above 1
  auto row = [&](int y) { return p + size_t(y < 0 ? 0 : (y >= dh ? dh - 1 : y)) * stride; };
  std::vector<uint8_t> line(size_t(rh) * stride + 8);
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; ++y) memcpy(out + size_t(y) * W, p + size_t(y) * stride, W);
    return;
  }
  if (rh == 2 && rv == 1 && fancy && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = p + size_t(y) * stride;
      uint8_t* o = line.data();
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
      memcpy(out + size_t(y) * W, line.data(), W);
    }
    return;
  }
  if (rh == 1 && rv == 2 && fancy) {  // h1v2_fancy_upsample
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
  if (rh == 2 && rv == 2 && fancy && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int iy = y >> 1;
      uint8_t* o = line.data();
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
      memcpy(out + size_t(y) * W, line.data(), W);
    }
    return;
  }
  // h2v1_upsample, h2v2_upsample, int_upsample: box replication
  for (int y = 0; y < H; ++y) {
    const uint8_t* in = p + size_t(y / rv) * stride;
    uint8_t* o = out + size_t(y) * W;
    for (int x = 0; x < W; ++x) o[x] = in[x / rh];
  }
}

// ---------------------------------------------------------------- whole file

// transform: -1 libjpeg's default colour space (jdapimin.c
// default_decompress_parms), 0 none, 1 YCbCr (YCCK for 4 components)
void parse(BitReader& r, Jpeg& j, uint8_t* out, int transform = -1) {
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
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA: case 0xCB:
        read_sof(r, j, m, len);
        break;
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        fail("hierarchical JPEG (SOF%d)", m - 0xC0);
      case 0xC8: fail("JPEG extension frame (JPG marker)");
      case 0xCC: read_dac(r, j, len); break;
      case 0xC4: read_dht(r, j, len); break;
      case 0xDB: read_dqt(r, j, len); break;
      case 0xDD:
        if (len != 2) fail("bad DRI segment");
        j.restart_interval = u16(r);
        break;
      case 0xDC: r.pos += len; break;  // DNL: skipped, as jdmarker.c does
      case 0xDA: {
        if (out == nullptr) return;  // the header: every marker before the first scan
        size_t start = r.pos;
        int ns = r.d[start];
        if (!j.frame) fail("SOS before SOF");
        if (!scanned && (ns < j.ncomp || j.progressive)) multi_scan = true;
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
  if (!j.lossless) {
    // IDCT of every block into the component planes
    const bool smooth = smoothing_ok(j);
    for (int c = 0; c < j.ncomp; ++c) {
      Component& k = j.comp[c];
      if (k.coef.empty()) k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
      // a component no scan named keeps a zero multiplier table (jddctmgr.c)
      k.stride = k.bw * 8;
      k.plane.assign(size_t(k.stride) * k.bh * 8, 0);
      if (smooth) {
        smooth_idct(k, j.mcuy);
        continue;
      }
      for (int by = 0; by < k.bh; ++by)
        for (int bx = 0; bx < k.bw; ++bx)
          idct_islow(&k.coef[(size_t(by) * k.bw + bx) * 64], k.q,
                     &k.plane[size_t(by) * 8 * k.stride + bx * 8], k.stride);
    }
  } else {
    for (int c = 0; c < j.ncomp; ++c)
      if (j.comp[c].plane.empty()) fail("lossless JPEG: component %d has no scan", j.comp[c].id);
  }
  const size_t npix = size_t(j.width) * j.height;
  if (j.ncomp == 1) {
    upsample(j, j.comp[0], out);
    return;
  }
  std::vector<uint8_t> full(npix * j.ncomp);
  for (int c = 0; c < j.ncomp; ++c) upsample(j, j.comp[c], full.data() + c * npix);
  const uint8_t *y = full.data(), *cb = y + npix, *cr = cb + npix;
  if (j.ncomp == 4) {  // jdapimin.c default_decompress_parms: CMYK, or YCCK under Adobe 2
    const uint8_t* kk = cr + npix;
    const bool ycck = transform < 0 ? j.adobe && j.adobe_transform != 0 : transform == 1;
    if (j.lossless && ycck) fail("lossless YCCK JPEG (lossless mode converts no colours)");
    for (size_t i = 0; i < npix; ++i) {
      uint8_t* o = out + 4 * i;
      if (ycck) {  // jdcolor.c ycck_cmyk_convert
        int Y = y[i], B = cb[i], R = cr[i];
        o[0] = clamp255(255 - (Y + kTables.cr_r[R]));
        o[1] = clamp255(255 - (Y + static_cast<int>((int64_t(kTables.cb_g[B]) + kTables.cr_g[R]) >> 16)));
        o[2] = clamp255(255 - (Y + kTables.cb_b[B]));
      } else {
        o[0] = y[i];
        o[1] = cb[i];
        o[2] = cr[i];
      }
      o[3] = kk[i];
    }
    return;
  }
  bool rgb;  // jdapimin.c default_decompress_parms
  if (transform >= 0) rgb = transform == 0;
  else if (j.jfif) rgb = false;
  else if (j.adobe) rgb = j.adobe_transform == 0;
  else rgb = j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66;
  if (j.lossless && !rgb) fail("lossless YCbCr JPEG (lossless mode converts no colours)");
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


// ---------------------------------------------------------------- CCITT (tif_fax3.c)

// T.4's modified Huffman codes as (bits, run): terminating codes 0-63, the
// make-up codes of each colour, and the extended make-up codes both share
struct FaxCode {
  const char* bits;
  int run;
};
constexpr FaxCode kWhite[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5},
    {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11},
    {"001000", 12}, {"000011", 13}, {"110100", 14}, {"110101", 15}, {"101010", 16},
    {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36},
    {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46},
    {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}, {"11011", 64}, {"10010", 128}, {"010111", 192},
    {"0110111", 256}, {"00110110", 320}, {"00110111", 384}, {"01100100", 448},
    {"01100101", 512}, {"01101000", 576}, {"01100111", 640}, {"011001100", 704},
    {"011001101", 768}, {"011010010", 832}, {"011010011", 896}, {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216},
    {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472},
    {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664}, {"010011011", 1728}};
constexpr FaxCode kBlack[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5}, {"0010", 6},
    {"00011", 7}, {"000101", 8}, {"000100", 9}, {"0000100", 10}, {"0000101", 11},
    {"0000111", 12}, {"00000100", 13}, {"00000111", 14}, {"000011000", 15},
    {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63},
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448},
    {"0000001101100", 512}, {"0000001101101", 576}, {"0000001001010", 640},
    {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
constexpr FaxCode kExtended[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920}, {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176},
    {"000000010110", 2240}, {"000000010111", 2304}, {"000000011100", 2368},
    {"000000011101", 2432}, {"000000011110", 2496}, {"000000011111", 2560}};
// 2D modes: pass, horizontal, vertical -3..3
enum { kPass = 100, kHoriz = 101 };
constexpr FaxCode kModes[] = {{"0001", kPass}, {"001", kHoriz}, {"1", 0},      {"011", 1},
                              {"000011", 2},   {"0000011", 3},  {"010", -1},   {"000010", -2},
                              {"0000010", -3}};

// 13-bit lookahead tables: (length << 12 | run + 1), 0 for no code
struct FaxTables {
  uint16_t white[8192] = {}, black[8192] = {}, modes[8192] = {};
  static void add(uint16_t* t, const FaxCode& c, int bias) {
    int len = static_cast<int>(strlen(c.bits)), code = 0;
    for (int i = 0; i < len; ++i) code = code * 2 + (c.bits[i] - '0');
    for (int i = 0; i < (1 << (13 - len)); ++i)
      t[(code << (13 - len)) | i] = static_cast<uint16_t>((len << 12) | (c.run + bias));
  }
  FaxTables() {
    for (const auto& c : kWhite) add(white, c, 1);
    for (const auto& c : kBlack) add(black, c, 1);
    for (const auto& c : kExtended) {
      add(white, c, 1);
      add(black, c, 1);
    }
    for (const auto& c : kModes) add(modes, c, 4);
  }
};
const FaxTables kFax;

struct FaxReader {
  const uint8_t* d;
  size_t n;
  size_t bit = 0;
  int peek13() const {
    int v = 0;
    for (int i = 0; i < 13; ++i) {
      size_t b = bit + i;
      v = v * 2 + (b / 8 < n ? (d[b / 8] >> (7 - b % 8)) & 1 : 0);
    }
    return v;
  }
  bool done() const { return bit >= 8 * n; }
  // one run of `black` (terminating code after any make-up codes)
  int run(bool black) {
    int total = 0;
    for (;;) {
      if (done()) fail("truncated CCITT data");
      uint16_t e = (black ? kFax.black : kFax.white)[peek13()];
      if (!e) fail("bad CCITT code");
      bit += e >> 12;
      int r = (e & 0xFFF) - 1;
      total += r;
      if (r < 64) return total;
    }
  }
  int mode() {
    if (done()) fail("truncated CCITT data");
    uint16_t e = kFax.modes[peek13()];
    if (!e) fail("bad or unsupported CCITT 2D code");
    bit += e >> 12;
    return (e & 0xFFF) - 4;
  }
  // an EOL (at least 11 zero bits, then a 1) if one comes next
  bool eol() {
    size_t b = bit;
    int zeros = 0;
    while (b / 8 < n && !((d[b / 8] >> (7 - b % 8)) & 1)) {
      ++zeros;
      ++b;
    }
    if (zeros < 11 || b / 8 >= n) return false;
    bit = b + 1;
    return true;
  }
};

void fill_run(uint8_t* row, int from, int to, int cols) {
  to = std::min(to, cols);
  for (int x = std::max(from, 0); x < to; ++x) row[x >> 3] |= static_cast<uint8_t>(0x80 >> (x & 7));
}

// a 1D (modified Huffman) row -> its changing elements
void fax_row_1d(FaxReader& r, uint8_t* row, int cols, std::vector<int>& cur) {
  cur.clear();
  int a0 = 0;
  bool black = false;
  while (a0 < cols) {
    int a1 = a0 + r.run(black);
    if (black) fill_run(row, a0, a1, cols);
    a0 = a1;
    cur.push_back(std::min(a0, cols));
    black = !black;
  }
}

// a 2D (READ) row against the reference row's changing elements
void fax_row_2d(FaxReader& r, uint8_t* row, int cols, const std::vector<int>& ref,
                std::vector<int>& cur) {
  cur.clear();
  int a0 = -1;
  bool black = false;
  size_t i = 0;
  while (a0 < cols) {
    // b1: the first changing element right of a0 whose colour is not a0's
    // (even indices start black runs), b2 the next one
    while (i > 0 && ref[i - 1] > a0) --i;
    while (i < ref.size() && (ref[i] <= a0 || (i & 1) != (black ? 1u : 0u))) ++i;
    int b1 = i < ref.size() ? ref[i] : cols, b2 = i + 1 < ref.size() ? ref[i + 1] : cols;
    int m = r.mode();
    if (m == kPass) {
      if (black) fill_run(row, a0, b2, cols);
      a0 = b2;
    } else if (m == kHoriz) {
      if (a0 < 0) a0 = 0;
      int a1 = a0 + r.run(black), a2 = a1 + r.run(!black);
      if (black) fill_run(row, a0, a1, cols);
      else fill_run(row, a1, a2, cols);
      cur.push_back(std::min(a1, cols));
      cur.push_back(std::min(a2, cols));
      a0 = a2;
    } else {
      int a1 = b1 + m;
      if (a1 < 0 || a1 < a0) fail("bad CCITT vertical code");
      if (black) fill_run(row, a0, a1, cols);
      a0 = a1;
      cur.push_back(std::min(a0, cols));
      black = !black;
    }
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// The frame's size: 0 on success, else 1 and a message in `err`. `adobe`:
// 1 where an Adobe APP14 marker came before the frame (PIL inverts CMYK
// then).
int gp_jpeg_header(const uint8_t* data, size_t n, int* height, int* width, int* channels,
                   int* adobe, char* err, int errlen) {
  try {
    BitReader r{data, n};
    Jpeg j;
    parse(r, j, nullptr);
    if (!j.frame) fail("JPEG without a frame header");
    *height = j.height;
    *width = j.width;
    *channels = j.ncomp;
    *adobe = j.adobe;
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return 1;
}

// Decode into `out`, height x width x channels bytes (gp_jpeg_header's);
// `transform` as parse's.
int gp_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int transform, char* err,
                   int errlen) {
  try {
    BitReader r{data, n};
    Jpeg j;
    parse(r, j, out, transform);
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return 1;
}

// TIFF LZW (compression 5, libtiff's LZWDecode): MSB-first codes of 9-12
// bits, the width growing one code early; or old-style streams (a first
// byte 0 and the low bit of the second set: libtiff's LZWDecodeCompat),
// LSB-first codes whose width grows when the table passes 511, 1023 and
// 2047. Each table entry is a string that the output already holds (its
// prefix's last occurrence and one byte more), so a code is emitted by a
// copy out of the output. Decodes at most `cap` bytes; returns the count,
// or -1 with a message in `err`.
int64_t gp_tiff_lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err, int errlen) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4096 + 1024;
  const bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
  std::vector<size_t> pos(kSize);   // where the entry's string starts in dst
  std::vector<int32_t> len(kSize, 1);
  size_t out = 0, ip = 0;
  uint64_t acc = 0;
  int nacc = 0, nbits = 9, free_ent = kFirst, old = -1, maxcode = compat ? 511 : 510;
  auto next_code = [&](int& code) {
    while (nacc < nbits) {
      if (ip >= n) return false;
      if (compat) acc |= uint64_t(src[ip++]) << nacc;
      else acc = (acc << 8) | src[ip++];
      nacc += 8;
    }
    nacc -= nbits;
    if (compat) {
      code = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = static_cast<int>((acc >> nacc) & ((1u << nbits) - 1));
    }
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
        maxcode = compat ? 511 : 510;
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
    if (++free_ent > maxcode && nbits < 12) {
      ++nbits;
      maxcode = (1 << nbits) - (compat ? 1 : 2);
    }
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

// CCITT bilevel data (libtiff's Fax3 / Fax4 decoders) of `rows` rows of
// `cols` pixels into packed rows (ceil(cols / 8) bytes, MSB first), white
// runs 0 bits and black runs 1 bits: compression 2 (modified Huffman, each
// row from a byte boundary, no EOL), 3 (T.4: EOLs; with t4options bit 0
// each EOL is followed by a bit that picks a 1D or a 2D row) or 4 (T.6:
// 2D rows against the row above, the first against a white row). Returns
// 0, or 1 with a message in `err`.
int gp_tiff_fax_decode(const uint8_t* src, size_t n, uint8_t* dst, int rows, int cols,
                       int compression, int t4options, char* err, int errlen) {
  try {
    FaxReader r{src, n};
    const size_t stride = (size_t(cols) + 7) / 8;
    memset(dst, 0, stride * rows);
    std::vector<int> ref, cur;
    for (int y = 0; y < rows; ++y) {
      uint8_t* row = dst + stride * y;
      bool two_d = compression == 4;
      if (compression == 2) {
        r.bit = (r.bit + 7) / 8 * 8;
      } else if (compression == 3) {
        r.eol();
        if (t4options & 1) two_d = !((r.d[r.bit / 8] >> (7 - r.bit % 8)) & 1), ++r.bit;
      }
      if (two_d) fax_row_2d(r, row, cols, ref, cur);
      else fax_row_1d(r, row, cols, cur);
      std::swap(ref, cur);
    }
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
  }
  return 1;
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
