// The port's JPEG coefficient coder: the host half of the engine's two
// coefficient transports (ops/jpeg.py holds the device halves).
//
//   reader  entropy-decodes a JPEG into its quantised DCT coefficients:
//           SOF0/SOF1 sequential and SOF2 progressive Huffman streams
//           (spectral selection, successive approximation, EOB runs),
//           8-bit, any component count the caller's caps take, sampling
//           factors 1-4, DRI/RSTn restarts, DHT/DQT anywhere before the
//           scan that uses them, 16-bit DQT entries; APPn and COM are
//           skipped (JFIF APP0 and Adobe APP14 are read for the colour
//           space).  It returns what libjpeg's jpeg_read_coefficients path
//           returns, down to its handling of damaged data: a stream cut
//           inside its entropy data decodes as far as its bits go, the
//           block in progress reads zero bits and later blocks stay zero
//           (ITU T.81 Annex F and G; libjpeg jdmarker.c, jdhuff.c,
//           jdphuff.c, jdcoefct.c).
//   writer  entropy-encodes baseline 4:2:0 YCbCr coefficients into the
//           file jpeg_write_coefficients writes after jpeg_set_defaults
//           and jpeg_set_quality(q, TRUE): SOI, JFIF APP0, two DQT, SOF0,
//           the four Annex K tables, SOS, the entropy segment and EOI, the
//           dummy blocks at the right and bottom iMCU edges made as
//           jctrans.c makes them (AC zero, DC the previous block's).
//
// C++17 and the standard library only: no codec library is included or
// linked, so it builds wherever g++ does (io/jcoef.py builds it at first
// use with -lpthread alone).
//
// Coefficient layout (the caller's buffers, zeroed by the caller): Y
// [cap_by][cap_bx][64], then Cb and Cr [cap_by_c][cap_bx_c][64] each, int16
// in natural (row-major frequency) order; a sparse call gives (idx, val)
// pairs instead, idx the position in that dense layout.  qtabs [3][64]
// uint16 in natural order.  info [16] = {h, w, ncomp, (h_samp, v_samp,
// height_in_blocks, width_in_blocks) x 3, jpeg_color_space} with libjpeg's
// J_COLOR_SPACE numbering (0 unknown, 1 grey, 2 RGB, 3 YCbCr).
//
// Return codes: 0 ok; -1 the file does not open; -2 a decode or write
// error (libjpeg's ERREXIT); -3 a block grid exceeds its cap (read from
// the header, before any entropy decode); -4 bad arguments (writer); -5 a
// component count other than 1-3; -6 the nonzero count exceeds cap_nnz;
// -7 a coding process this coder does not read: arithmetic coding
// (SOF9-SOF11), lossless (SOF3), hierarchical (SOF5-7, SOF13-15) or a
// sample precision other than 8 bits.  libjpeg-turbo returns 0 for
// arithmetic streams and -2 for the others; the engine decodes such items
// on the host.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kBlock = 64;
constexpr int kOpen = -1, kCodec = -2, kCaps = -3, kArgs = -4, kComps = -5,
              kSparse = -6, kProcess = -7;

struct Fail {
  int rc;
};

[[noreturn]] void fail(int rc) { throw Fail{rc}; }

// zigzag index -> natural index, with 16 extra entries so that a corrupt
// run length past the end of a block lands on coefficient 63
const int kNatural[kBlock + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3 tables: bits[0] unused, bits[l] = number of codes of length l
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Annex K.1 quantisation tables in natural order (jcparam.c)
const int kLumaQuant[kBlock] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[kBlock] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// marker codes (T.81 Table B.1)
enum : int {
  M_SOF0 = 0xc0, M_SOF1 = 0xc1, M_SOF2 = 0xc2, M_DHT = 0xc4, M_DAC = 0xcc,
  M_RST0 = 0xd0, M_RST7 = 0xd7, M_SOI = 0xd8, M_EOI = 0xd9, M_SOS = 0xda,
  M_DQT = 0xdb, M_DNL = 0xdc, M_DRI = 0xdd, M_APP0 = 0xe0, M_APP14 = 0xee,
  M_APP15 = 0xef, M_COM = 0xfe, M_TEM = 0x01
};

constexpr int kMaxDimension = 65500;  // libjpeg's JPEG_MAX_DIMENSION
constexpr int kMaxComponents = 10;
constexpr int kMaxCompsInScan = 4;
constexpr int kMaxBlocksInMcu = 10;
constexpr int kMaxSamp = 4;
constexpr int kTables = 4;

int ceil_div(long a, long b) { return static_cast<int>((a + b - 1) / b); }

// ---------------------------------------------------------------- reader

// The whole file in memory.  Past its end it reads FF D9 FF D9 ..., the
// fake EOI that libjpeg's stdio source inserts at end of file, so a cut
// file meets the same markers as it does under libjpeg.
class Source {
 public:
  explicit Source(std::vector<uint8_t> data) : d_(std::move(data)) {}
  int byte() {
    const size_t p = pos_++;
    if (p < d_.size()) return d_[p];
    return ((p - d_.size()) & 1) ? 0xd9 : 0xff;
  }
  int two() {
    const int a = byte();
    return (a << 8) | byte();
  }
  void skip(long n) {
    if (n > 0) pos_ += static_cast<size_t>(n);
  }

 private:
  std::vector<uint8_t> d_;
  size_t pos_ = 0;
};

struct HuffSpec {
  bool present = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

struct QuantSpec {
  bool present = false;
  uint16_t q[kBlock] = {};
};

// decoding tables (jdhuff.c jpeg_make_d_derived_tbl): canonical maxcode
// and valoffset per length, plus an 8-bit lookahead for the short codes
struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[256];
  uint8_t look_sym[256];
};

void make_derived(const HuffSpec& t, bool is_dc, Derived* d) {
  if (!t.present) fail(kCodec);
  int size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = t.bits[l];
    if (p + n > 256) fail(kCodec);
    for (int i = 0; i < n; ++i) size[p++] = l;
  }
  size[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    // no code may be all ones
    if (code >= (1u << si)) fail(kCodec);
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      d->valoffset[l] = p - static_cast<int32_t>(code_of[p]);
      p += t.bits[l];
      d->maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xfffff;  // ends the bit-by-bit search at length 17
  memcpy(d->vals, t.vals, sizeof(d->vals));
  memset(d->look_len, 0, sizeof(d->look_len));
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < t.bits[l]; ++i, ++p) {
      int look = static_cast<int>(code_of[p] << (8 - l));
      for (int n = 1 << (8 - l); n > 0; --n, ++look) {
        d->look_len[look] = static_cast<uint8_t>(l);
        d->look_sym[look] = t.vals[p];
      }
    }
  }
  if (is_dc) {
    for (int i = 0; i < nsym; ++i)
      if (t.vals[i] > 15) fail(kCodec);
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;  // width_in_blocks, height_in_blocks
  int pw = 0, ph = 0;  // the grid rounded up to whole iMCUs
  bool latched = false;
  uint16_t latched_q[kBlock] = {};
  std::vector<int16_t> coef;
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * pw + bx) * kBlock;
  }
};

enum class Mode { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

class Reader {
 public:
  explicit Reader(std::vector<uint8_t> data) : src_(std::move(data)) {}

  // markers up to the first SOS, then libjpeg's header checks
  // (jdinput.c initial_setup, jdapimin.c default_decompress_parms)
  void read_header() {
    if (read_markers() != M_SOS) fail(kCodec);  // no image
    if (height_ > kMaxDimension || width_ > kMaxDimension) fail(kCodec);
    if (precision_ != 8) fail(kProcess);
    if (ncomp_ > kMaxComponents) fail(kCodec);
    max_h_ = max_v_ = 1;
    for (const Component& c : comps_) {
      if (c.h <= 0 || c.h > kMaxSamp || c.v <= 0 || c.v > kMaxSamp)
        fail(kCodec);
      if (c.h > max_h_) max_h_ = c.h;
      if (c.v > max_v_) max_v_ = c.v;
    }
    for (Component& c : comps_) {
      c.bw = ceil_div(static_cast<long>(width_) * c.h, max_h_ * 8L);
      c.bh = ceil_div(static_cast<long>(height_) * c.v, max_v_ * 8L);
    }
    imcu_rows_ = ceil_div(height_, max_v_ * 8L);
    multi_scan_ = comps_in_scan_ < ncomp_ || progressive_;
    color_space_ = default_color_space();
  }

  // every scan into the coefficient grids, up to EOI
  void read_coefficients() {
    if (!progressive_) {
      // Motion-JPEG streams leave out the standard tables; libjpeg's
      // sequential decoder installs them in any empty slot 0 and 1
      install_std(&dc_[0], kDcLumaBits, kDcVals);
      install_std(&ac_[0], kAcLumaBits, kAcLumaVals);
      install_std(&dc_[1], kDcChromaBits, kDcVals);
      install_std(&ac_[1], kAcChromaBits, kAcChromaVals);
    }
    for (Component& c : comps_) {
      c.pw = ceil_div(c.bw, c.h) * c.h;
      c.ph = ceil_div(c.bh, c.v) * c.v;
      c.coef.assign(static_cast<size_t>(c.pw) * c.ph * kBlock, 0);
    }
    for (;;) {
      start_scan();
      decode_scan();
      if (read_markers() == M_EOI) return;
      if (!multi_scan_) fail(kCodec);  // a second SOS where none may be
    }
  }

  int height() const { return height_; }
  int width() const { return width_; }
  int ncomp() const { return ncomp_; }
  int color_space() const { return color_space_; }
  int max_h() const { return max_h_; }
  int max_v() const { return max_v_; }
  Component& comp(int c) { return comps_[c]; }
  // the table a component's coefficients were quantised with: its slot's
  // contents at the end of the stream, else the copy latched at its
  // first scan, else none
  const uint16_t* qtable(int c) const {
    const Component& k = comps_[c];
    if (k.tq < kTables && qt_[k.tq].present) return qt_[k.tq].q;
    if (k.latched) return k.latched_q;
    return nullptr;
  }

 private:
  // ---- markers (jdmarker.c)
  int read_markers() {
    for (;;) {
      if (unread_marker_ == 0) {
        if (!saw_soi_)
          first_marker();
        else
          next_marker();
      }
      const int m = unread_marker_;
      switch (m) {
        case M_SOI:
          get_soi();
          break;
        case M_SOF0:
        case M_SOF1:
          get_sof(false);
          break;
        case M_SOF2:
          get_sof(true);
          break;
        case 0xc3: case 0xc5: case 0xc6: case 0xc7: case 0xc9: case 0xca:
        case 0xcb: case 0xcd: case 0xce: case 0xcf:
          fail(kProcess);
        case M_SOS:
          get_sos();
          unread_marker_ = 0;
          return M_SOS;
        case M_EOI:
          unread_marker_ = 0;
          return M_EOI;
        case M_DAC:
          get_dac();
          break;
        case M_DHT:
          get_dht();
          break;
        case M_DQT:
          get_dqt();
          break;
        case M_DRI:
          get_dri();
          break;
        case M_COM:
        case M_DNL:
          skip_variable();
          break;
        case M_TEM:
          break;
        default:
          if (m >= M_RST0 && m <= M_RST7) break;  // parameterless
          if (m >= M_APP0 && m <= M_APP15) {
            if (m == M_APP0 || m == M_APP14)
              get_interesting_appn(m);
            else
              skip_variable();
            break;
          }
          fail(kCodec);  // JPG, DHP, EXP, JPGn, RESn
      }
      unread_marker_ = 0;
    }
  }

  void first_marker() {
    const int c = src_.byte(), c2 = src_.byte();
    if (c != 0xff || c2 != M_SOI) fail(kCodec);
    unread_marker_ = c2;
  }

  // the next marker, skipping any bytes before it
  void next_marker() {
    int c;
    for (;;) {
      c = src_.byte();
      while (c != 0xff) c = src_.byte();
      do {
        c = src_.byte();
      } while (c == 0xff);
      if (c != 0) break;  // FF 00 is stuffed data: keep looking
    }
    unread_marker_ = c;
  }

  void get_soi() {
    if (saw_soi_) fail(kCodec);
    restart_interval_ = 0;
    saw_jfif_ = saw_adobe_ = false;
    adobe_transform_ = 0;
    saw_soi_ = true;
  }

  void get_sof(bool progressive) {
    if (saw_sof_) fail(kCodec);
    progressive_ = progressive;
    long length = src_.two();
    precision_ = src_.byte();
    height_ = src_.two();
    width_ = src_.two();
    ncomp_ = src_.byte();
    length -= 8;
    if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) fail(kCodec);
    if (length != ncomp_ * 3) fail(kCodec);
    comps_.assign(ncomp_, Component());
    for (Component& c : comps_) {
      c.id = src_.byte();
      const int s = src_.byte();
      c.h = (s >> 4) & 15;
      c.v = s & 15;
      c.tq = src_.byte();
    }
    saw_sof_ = true;
  }

  void get_sos() {
    if (!saw_sof_) fail(kCodec);
    const long length = src_.two();
    const int n = src_.byte();
    if (length != n * 2 + 6 || n < 1 || n > kMaxCompsInScan) fail(kCodec);
    comps_in_scan_ = n;
    int taken[kMaxCompsInScan] = {-1, -1, -1, -1};
    for (int i = 0; i < n; ++i) {
      const int cc = src_.byte(), t = src_.byte();
      int found = -1;
      // libjpeg-turbo's duplicate-ID guard, slot for slot
      for (int ci = 0; ci < ncomp_ && ci < kMaxCompsInScan; ++ci) {
        if (cc == comps_[ci].id && taken[ci] < 0) {
          found = ci;
          break;
        }
      }
      if (found < 0) fail(kCodec);
      taken[i] = found;
      scan_comp_[i] = found;
      comps_[found].dc_tbl = (t >> 4) & 15;
      comps_[found].ac_tbl = t & 15;
    }
    ss_ = src_.byte();
    se_ = src_.byte();
    const int a = src_.byte();
    ah_ = (a >> 4) & 15;
    al_ = a & 15;
    next_restart_num_ = 0;
  }

  void get_dht() {
    long length = src_.two() - 2;
    while (length > 16) {
      const int index = src_.byte();
      HuffSpec t;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        t.bits[i] = static_cast<uint8_t>(src_.byte());
        count += t.bits[i];
      }
      length -= 1 + 16;
      if (count > 256 || count > length) fail(kCodec);
      for (int i = 0; i < count; ++i)
        t.vals[i] = static_cast<uint8_t>(src_.byte());
      length -= count;
      HuffSpec* slot;
      if (index & 0x10) {
        const int k = index - 0x10;
        if (k < 0 || k >= kTables) fail(kCodec);
        slot = &ac_[k];
      } else {
        if (index < 0 || index >= kTables) fail(kCodec);
        slot = &dc_[index];
      }
      t.present = true;
      *slot = t;
    }
    if (length != 0) fail(kCodec);
  }

  void get_dqt() {
    long length = src_.two() - 2;
    while (length > 0) {
      --length;
      int n = src_.byte();
      const int prec = n >> 4;
      n &= 0x0f;
      if (n >= kTables) fail(kCodec);
      QuantSpec& q = qt_[n];
      q.present = true;
      for (int i = 0; i < kBlock; ++i)
        q.q[kNatural[i]] =
            static_cast<uint16_t>(prec ? src_.two() : src_.byte());
      length -= kBlock;
      if (prec) length -= kBlock;
    }
    if (length != 0) fail(kCodec);
  }

  void get_dri() {
    if (src_.two() != 4) fail(kCodec);
    restart_interval_ = src_.two();
  }

  // arithmetic conditioning: parsed and checked as libjpeg does, unused
  void get_dac() {
    long length = src_.two() - 2;
    while (length > 0) {
      const int index = src_.byte(), val = src_.byte();
      length -= 2;
      if (index < 0 || index >= 32) fail(kCodec);
      if (index < 16 && (val & 0x0f) > (val >> 4)) fail(kCodec);
    }
    if (length != 0) fail(kCodec);
  }

  // APP0 (JFIF) and APP14 (Adobe): the first 14 bytes decide the colour
  // space; the rest is skipped
  void get_interesting_appn(int marker) {
    long length = src_.two() - 2;
    const long n = length >= 14 ? 14 : (length > 0 ? length : 0);
    uint8_t b[14];
    for (long i = 0; i < n; ++i) b[i] = static_cast<uint8_t>(src_.byte());
    length -= n;
    if (marker == M_APP0) {
      if (n >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' &&
          b[3] == 'F' && b[4] == 0)
        saw_jfif_ = true;
    } else if (n >= 12 && b[0] == 'A' && b[1] == 'd' && b[2] == 'o' &&
               b[3] == 'b' && b[4] == 'e') {
      saw_adobe_ = true;
      adobe_transform_ = b[11];
    }
    src_.skip(length);
  }

  void skip_variable() { src_.skip(src_.two() - 2L); }

  int default_color_space() const {
    switch (ncomp_) {
      case 1:
        return 1;  // JCS_GRAYSCALE
      case 3:
        if (saw_jfif_) return 3;  // JCS_YCbCr
        if (saw_adobe_) return adobe_transform_ == 0 ? 2 : 3;
        if (comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66)
          return 2;  // component IDs 'R', 'G', 'B'
        return 3;
      default:
        return 0;  // JCS_UNKNOWN (four components are refused: -5)
    }
  }

  static void install_std(HuffSpec* t, const uint8_t* bits,
                          const uint8_t* vals) {
    if (t->present) return;
    int n = 0;
    for (int l = 1; l <= 16; ++l) {
      t->bits[l] = bits[l];
      n += bits[l];
    }
    memcpy(t->vals, vals, n);
    t->present = true;
  }

  // ---- scan set-up (jdinput.c per_scan_setup and latch_quant_tables,
  // jdhuff.c / jdphuff.c start_pass)
  void start_scan() {
    if (comps_in_scan_ == 1) {
      const Component& c = comps_[scan_comp_[0]];
      mcus_per_row_ = c.bw;
      mcu_rows_ = c.bh;
      blocks_in_mcu_ = 1;
      membership_[0] = 0;
    } else {
      mcus_per_row_ = ceil_div(width_, max_h_ * 8L);
      mcu_rows_ = imcu_rows_;
      blocks_in_mcu_ = 0;
      for (int i = 0; i < comps_in_scan_; ++i) {
        const Component& c = comps_[scan_comp_[i]];
        if (blocks_in_mcu_ + c.h * c.v > kMaxBlocksInMcu) fail(kCodec);
        for (int k = 0; k < c.h * c.v; ++k) membership_[blocks_in_mcu_++] = i;
      }
    }
    for (int i = 0; i < comps_in_scan_; ++i) {
      Component& c = comps_[scan_comp_[i]];
      if (c.latched) continue;
      if (c.tq >= kTables || !qt_[c.tq].present) fail(kCodec);
      memcpy(c.latched_q, qt_[c.tq].q, sizeof(c.latched_q));
      c.latched = true;
    }
    if (!progressive_) {
      // Ss/Se/Ah/Al of a sequential scan are not checked (only warned)
      mode_ = Mode::kSequential;
      for (int i = 0; i < comps_in_scan_; ++i) {
        const Component& c = comps_[scan_comp_[i]];
        make_derived(table(dc_, c.dc_tbl), true, &dc_derived_[c.dc_tbl]);
        make_derived(table(ac_, c.ac_tbl), false, &ac_derived_[c.ac_tbl]);
      }
    } else {
      const bool dc_band = ss_ == 0;
      bool bad = false;
      if (dc_band) {
        if (se_ != 0) bad = true;
      } else {
        if (ss_ > se_ || se_ >= kBlock) bad = true;
        if (comps_in_scan_ != 1) bad = true;
      }
      if (ah_ != 0 && al_ != ah_ - 1) bad = true;
      if (al_ > 13) bad = true;
      if (bad) fail(kCodec);
      if (ah_ == 0)
        mode_ = dc_band ? Mode::kDcFirst : Mode::kAcFirst;
      else
        mode_ = dc_band ? Mode::kDcRefine : Mode::kAcRefine;
      for (int i = 0; i < comps_in_scan_; ++i) {
        const Component& c = comps_[scan_comp_[i]];
        if (dc_band) {
          if (ah_ == 0)
            make_derived(table(dc_, c.dc_tbl), true, &dc_derived_[c.dc_tbl]);
        } else {
          make_derived(table(ac_, c.ac_tbl), false, &ac_derived_[c.ac_tbl]);
          ac_one_ = &ac_derived_[c.ac_tbl];
        }
      }
    }
    for (int i = 0; i < comps_in_scan_; ++i) {
      const Component& c = comps_[scan_comp_[i]];
      dc_tab_[i] = &dc_derived_[c.dc_tbl];
      ac_tab_[i] = &ac_derived_[c.ac_tbl];
      last_dc_[i] = 0;
    }
    acc_ = 0;
    nbits_ = 0;
    insufficient_ = false;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
  }

  static const HuffSpec& table(const HuffSpec* slots, int n) {
    if (n < 0 || n >= kTables) fail(kCodec);
    return slots[n];
  }

  // ---- the scan's MCUs in order (jdcoefct.c consume_data)
  void decode_scan() {
    int16_t* blocks[kMaxBlocksInMcu];
    if (comps_in_scan_ == 1) {
      Component& c = comps_[scan_comp_[0]];
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          blocks[0] = c.block(by, bx);
          decode_mcu(blocks);
        }
      }
      return;
    }
    for (int my = 0; my < mcu_rows_; ++my) {
      for (int mx = 0; mx < mcus_per_row_; ++mx) {
        int n = 0;
        for (int i = 0; i < comps_in_scan_; ++i) {
          Component& c = comps_[scan_comp_[i]];
          for (int y = 0; y < c.v; ++y)
            for (int x = 0; x < c.h; ++x)
              blocks[n++] = c.block(my * c.v + y, mx * c.h + x);
        }
        decode_mcu(blocks);
      }
    }
  }

  void decode_mcu(int16_t** blocks) {
    if (restart_interval_ && restarts_to_go_ == 0) process_restart();
    // once the entropy data has run out, the rest of the segment's MCUs
    // stay as they are (zero, or their earlier scans' values)
    switch (mode_) {
      case Mode::kSequential:
        if (!insufficient_) mcu_sequential(blocks);
        break;
      case Mode::kDcFirst:
        if (!insufficient_) mcu_dc_first(blocks);
        break;
      case Mode::kDcRefine:
        mcu_dc_refine(blocks);  // zero bits change nothing
        break;
      case Mode::kAcFirst:
        if (!insufficient_) mcu_ac_first(blocks[0]);
        break;
      case Mode::kAcRefine:
        if (!insufficient_) mcu_ac_refine(blocks[0]);
        break;
    }
    if (restart_interval_) --restarts_to_go_;
  }

  void mcu_sequential(int16_t** blocks) {
    for (int b = 0; b < blocks_in_mcu_; ++b) {
      const int ci = membership_[b];
      int16_t* blk = blocks[b];
      int s = decode(*dc_tab_[ci]);
      if (s) s = extend(get_bits(s), s);
      s = static_cast<int>(static_cast<unsigned>(s) +
                           static_cast<unsigned>(last_dc_[ci]));
      last_dc_[ci] = s;
      blk[0] = static_cast<int16_t>(s);
      const Derived& ac = *ac_tab_[ci];
      for (int k = 1; k < kBlock; ++k) {
        s = decode(ac);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(get_bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  void mcu_dc_first(int16_t** blocks) {
    for (int b = 0; b < blocks_in_mcu_; ++b) {
      const int ci = membership_[b];
      int s = decode(*dc_tab_[ci]);
      if (s) s = extend(get_bits(s), s);
      const int last = last_dc_[ci];
      if ((last >= 0 && s > INT_MAX - last) ||
          (last < 0 && s < INT_MIN - last))
        fail(kCodec);
      s += last;
      last_dc_[ci] = s;
      blocks[b][0] = static_cast<int16_t>(static_cast<unsigned>(s) << al_);
    }
  }

  void mcu_dc_refine(int16_t** blocks) {
    const int p1 = 1 << al_;
    for (int b = 0; b < blocks_in_mcu_; ++b)
      if (get_bits(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
  }

  void mcu_ac_first(int16_t* blk) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int k = ss_; k <= se_; ++k) {
      int s = decode(*ac_one_);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = extend(get_bits(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(s)
                                                << al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1u << r;
        if (r) eobrun_ += get_bits(r);
        --eobrun_;
        break;
      }
    }
  }

  void mcu_ac_refine(int16_t* blk) {
    const int p1 = 1 << al_;
    const int m1 = static_cast<int>(~0u << al_);
    int k = ss_;
    auto correct = [&](int16_t* coef) {
      if (get_bits(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        int s = decode(*ac_one_);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;  // a newly nonzero coefficient
        } else if (r != 15) {
          eobrun_ = 1u << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        // skip the already-nonzero coefficients and r zero ones,
        // correcting the nonzero ones as they pass
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --eobrun_;
    }
  }

  void process_restart() {
    nbits_ = 0;  // the segment's padding bits
    if (unread_marker_ == 0) next_marker();
    if (unread_marker_ == M_RST0 + next_restart_num_)
      unread_marker_ = 0;
    else
      resync_to_restart(next_restart_num_);
    next_restart_num_ = (next_restart_num_ + 1) & 7;
    for (int i = 0; i < comps_in_scan_; ++i) last_dc_[i] = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    // a marker other than the expected RSTn leaves the next segment empty
    if (unread_marker_ == 0) insufficient_ = false;
  }

  // jdmarker.c jpeg_resync_to_restart
  void resync_to_restart(int desired) {
    int marker = unread_marker_;
    for (;;) {
      int action;
      if (marker < M_SOF0) {
        action = 2;
      } else if (marker < M_RST0 || marker > M_RST7) {
        action = 3;
      } else if (marker == M_RST0 + ((desired + 1) & 7) ||
                 marker == M_RST0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == M_RST0 + ((desired - 1) & 7) ||
                 marker == M_RST0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker_ = 0;
        return;
      }
      if (action == 3) return;
      next_marker();
      marker = unread_marker_;
    }
  }

  // ---- the bit reader (jdhuff.c jpeg_fill_bit_buffer): bytes up to the
  // next marker, FF 00 read as FF; a read past the marker sets
  // insufficient_ and reads zero bits
  static constexpr int kMinBits = 57;

  void fill(int need) {
    if (unread_marker_ == 0) {
      while (nbits_ < kMinBits) {
        int c = src_.byte();
        if (c == 0xff) {
          do {
            c = src_.byte();
          } while (c == 0xff);
          if (c == 0) {
            c = 0xff;
          } else {
            unread_marker_ = c;
            break;
          }
        }
        acc_ = (acc_ << 8) | static_cast<uint64_t>(c);
        nbits_ += 8;
      }
      if (unread_marker_ == 0) return;
    }
    if (need > nbits_) {
      insufficient_ = true;
      acc_ <<= kMinBits - nbits_;
      nbits_ = kMinBits;
    }
  }

  int get_bits(int n) {
    if (nbits_ < n) fill(n);
    nbits_ -= n;
    return static_cast<int>((acc_ >> nbits_) & ((1u << n) - 1));
  }

  int decode(const Derived& t) {
    int l;
    if (nbits_ < 8) fill(0);
    if (nbits_ >= 8) {
      const int look = static_cast<int>((acc_ >> (nbits_ - 8)) & 0xff);
      const int len = t.look_len[look];
      if (len) {
        nbits_ -= len;
        return t.look_sym[look];
      }
      l = 9;
    } else {
      l = 1;
    }
    int code = get_bits(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      ++l;
    }
    if (l > 16) return 0;  // not a code of the table: read as zero
    return t.vals[(code + t.valoffset[l]) & 0xff];
  }

  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  }

  Source src_;
  int unread_marker_ = 0;
  bool saw_soi_ = false, saw_sof_ = false, progressive_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  int precision_ = 0, height_ = 0, width_ = 0, ncomp_ = 0;
  int max_h_ = 1, max_v_ = 1, imcu_rows_ = 0, color_space_ = 0;
  bool multi_scan_ = false;
  std::vector<Component> comps_;
  HuffSpec dc_[kTables], ac_[kTables];
  QuantSpec qt_[kTables];
  int restart_interval_ = 0;
  // the scan
  int comps_in_scan_ = 0;
  int scan_comp_[kMaxCompsInScan] = {};
  int ss_ = 0, se_ = 0, ah_ = 0, al_ = 0, next_restart_num_ = 0;
  int mcus_per_row_ = 0, mcu_rows_ = 0, blocks_in_mcu_ = 0;
  int membership_[kMaxBlocksInMcu] = {};
  Mode mode_ = Mode::kSequential;
  Derived dc_derived_[kTables], ac_derived_[kTables];
  const Derived* dc_tab_[kMaxCompsInScan] = {};
  const Derived* ac_tab_[kMaxCompsInScan] = {};
  const Derived* ac_one_ = nullptr;
  int last_dc_[kMaxCompsInScan] = {};
  unsigned eobrun_ = 0;
  int restarts_to_go_ = 0;
  bool insufficient_ = false;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0)
    out->insert(out->end(), buf, buf + n);
  fclose(f);
  return true;
}

// Shared core of the dense (dense != nullptr) and sparse readers.  The
// checks and the writes into the caller's buffers come in the order of
// the libjpeg-based reader this replaces, so a failed item leaves the same
// partial rows behind.
int read_coefs(const char* path, int16_t* dense, int32_t* sp_idx,
               int16_t* sp_val, int cap_nnz, int* nnz_out, int cap_by,
               int cap_bx, int cap_by_c, int cap_bx_c, uint16_t* qtabs,
               int* info) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data)) return kOpen;
  try {
    Reader rd(std::move(data));
    rd.read_header();
    const int ncomp = rd.ncomp();
    if (ncomp < 1 || ncomp > 3) return kComps;
    for (int c = 0; c < ncomp; ++c) {
      const int cby = c == 0 ? cap_by : cap_by_c;
      const int cbx = c == 0 ? cap_bx : cap_bx_c;
      if (rd.comp(c).bh > cby || rd.comp(c).bw > cbx) return kCaps;
    }
    rd.read_coefficients();
    info[0] = rd.height();
    info[1] = rd.width();
    info[2] = ncomp;
    info[15] = rd.color_space();
    const size_t y_stride = static_cast<size_t>(cap_by) * cap_bx * kBlock;
    const size_t c_stride = static_cast<size_t>(cap_by_c) * cap_bx_c * kBlock;
    int nnz = 0;
    for (int c = 0; c < ncomp; ++c) {
      Component& k = rd.comp(c);
      const int cbx = c == 0 ? cap_bx : cap_bx_c;
      info[3 + c * 4 + 0] = k.h;
      info[3 + c * 4 + 1] = k.v;
      info[3 + c * 4 + 2] = k.bh;
      info[3 + c * 4 + 3] = k.bw;
      const uint16_t* q = rd.qtable(c);
      if (!q) return kCodec;
      memcpy(qtabs + c * kBlock, q, kBlock * sizeof(uint16_t));
      const size_t base = c == 0 ? 0 : y_stride + (c - 1) * c_stride;
      for (int row = 0; row < k.bh; ++row) {
        const int16_t* src = k.block(row, 0);
        const size_t row_base = base + static_cast<size_t>(row) * cbx * kBlock;
        const int cnt = k.bw * kBlock;
        if (dense) {
          memcpy(dense + row_base, src, cnt * sizeof(int16_t));
          continue;
        }
        for (int i = 0; i < cnt; ++i) {
          if (!src[i]) continue;
          if (nnz >= cap_nnz) return kSparse;
          sp_idx[nnz] = static_cast<int32_t>(row_base + i);
          sp_val[nnz] = src[i];
          ++nnz;
        }
      }
    }
    if (nnz_out) *nnz_out = nnz;
    return 0;
  } catch (const Fail& f) {
    return f.rc;
  } catch (const std::bad_alloc&) {
    return kCodec;
  }
}

// items [0, n) spread over up to n_threads threads, each taking the next
// item as it finishes one
template <typename Fn>
void parallel_items(int n, int n_threads, Fn fn) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  const int nt = n_threads < n ? n_threads : n;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------- writer

// encoding tables (jchuff.c jpeg_make_c_derived_tbl)
struct EncTable {
  uint32_t code[256] = {};
  uint8_t size[256] = {};
};

void make_enc(const uint8_t* bits, const uint8_t* vals, EncTable* t) {
  int p = 0;
  uint32_t code = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      t->code[vals[p]] = code++;
      t->size[vals[p]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>* out) : out_(out) {}
  void put(uint32_t bits, int n) {
    if (n == 0) return;
    acc_ = (acc_ << n) | (bits & ((1ull << n) - 1));
    nbits_ += n;
    while (nbits_ >= 8) {
      nbits_ -= 8;
      const uint8_t b = static_cast<uint8_t>(acc_ >> nbits_);
      out_->push_back(b);
      if (b == 0xff) out_->push_back(0);  // byte stuffing
    }
  }
  // pad the last byte with one bits
  void flush() {
    if (nbits_ > 0) put(0x7f, 8 - nbits_);
  }

 private:
  std::vector<uint8_t>* out_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

int nbits_of(int v) {
  unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

// F.1.2: one block, its DC as a difference from last_dc
void encode_block(BitWriter* bw, const int16_t* blk, int last_dc,
                  const EncTable& dc, const EncTable& ac) {
  int d = blk[0] - last_dc;
  int n = nbits_of(d);
  bw->put(dc.code[n], dc.size[n]);
  bw->put(static_cast<uint32_t>(d < 0 ? d - 1 : d), n);
  int run = 0;
  for (int k = 1; k < kBlock; ++k) {
    const int v = blk[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) bw->put(ac.code[0xf0], ac.size[0xf0]);
    n = nbits_of(v);
    const int sym = (run << 4) + n;
    bw->put(ac.code[sym], ac.size[sym]);
    bw->put(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run > 0) bw->put(ac.code[0], ac.size[0]);
}

void put2(std::vector<uint8_t>* o, int v) {
  o->push_back(static_cast<uint8_t>(v >> 8));
  o->push_back(static_cast<uint8_t>(v));
}

void put_marker(std::vector<uint8_t>* o, int m) {
  o->push_back(0xff);
  o->push_back(static_cast<uint8_t>(m));
}

void put_dht(std::vector<uint8_t>* o, int index, const uint8_t* bits,
             const uint8_t* vals) {
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += bits[l];
  put_marker(o, M_DHT);
  put2(o, n + 2 + 1 + 16);
  o->push_back(static_cast<uint8_t>(index));
  for (int l = 1; l <= 16; ++l) o->push_back(bits[l]);
  o->insert(o->end(), vals, vals + n);
}

// jcparam.c jpeg_set_quality(q, force_baseline=TRUE)
void quality_table(const int* base, int quality, uint16_t* q) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < kBlock; ++i) {
    long t = (base[i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    q[i] = static_cast<uint16_t>(t);
  }
}

// the whole file: headers, then the MCUs of the one interleaved scan
// (jctrans.c compress_output), then EOI
void encode_file(const int16_t* coefs, const size_t* comp_base,
                 const int* cap_bx, const int* bws, const int* bhs, int h,
                 int w, int quality, std::vector<uint8_t>* o) {
  static const int kH[3] = {2, 1, 1}, kV[3] = {2, 1, 1};
  uint16_t q[2][kBlock];
  quality_table(kLumaQuant, quality, q[0]);
  quality_table(kChromaQuant, quality, q[1]);
  put_marker(o, M_SOI);
  static const uint8_t kJfif[] = {0xff, 0xe0, 0x00, 0x10, 'J', 'F', 'I', 'F',
                                  0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00,
                                  0x01, 0x00, 0x00};
  o->insert(o->end(), kJfif, kJfif + sizeof(kJfif));
  for (int t = 0; t < 2; ++t) {
    put_marker(o, M_DQT);
    put2(o, kBlock + 1 + 2);
    o->push_back(static_cast<uint8_t>(t));
    for (int i = 0; i < kBlock; ++i)
      o->push_back(static_cast<uint8_t>(q[t][kNatural[i]]));
  }
  put_marker(o, M_SOF0);
  put2(o, 3 * 3 + 2 + 5 + 1);
  o->push_back(8);
  put2(o, h);
  put2(o, w);
  o->push_back(3);
  for (int c = 0; c < 3; ++c) {
    o->push_back(static_cast<uint8_t>(c + 1));
    o->push_back(static_cast<uint8_t>((kH[c] << 4) + kV[c]));
    o->push_back(c == 0 ? 0 : 1);
  }
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(o, 0x01, kDcChromaBits, kDcVals);
  put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  put_marker(o, M_SOS);
  put2(o, 2 * 3 + 2 + 1 + 3);
  o->push_back(3);
  for (int c = 0; c < 3; ++c) {
    o->push_back(static_cast<uint8_t>(c + 1));
    o->push_back(c == 0 ? 0x00 : 0x11);
  }
  o->push_back(0);
  o->push_back(63);
  o->push_back(0);

  EncTable dc[2], ac[2];
  make_enc(kDcLumaBits, kDcVals, &dc[0]);
  make_enc(kAcLumaBits, kAcLumaVals, &ac[0]);
  make_enc(kDcChromaBits, kDcVals, &dc[1]);
  make_enc(kAcChromaBits, kAcChromaVals, &ac[1]);
  BitWriter bw(o);
  const int mcus_x = ceil_div(w, 16), mcus_y = ceil_div(h, 16);
  int last_dc[3] = {0, 0, 0};
  int16_t dummy[kBlock] = {};
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      int prev_dc = 0;  // the DC of the MCU's previous block
      for (int c = 0; c < 3; ++c) {
        const int t = c == 0 ? 0 : 1;
        for (int y = 0; y < kV[c]; ++y) {
          for (int x = 0; x < kH[c]; ++x) {
            const int by = my * kV[c] + y, bx = mx * kH[c] + x;
            const int16_t* blk;
            if (by < bhs[c] && bx < bws[c]) {
              blk = coefs + comp_base[c] +
                    (static_cast<size_t>(by) * cap_bx[c] + bx) * kBlock;
            } else {
              dummy[0] = static_cast<int16_t>(prev_dc);
              blk = dummy;
            }
            encode_block(&bw, blk, last_dc[c], dc[t], ac[t]);
            last_dc[c] = blk[0];
            prev_dc = blk[0];
          }
        }
      }
    }
  }
  bw.flush();
  put_marker(o, M_EOI);
}

}  // namespace

extern "C" {

// Dense reader: the layout and return codes of the header comment.
int ipp_read_jpeg_coefs(const char* path, int16_t* coefs, int cap_by,
                        int cap_bx, int cap_by_c, int cap_bx_c,
                        uint16_t* qtabs, int* info) {
  return read_coefs(path, coefs, nullptr, nullptr, 0, nullptr, cap_by,
                    cap_bx, cap_by_c, cap_bx_c, qtabs, info);
}

// Sparse (COO) reader: up to cap_nnz (idx, val) pairs; *nnz_out set.
int ipp_read_jpeg_coefs_sparse(const char* path, int32_t* idx, int16_t* val,
                               int cap_nnz, int* nnz_out, int cap_by,
                               int cap_bx, int cap_by_c, int cap_bx_c,
                               uint16_t* qtabs, int* info) {
  return read_coefs(path, nullptr, idx, val, cap_nnz, nnz_out, cap_by,
                    cap_bx, cap_by_c, cap_bx_c, qtabs, info);
}

// Sparse batch: per-item rows of idx/val (cap_nnz each), nnz, qtabs and
// info; infos[i][0] holds the negative rc of a failed item.
void ipp_read_jpeg_coefs_sparse_batch(const char** paths, int n,
                                      int32_t* idxs, int16_t* vals,
                                      int cap_nnz, int* nnzs, int cap_by,
                                      int cap_bx, int cap_by_c,
                                      int cap_bx_c, uint16_t* qtabs,
                                      int* infos, int n_threads) {
  parallel_items(n, n_threads, [&](int i) {
    const int rc = ipp_read_jpeg_coefs_sparse(
        paths[i], idxs + static_cast<size_t>(i) * cap_nnz,
        vals + static_cast<size_t>(i) * cap_nnz, cap_nnz, nnzs + i, cap_by,
        cap_bx, cap_by_c, cap_bx_c,
        qtabs + static_cast<size_t>(i) * 3 * kBlock, infos + i * 16);
    if (rc != 0) infos[i * 16] = rc;
  });
}

// Dense batch: n items into one [n, Y + Cb + Cr] int16 buffer.
void ipp_read_jpeg_coefs_batch(const char** paths, int n, int16_t* coefs,
                               int cap_by, int cap_bx, int cap_by_c,
                               int cap_bx_c, uint16_t* qtabs, int* infos,
                               int n_threads) {
  const size_t stride = static_cast<size_t>(cap_by) * cap_bx * kBlock +
                        2 * static_cast<size_t>(cap_by_c) * cap_bx_c * kBlock;
  parallel_items(n, n_threads, [&](int i) {
    const int rc = ipp_read_jpeg_coefs(
        paths[i], coefs + stride * i, cap_by, cap_bx, cap_by_c, cap_bx_c,
        qtabs + static_cast<size_t>(i) * 3 * kBlock, infos + i * 16);
    if (rc != 0) infos[i * 16] = rc;
  });
}

// Baseline 4:2:0 file of h x w pixels from the coefficients (the reader's
// dense layout) at `quality`, the quality whose tables quantised them.
// Blocks past each component's grid are ignored.  The file is opened
// before the caps are checked, so -3 leaves it empty.
int ipp_write_jpeg_coefs(const char* path, const int16_t* coefs, int cap_by,
                         int cap_bx, int cap_by_c, int cap_bx_c, int h,
                         int w, int quality) {
  if (h < 1 || w < 1) return kArgs;
  FILE* f = fopen(path, "wb");
  if (!f) return kOpen;
  int bws[3], bhs[3], caps_x[3];
  size_t base[3];
  const size_t y_stride = static_cast<size_t>(cap_by) * cap_bx * kBlock;
  const size_t c_stride = static_cast<size_t>(cap_by_c) * cap_bx_c * kBlock;
  for (int c = 0; c < 3; ++c) {
    const int s = c == 0 ? 2 : 1;  // the component's sampling factor
    bws[c] = ceil_div(static_cast<long>(w) * s, 16);
    bhs[c] = ceil_div(static_cast<long>(h) * s, 16);
    const int cby = c == 0 ? cap_by : cap_by_c;
    caps_x[c] = c == 0 ? cap_bx : cap_bx_c;
    if (bhs[c] > cby || bws[c] > caps_x[c]) {
      fclose(f);
      return kCaps;
    }
    base[c] = c == 0 ? 0 : y_stride + (c - 1) * c_stride;
  }
  if (h > kMaxDimension || w > kMaxDimension) {
    fclose(f);
    return kCodec;
  }
  int rc = 0;
  try {
    std::vector<uint8_t> out;
    out.reserve(4096 + static_cast<size_t>(h) * w / 4);
    encode_file(coefs, base, caps_x, bws, bhs, h, w, quality, &out);
    if (fwrite(out.data(), 1, out.size(), f) != out.size() || fflush(f) != 0)
      rc = kCodec;
  } catch (const std::bad_alloc&) {
    rc = kCodec;
  }
  fclose(f);
  return rc;
}

// Sparse writer: (idx, val) pairs scattered into a dense scratch (a later
// pair for the same position wins), then written as above.
int ipp_write_jpeg_coefs_sparse(const char* path, const int32_t* idx,
                                const int16_t* val, int nnz, int cap_by,
                                int cap_bx, int cap_by_c, int cap_bx_c,
                                int h, int w, int quality) {
  const size_t total = static_cast<size_t>(cap_by) * cap_bx * kBlock +
                       2 * static_cast<size_t>(cap_by_c) * cap_bx_c * kBlock;
  static thread_local std::vector<int16_t> dense;
  dense.assign(total, 0);
  for (int k = 0; k < nnz; ++k) {
    const uint32_t i = static_cast<uint32_t>(idx[k]);
    if (i >= total) return kArgs;
    dense[i] = val[k];
  }
  return ipp_write_jpeg_coefs(path, dense.data(), cap_by, cap_bx, cap_by_c,
                              cap_bx_c, h, w, quality);
}

// Sparse batch writer: rows strided by cap_nnz; nnzs[i] > cap_nnz marks a
// compaction overflow on the device (rc -6, the file untouched).
void ipp_write_jpeg_coefs_sparse_batch(const char** paths, int n,
                                       const int32_t* idxs,
                                       const int16_t* vals, int cap_nnz,
                                       const int* nnzs, int cap_by,
                                       int cap_bx, int cap_by_c,
                                       int cap_bx_c, const int* hs,
                                       const int* ws, int quality,
                                       int* rcs, int n_threads) {
  parallel_items(n, n_threads, [&](int i) {
    if (nnzs[i] > cap_nnz) {
      rcs[i] = kSparse;
      return;
    }
    rcs[i] = ipp_write_jpeg_coefs_sparse(
        paths[i], idxs + static_cast<size_t>(i) * cap_nnz,
        vals + static_cast<size_t>(i) * cap_nnz, nnzs[i], cap_by, cap_bx,
        cap_by_c, cap_bx_c, hs[i], ws[i], quality);
  });
}

}  // extern "C"
