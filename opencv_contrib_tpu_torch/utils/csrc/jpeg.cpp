// Baseline JPEG codec (the port's own, utils/jpeg.py), in place of the
// libjpeg the native IO runtime of the JAX package links and of PIL's.
//
// Decode gives the samples of libjpeg(-turbo)'s default decompression:
// Huffman-coded sequential DCT (SOF0 / SOF1), 8-bit samples, 1 or 3
// components, integral sampling ratios, restart intervals, one or several
// scans; the "islow" integer IDCT with its range limiting (jidctint.c);
// "fancy" triangle upsampling for 2x1, 1x2 and 2x2 ratios and replication
// for the others (jdsample.c); and the fixed-point YCbCr -> RGB tables
// (jdcolor.c). Progressive, arithmetic-coded, lossless, hierarchical,
// 12-bit and 4-component files return a code of their own.
//
// Encode follows libjpeg's baseline compression as PIL drives it: the
// fixed-point RGB -> YCbCr tables (jccolor.c), edge replication and the
// alternating-bias 2x2 / 2x1 downsampling (jcprepct.c, jcsample.c), the
// islow forward DCT (jfdctint.c), quantisation by reciprocal (jcdctmgr.c),
// dummy blocks at the right and bottom edges (jccoefct.c), the standard
// Huffman tables of ITU-T T.81 K.3 and a JFIF APP0.
//
// Plain C interface, built by the host compiler and loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position, with 16 guard entries
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Code {
  OK = 0,
  NO_SOI = 1,
  TRUNCATED = 2,
  BAD_LENGTH = 3,
  BAD_DQT = 4,
  BAD_DHT = 5,
  BAD_SOF = 6,
  BAD_SOS = 7,
  MISSING_TABLE = 8,
  BAD_CODE = 9,
  PREMATURE_END = 10,
  BAD_RESTART = 11,
  NO_FRAME = 12,
  BAD_ARGUMENT = 13,
  PROGRESSIVE = 101,
  ARITHMETIC = 102,
  LOSSLESS = 103,
  HIERARCHICAL = 104,
  PRECISION = 105,
  COMPONENTS = 106,
  SAMPLING = 107,
  DNL = 108,
};

inline int clamp255(long v) { return v < 0 ? 0 : (v > 255 ? 255 : static_cast<int>(v)); }

// ---------------------------------------------------------------- decode

struct HuffTable {
  bool defined = false;
  uint8_t vals[256];
  int maxcode[18];
  int valoffset[18];
  uint16_t look[1 << 9];  // (length << 8) | symbol for codes of <= 9 bits, 0 if longer
};

bool build_huff(HuffTable* t, const uint8_t* bits, const uint8_t* vals, int nvals) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  if (p != nvals) return false;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      t->valoffset[l] = p - huffcode[p];
      p += bits[l - 1];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0x7FFFFFFF;
  std::memcpy(t->vals, vals, nvals);
  std::memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= 9; ++l)
    for (int i = 0; i < bits[l - 1]; ++i, ++p) {
      const int base = huffcode[p] << (9 - l);
      for (int s = 0; s < (1 << (9 - l)); ++s) t->look[base + s] = static_cast<uint16_t>((l << 8) | vals[p]);
    }
  t->defined = true;
  return true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool marker = false;  // a marker (or the end of the data) stopped the byte stream
  long real_bits = 0;   // bits loaded from the data
  long used_bits = 0;   // bits consumed

  void fill() {
    while (bits <= 56) {
      uint64_t c = 0;
      if (!marker && p < end) {
        c = *p;
        if (c == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
            real_bits += 8;
          } else {
            marker = true;  // leave p at the marker; insert zeros from here
            c = 0;
          }
        } else {
          ++p;
          real_bits += 8;
        }
      } else {
        marker = true;
      }
      buf |= c << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek16() {
    if (bits < 16) fill();
    return static_cast<uint32_t>(buf >> 48);
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
    used_bits += n;
  }
  int get(int n) {
    if (n == 0) return 0;
    if (bits < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    skip(n);
    return v;
  }
  // drop the bits left in the buffer (before a restart marker or at the end of a scan)
  void reset() {
    buf = 0;
    bits = 0;
    real_bits = used_bits = 0;
  }
};

inline int decode_symbol(BitReader& br, const HuffTable& t, bool* bad) {
  const uint32_t peek = br.peek16();
  const uint16_t e = t.look[peek >> 7];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = 10; l <= 16; ++l) {
    const int code = static_cast<int>(peek >> (16 - l));
    if (code <= t.maxcode[l]) {
      br.skip(l);
      return t.vals[(t.valoffset[l] + code) & 0xFF];
    }
  }
  *bad = true;
  return 0;
}

inline int extend(int v, int s) { return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int dw, dh;          // downsampled width and height (jdiv_round_up)
  int bw, bh;          // blocks across and down that hold samples
  int stride_b;        // blocks a row of the coefficient array
  std::vector<int16_t> coef;
  int pred = 0;
};

struct Decoder {
  const uint8_t* data;
  long n;
  long pos = 2;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int H = 0, W = 0, nc = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, adobe = false, jfif = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  Component comp[3];

  int u16(long at) const { return (data[at] << 8) | data[at + 1]; }

  int read_dqt(long at, long len) {
    long i = at, stop = at + len;
    while (i < stop) {
      const int pq = data[i] >> 4, tq = data[i] & 15;
      if (tq > 3 || pq > 1) return BAD_DQT;
      ++i;
      if (i + (pq ? 128 : 64) > stop) return BAD_DQT;
      for (int k = 0; k < 64; ++k) {
        qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16(i + 2 * k) : data[i + k]);
      }
      i += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
    return OK;
  }

  int read_dht(long at, long len) {
    long i = at, stop = at + len;
    while (i < stop) {
      if (i + 17 > stop) return BAD_DHT;
      const int tc = data[i] >> 4, th = data[i] & 15;
      if (tc > 1 || th > 3) return BAD_DHT;
      const uint8_t* bits = data + i + 1;
      int count = 0;
      for (int l = 0; l < 16; ++l) count += bits[l];
      if (count > 256 || i + 17 + count > stop) return BAD_DHT;
      if (tc == 0)  // a DC symbol is a bit count: libjpeg refuses one above 15
        for (int v = 0; v < count; ++v)
          if (data[i + 17 + v] > 15) return BAD_DHT;
      if (!build_huff(tc ? &ac[th] : &dc[th], bits, data + i + 17, count)) return BAD_DHT;
      i += 17 + count;
    }
    return OK;
  }

  int read_sof(int marker, long at, long len) {
    if (frame) return BAD_SOF;
    if (marker == 0xC2 || marker == 0xC6) return PROGRESSIVE;
    if (marker == 0xC3 || marker == 0xC7) return LOSSLESS;
    if (marker >= 0xC9) return marker == 0xCB || marker == 0xCF ? LOSSLESS : (marker == 0xCA || marker == 0xCE ? PROGRESSIVE : ARITHMETIC);
    if (marker == 0xC5) return HIERARCHICAL;
    if (len < 6) return BAD_SOF;
    if (data[at] != 8) return PRECISION;
    H = u16(at + 1);
    W = u16(at + 3);
    nc = data[at + 5];
    if (nc != 1 && nc != 3) return COMPONENTS;
    if (len < 6 + 3 * nc) return BAD_SOF;
    if (H == 0) return DNL;
    if (W == 0) return BAD_SOF;
    for (int c = 0; c < nc; ++c) {
      Component& k = comp[c];
      k.id = data[at + 6 + 3 * c];
      k.h = data[at + 7 + 3 * c] >> 4;
      k.v = data[at + 7 + 3 * c] & 15;
      k.tq = data[at + 8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return BAD_SOF;
      if (k.h > hmax) hmax = k.h;
      if (k.v > vmax) vmax = k.v;
    }
    for (int c = 0; c < nc; ++c) {
      if (hmax % comp[c].h || vmax % comp[c].v) return SAMPLING;
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < nc; ++c) {
      Component& k = comp[c];
      k.dw = static_cast<int>((static_cast<long>(W) * k.h + hmax - 1) / hmax);
      k.dh = static_cast<int>((static_cast<long>(H) * k.v + vmax - 1) / vmax);
      k.bw = (k.dw + 7) / 8;
      k.bh = (k.dh + 7) / 8;
      k.stride_b = mcux * k.h;
      k.coef.assign(static_cast<size_t>(mcux) * k.h * mcuy * k.v * 64, 0);
    }
    frame = true;
    return OK;
  }

  int decode_block(BitReader& br, Component& k, int16_t* blk) {
    bool bad = false;
    const HuffTable& d = dc[k.dc_tbl];
    const HuffTable& a = ac[k.ac_tbl];
    const int s = decode_symbol(br, d, &bad);
    if (bad) return BAD_CODE;
    const int diff = s ? extend(br.get(s), s) : 0;
    k.pred += diff;
    blk[0] = static_cast<int16_t>(k.pred);
    for (int i = 1; i < 64; ++i) {
      const int rs = decode_symbol(br, a, &bad);
      if (bad) return BAD_CODE;
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        i += r;
        blk[kNatural[i]] = static_cast<int16_t>(extend(br.get(sz), sz));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    return OK;
  }

  // the entropy-coded data of one scan, from `at`; returns the position after it
  int read_scan(long at, long len, long* next) {
    if (len < 1) return BAD_SOS;
    const int ns = data[at];
    if (ns < 1 || ns > nc || len != 4 + 2 * ns) return BAD_SOS;
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int id = data[at + 1 + 2 * i], tt = data[at + 2 + 2 * i];
      sc[i] = nullptr;
      for (int c = 0; c < nc; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) return BAD_SOS;
      sc[i]->dc_tbl = tt >> 4;
      sc[i]->ac_tbl = tt & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) return BAD_SOS;
      if (!dc[sc[i]->dc_tbl].defined || !ac[sc[i]->ac_tbl].defined || !qt_defined[sc[i]->tq]) return MISSING_TABLE;
      sc[i]->pred = 0;
    }
    const int ss = data[at + 1 + 2 * ns], se = data[at + 2 + 2 * ns], ahl = data[at + 3 + 2 * ns];
    if (ss != 0 || se != 63 || ahl != 0) return PROGRESSIVE;
    BitReader br;
    br.p = data + at + len;
    br.end = data + n;
    long mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = sc[0]->bw;
      mcus_y = sc[0]->bh;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    const long total = mcus_x * mcus_y;
    int togo = restart_interval, rst = 0;
    for (long m = 0; m < total; ++m) {
      if (restart_interval && togo == 0) {
        if (br.used_bits > br.real_bits) return PREMATURE_END;
        // drop the bits left, and any bytes before the next marker, as libjpeg does
        const uint8_t* q = br.p;
        while (q + 1 < br.end && !(q[0] == 0xFF && q[1] != 0x00 && q[1] != 0xFF)) ++q;
        if (q + 1 >= br.end || q[1] != 0xD0 + rst) return BAD_RESTART;
        br.p = q + 2;
        br.marker = false;
        br.reset();
        rst = (rst + 1) & 7;
        togo = restart_interval;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      }
      const long my = m / mcus_x, mx = m % mcus_x;
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int hh = ns == 1 ? 1 : k.h, vv = ns == 1 ? 1 : k.v;
        for (int y = 0; y < vv; ++y)
          for (int x = 0; x < hh; ++x) {
            const long by = my * vv + y, bx = mx * hh + x;
            int16_t* blk = k.coef.data() + (by * k.stride_b + bx) * 64;
            int r = decode_block(br, k, blk);
            if (r) return r;
          }
      }
      if (restart_interval) --togo;
      if (br.used_bits > br.real_bits) return PREMATURE_END;
    }
    // the next marker: skip what is left of the scan's data
    const uint8_t* q = br.p;
    while (q + 1 < br.end && !(q[0] == 0xFF && q[1] != 0x00 && !(q[1] >= 0xD0 && q[1] <= 0xD7))) ++q;
    *next = q - data;
    return OK;
  }

  int parse(bool header_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return NO_SOI;
    pos = 2;
    while (true) {
      while (pos < n && data[pos] != 0xFF) ++pos;  // garbage between segments, as libjpeg skips it
      while (pos < n && data[pos] == 0xFF) ++pos;  // fill bytes
      if (pos >= n) return frame ? OK : NO_FRAME;  // no EOI: what was decoded stands
      const int marker = data[pos++];
      if (marker == 0xD9) return frame ? OK : NO_FRAME;
      if (marker >= 0xD0 && marker <= 0xD7) continue;
      if (marker == 0x01) continue;
      if (pos + 2 > n) return TRUNCATED;
      const long len = u16(pos);
      if (len < 2) return BAD_LENGTH;
      if (pos + len > n) return TRUNCATED;
      const long body = pos + 2, blen = len - 2;
      int r = OK;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 && marker != 0xCC) {
        r = read_sof(marker, body, blen);
        if (r == OK && header_only) return OK;
      } else if (marker == 0xC4) {
        r = read_dht(body, blen);
      } else if (marker == 0xCC) {
        r = ARITHMETIC;
      } else if (marker == 0xDB) {
        r = read_dqt(body, blen);
      } else if (marker == 0xDD) {
        if (blen < 2) return BAD_LENGTH;
        restart_interval = u16(body);
      } else if (marker == 0xDA) {
        if (!frame) return NO_FRAME;
        long next = 0;
        r = read_scan(body, blen, &next);
        if (r) return r;
        pos = next;
        continue;
      } else if (marker == 0xE0) {
        if (blen >= 5 && std::memcmp(data + body, "JFIF\0", 5) == 0) jfif = true;
      } else if (marker == 0xEE) {
        if (blen >= 12 && std::memcmp(data + body, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[body + 11];
        }
      } else if (marker == 0xDC) {
        return DNL;
      }
      if (r) return r;
      pos = body + blen;
    }
  }
};

// jidctint.c jpeg_idct_islow, one block into `out` (row stride `stride`)
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633, F1501 = 12299,
               F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

inline uint8_t idct_limit(long x) {
  const int v = static_cast<int>(x) & 1023;  // RANGE_MASK: the post-IDCT table of jdmaster.c
  if (v < 128) return static_cast<uint8_t>(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return static_cast<uint8_t>(v - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, long stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dcval = static_cast<int>(static_cast<long>(ip[0]) * qp[0] * (1L << PASS1_BITS));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    long z2 = static_cast<long>(ip[16]) * qp[16], z3 = static_cast<long>(ip[48]) * qp[48];
    long z1 = (z2 + z3) * F0541;
    long tmp2 = z1 + z3 * (-F1847);
    long tmp3 = z1 + z2 * F0765;
    z2 = static_cast<long>(ip[0]) * qp[0];
    z3 = static_cast<long>(ip[32]) * qp[32];
    long tmp0 = (z2 + z3) * (1L << CONST_BITS);
    long tmp1 = (z2 - z3) * (1L << CONST_BITS);
    const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<long>(ip[56]) * qp[56];
    tmp1 = static_cast<long>(ip[40]) * qp[40];
    tmp2 = static_cast<long>(ip[24]) * qp[24];
    tmp3 = static_cast<long>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    const long z5 = (z3 + z4) * F1175;
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
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = idct_limit(descale(wp[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * F0541;
    long tmp2 = z1 + z3 * (-F1847);
    long tmp3 = z1 + z2 * F0765;
    long tmp0 = (static_cast<long>(wp[0]) + wp[4]) * (1L << CONST_BITS);
    long tmp1 = (static_cast<long>(wp[0]) - wp[4]) * (1L << CONST_BITS);
    const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    const long z5 = (z3 + z4) * F1175;
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
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// the component's samples at full resolution (H x W), upsampled as jdsample.c does
void upsample(const Component& k, const uint8_t* plane, long pstride, int hr, int vr, int H, int W, uint8_t* out) {
  const int dw = k.dw, dh = k.dh;
  auto at = [&](int y, int x) -> int { return plane[static_cast<long>(y) * pstride + x]; };
  std::vector<uint8_t> row(static_cast<size_t>(dw) * hr + 2);
  for (int oy = 0; oy < H; ++oy) {
    uint8_t* o = out + static_cast<long>(oy) * W;
    if (hr == 1 && vr == 1) {
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(at(oy, x));
    } else if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      const int y = oy;
      row[0] = static_cast<uint8_t>(at(y, 0));
      row[1] = static_cast<uint8_t>((at(y, 0) * 3 + at(y, 1) + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        const int v3 = at(y, c) * 3;
        row[2 * c] = static_cast<uint8_t>((v3 + at(y, c - 1) + 1) >> 2);
        row[2 * c + 1] = static_cast<uint8_t>((v3 + at(y, c + 1) + 2) >> 2);
      }
      row[2 * dw - 2] = static_cast<uint8_t>((at(y, dw - 1) * 3 + at(y, dw - 2) + 1) >> 2);
      row[2 * dw - 1] = static_cast<uint8_t>(at(y, dw - 1));
      std::memcpy(o, row.data(), W);
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      const int y = oy >> 1, odd = oy & 1;
      const int y1 = odd ? (y + 1 < dh ? y + 1 : dh - 1) : (y > 0 ? y - 1 : 0);
      const int bias = odd ? 2 : 1;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((at(y, x) * 3 + at(y1, x) + bias) >> 2);
    } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      const int y = oy >> 1, odd = oy & 1;
      const int y1 = odd ? (y + 1 < dh ? y + 1 : dh - 1) : (y > 0 ? y - 1 : 0);
      auto colsum = [&](int c) { return at(y, c) * 3 + at(y1, c); };
      int thiscol = colsum(0), nextcol = colsum(1), lastcol;
      row[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
      row[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
      for (int c = 1; c < dw - 1; ++c) {
        nextcol = colsum(c + 1);
        row[2 * c] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        row[2 * c + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      row[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      row[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      std::memcpy(o, row.data(), W);
    } else {  // replication (h2v1_upsample, h2v2_upsample, int_upsample)
      const int y = oy / vr;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(at(y, x / hr));
    }
  }
}

int decode_into(Decoder& d, uint8_t* out) {
  const int H = d.H, W = d.W;
  std::vector<std::vector<uint8_t>> full(d.nc);
  for (int c = 0; c < d.nc; ++c) {
    Component& k = d.comp[c];
    const long pstride = static_cast<long>(k.bw) * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pstride) * k.bh * 8);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(k.coef.data() + (static_cast<long>(by) * k.stride_b + bx) * 64, d.qt[k.tq],
                   plane.data() + static_cast<long>(by) * 8 * pstride + bx * 8, pstride);
    full[c].resize(static_cast<size_t>(H) * W);
    upsample(k, plane.data(), pstride, d.hmax / k.h, d.vmax / k.v, H, W, full[c].data());
  }
  const long npx = static_cast<long>(H) * W;
  if (d.nc == 1) {
    std::memcpy(out, full[0].data(), npx);
    return OK;
  }
  // jpeg_read_header's default colour space: YCbCr with a JFIF marker; else
  // RGB for an Adobe marker with transform 0, or, with neither marker, for
  // component ids 'R', 'G', 'B'; YCbCr otherwise
  bool rgb = false;
  if (d.jfif) {
    rgb = false;
  } else if (d.adobe) {
    rgb = d.adobe_transform == 0;
  } else {
    rgb = d.comp[0].id == 'R' && d.comp[1].id == 'G' && d.comp[2].id == 'B';
  }
  const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
  if (rgb) {
    for (long i = 0; i < npx; ++i) {
      out[3 * i] = Y[i];
      out[3 * i + 1] = Cb[i];
      out[3 * i + 2] = Cr[i];
    }
    return OK;
  }
  constexpr int SCALEBITS = 16;
  constexpr long ONE_HALF = 1L << (SCALEBITS - 1);
  auto FIX = [](double x) { return static_cast<long>(x * (1L << SCALEBITS) + 0.5); };
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const long x = i - 128;
    cr_r[i] = static_cast<int>((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = static_cast<int>((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -FIX(0.71414) * x;
    cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
  }
  for (long i = 0; i < npx; ++i) {
    const int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i] = static_cast<uint8_t>(clamp255(y + cr_r[cr]));
    out[3 * i + 1] = static_cast<uint8_t>(clamp255(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS)));
    out[3 * i + 2] = static_cast<uint8_t>(clamp255(y + cb_b[cb]));
  }
  return OK;
}

// ---------------------------------------------------------------- encode

const uint8_t kLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                            14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                            18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                            49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
                              99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
};

void build_enc(EncTable* t, const uint8_t* bits, const uint8_t* vals) {
  std::memset(t->size, 0, sizeof(t->size));
  int code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++p) {
      t->code[vals[p]] = static_cast<uint16_t>(code++);
      t->size[vals[p]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

struct Writer {
  uint8_t* out;
  long cap, n = 0;
  uint32_t acc = 0;
  int nacc = 0;
  bool overflow = false;
  void byte(int b) {
    if (n < cap) out[n] = static_cast<uint8_t>(b);
    else overflow = true;
    ++n;
  }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void bits(uint32_t code, int size) {
    if (!size) return;
    acc = (acc << size) | (code & ((1u << size) - 1));
    nacc += size;
    while (nacc >= 8) {
      const int b = (acc >> (nacc - 8)) & 0xFF;
      byte(b);
      if (b == 0xFF) byte(0);
      nacc -= 8;
    }
  }
  void flush() {  // jchuff.c flush_bits: pad the last byte with 1s
    bits(0x7F, 7);
    acc = 0;
    nacc = 0;
  }
};

inline int nbits(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jfdctint.c jpeg_fdct_islow: data holds the level-shifted samples, in place
void fdct_islow(int* data) {
  for (int r = 0; r < 8; ++r) {
    int* d = data + 8 * r;
    long tmp0 = d[0] + d[7], tmp7 = d[0] - d[7], tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
    long tmp2 = d[2] + d[5], tmp5 = d[2] - d[5], tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
    const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = static_cast<int>((tmp10 + tmp11) * (1L << PASS1_BITS));
    d[4] = static_cast<int>((tmp10 - tmp11) * (1L << PASS1_BITS));
    long z1 = (tmp12 + tmp13) * F0541;
    d[2] = static_cast<int>(descale(z1 + tmp13 * F0765, CONST_BITS - PASS1_BITS));
    d[6] = static_cast<int>(descale(z1 + tmp12 * (-F1847), CONST_BITS - PASS1_BITS));
    z1 = tmp4 + tmp7;
    long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const long z5 = (z3 + z4) * F1175;
    tmp4 *= F0298;
    tmp5 *= F2053;
    tmp6 *= F3072;
    tmp7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    d[7] = static_cast<int>(descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS));
    d[5] = static_cast<int>(descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS));
    d[3] = static_cast<int>(descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS));
    d[1] = static_cast<int>(descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS));
  }
  for (int c = 0; c < 8; ++c) {
    int* d = data + c;
    long tmp0 = d[0] + d[56], tmp7 = d[0] - d[56], tmp1 = d[8] + d[48], tmp6 = d[8] - d[48];
    long tmp2 = d[16] + d[40], tmp5 = d[16] - d[40], tmp3 = d[24] + d[32], tmp4 = d[24] - d[32];
    const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = static_cast<int>(descale(tmp10 + tmp11, PASS1_BITS));
    d[32] = static_cast<int>(descale(tmp10 - tmp11, PASS1_BITS));
    long z1 = (tmp12 + tmp13) * F0541;
    d[16] = static_cast<int>(descale(z1 + tmp13 * F0765, CONST_BITS + PASS1_BITS));
    d[48] = static_cast<int>(descale(z1 + tmp12 * (-F1847), CONST_BITS + PASS1_BITS));
    z1 = tmp4 + tmp7;
    long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const long z5 = (z3 + z4) * F1175;
    tmp4 *= F0298;
    tmp5 *= F2053;
    tmp6 *= F3072;
    tmp7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    d[56] = static_cast<int>(descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS));
    d[40] = static_cast<int>(descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS));
    d[24] = static_cast<int>(descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS));
    d[8] = static_cast<int>(descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS));
  }
}

// jcdctmgr.c compute_reciprocal / quantize, with 16-bit DCT elements
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

inline int quantize(int x, const Divisor& d) {
  int16_t t = static_cast<int16_t>(x);
  const bool neg = t < 0;
  if (neg) t = static_cast<int16_t>(-t);
  uint32_t product = static_cast<uint32_t>(t + static_cast<int>(d.corr)) * d.recip;
  product >>= d.shift + 16;
  int16_t q = static_cast<int16_t>(product);
  return neg ? -q : q;
}

void quality_table(const uint8_t* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;  // force_baseline
    out[i] = static_cast<uint16_t>(t);
  }
}

}  // namespace

// Decode the JPEG bytes data[0:n]. info receives H, W, C; with out null only
// the frame header is read. Returns 0 or a code of utils/jpeg.py's table.
extern "C" int jpeg_decode(const uint8_t* data, long n, uint8_t* out, int* info) {
  Decoder d;
  d.data = data;
  d.n = n;
  int r = d.parse(out == nullptr);
  if (r) return r;
  info[0] = d.H;
  info[1] = d.W;
  info[2] = d.nc;
  if (out == nullptr) return OK;
  return decode_into(d, out);
}

// Encode img (H x W x C uint8, C = 1 or 3) at `quality` with luma sampling
// hs x vs (chroma 1 x 1). Writes at most cap bytes to out; *size receives the
// length (more than cap: call again with a larger buffer).
extern "C" int jpeg_encode(const uint8_t* img, int H, int W, int C, int quality, int hs, int vs, uint8_t* out,
                           long cap, long* size) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535 || (C != 1 && C != 3) || hs < 1 || hs > 2 || vs < 1 || vs > 2)
    return BAD_ARGUMENT;
  if (C == 1) hs = vs = 1;
  const int hmax = hs, vmax = vs;
  const long npx = static_cast<long>(H) * W;
  // colour conversion (jccolor.c rgb_ycc_convert / grayscale)
  std::vector<std::vector<uint8_t>> full(C, std::vector<uint8_t>(npx));
  if (C == 1) {
    std::memcpy(full[0].data(), img, npx);
  } else {
    constexpr int SCALEBITS = 16;
    constexpr long ONE_HALF = 1L << (SCALEBITS - 1), CBCR_OFFSET = 128L << SCALEBITS;
    auto FIX = [](double x) { return static_cast<long>(x * (1L << SCALEBITS) + 0.5); };
    long ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
    for (long i = 0; i < 256; ++i) {
      ry[i] = FIX(0.29900) * i;
      gy[i] = FIX(0.58700) * i;
      by[i] = FIX(0.11400) * i + ONE_HALF;
      rcb[i] = -FIX(0.16874) * i;
      gcb[i] = -FIX(0.33126) * i;
      bcb[i] = FIX(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;
      gcr[i] = -FIX(0.41869) * i;
      bcr[i] = -FIX(0.08131) * i;
    }
    for (long i = 0; i < npx; ++i) {
      const int r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      full[0][i] = static_cast<uint8_t>((ry[r] + gy[g] + by[b]) >> SCALEBITS);
      full[1][i] = static_cast<uint8_t>((rcb[r] + gcb[g] + bcb[b]) >> SCALEBITS);
      full[2][i] = static_cast<uint8_t>((bcb[r] + gcr[g] + bcr[b]) >> SCALEBITS);
    }
  }
  const int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);
  struct EncComp {
    int h, v, bw, bh, pw, ph;
    std::vector<uint8_t> plane;  // downsampled, padded to pw x ph
  };
  std::vector<EncComp> comps(C);
  for (int c = 0; c < C; ++c) {
    EncComp& k = comps[c];
    k.h = c == 0 ? hs : 1;
    k.v = c == 0 ? vs : 1;
    const int hr = hmax / k.h, vr = vmax / k.v;
    k.bw = static_cast<int>((static_cast<long>(W) * k.h + 8 * hmax - 1) / (8 * hmax));  // width_in_blocks
    k.bh = static_cast<int>((static_cast<long>(H) * k.v + 8 * vmax - 1) / (8 * vmax));
    k.pw = k.bw * 8;
    k.ph = mcuy * k.v * 8;
    // the colour buffer: the right edge replicated to pw * hr columns, the
    // last row replicated to a whole row group of vmax rows (jcprepct.c)
    const int ih = ((H + vmax - 1) / vmax) * vmax;
    auto src = [&](int y, int x) -> int {
      return full[c][static_cast<long>(y < H ? y : H - 1) * W + (x < W ? x : W - 1)];
    };
    const int rows = (ih / vmax) * k.v;  // downsampled rows made from the row groups
    k.plane.assign(static_cast<size_t>(k.pw) * k.ph, 0);
    for (int y = 0; y < rows; ++y) {
      uint8_t* o = k.plane.data() + static_cast<long>(y) * k.pw;
      if (hr == 1 && vr == 1) {
        for (int x = 0; x < k.pw; ++x) o[x] = static_cast<uint8_t>(src(y, x));
      } else if (hr == 2 && vr == 2) {  // h2v2_downsample: bias 1, 2, 1, 2, ...
        int bias = 1;
        for (int x = 0; x < k.pw; ++x) {
          o[x] = static_cast<uint8_t>((src(2 * y, 2 * x) + src(2 * y, 2 * x + 1) + src(2 * y + 1, 2 * x) +
                                       src(2 * y + 1, 2 * x + 1) + bias) >> 2);
          bias ^= 3;
        }
      } else if (hr == 2 && vr == 1) {  // h2v1_downsample: bias 0, 1, 0, 1, ...
        int bias = 0;
        for (int x = 0; x < k.pw; ++x) {
          o[x] = static_cast<uint8_t>((src(y, 2 * x) + src(y, 2 * x + 1) + bias) >> 1);
          bias ^= 1;
        }
      } else {  // int_downsample (1 x 2): the rounded mean
        for (int x = 0; x < k.pw; ++x) o[x] = static_cast<uint8_t>((src(2 * y, x) + src(2 * y + 1, x) + 1) / 2);
      }
    }
    for (int y = rows; y < k.ph; ++y)  // the bottom padded to a whole iMCU row
      std::memcpy(k.plane.data() + static_cast<long>(y) * k.pw, k.plane.data() + static_cast<long>(rows - 1) * k.pw,
                  k.pw);
  }
  uint16_t qtab[2][64];
  quality_table(kLumaQ, quality, qtab[0]);
  quality_table(kChromaQ, quality, qtab[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(static_cast<uint32_t>(qtab[t][i]) << 3);
  EncTable dct[2], act[2];
  build_enc(&dct[0], kDcLumaBits, kDcVals);
  build_enc(&act[0], kAcLumaBits, kAcLumaVals);
  build_enc(&dct[1], kDcChromaBits, kDcVals);
  build_enc(&act[1], kAcChromaBits, kAcChromaVals);

  Writer w{out, cap};
  // SOI, JFIF APP0 (version 1.01, no density unit, 1:1)
  w.u16(0xFFD8);
  w.u16(0xFFE0);
  w.u16(16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : jfif) w.byte(b);
  const int ntab = C == 1 ? 1 : 2;
  for (int t = 0; t < ntab; ++t) {  // DQT, one table a segment, in zigzag order
    w.u16(0xFFDB);
    w.u16(67);
    w.byte(t);
    for (int i = 0; i < 64; ++i) w.byte(qtab[t][kNatural[i]]);
  }
  w.u16(0xFFC0);  // SOF0
  w.u16(8 + 3 * C);
  w.byte(8);
  w.u16(H);
  w.u16(W);
  w.byte(C);
  for (int c = 0; c < C; ++c) {
    w.byte(c + 1);
    w.byte((comps[c].h << 4) | comps[c].v);
    w.byte(c == 0 ? 0 : 1);
  }
  for (int t = 0; t < ntab; ++t) {  // DHT: DC then AC of each table
    const uint8_t* bits[2] = {t ? kDcChromaBits : kDcLumaBits, t ? kAcChromaBits : kAcLumaBits};
    const uint8_t* vals[2] = {kDcVals, t ? kAcChromaVals : kAcLumaVals};
    const int nv[2] = {12, 162};
    for (int a = 0; a < 2; ++a) {
      w.u16(0xFFC4);
      w.u16(2 + 1 + 16 + nv[a]);
      w.byte((a << 4) | t);
      for (int l = 0; l < 16; ++l) w.byte(bits[a][l]);
      for (int i = 0; i < nv[a]; ++i) w.byte(vals[a][i]);
    }
  }
  w.u16(0xFFDA);  // SOS
  w.u16(6 + 2 * C);
  w.byte(C);
  for (int c = 0; c < C; ++c) {
    w.byte(c + 1);
    w.byte(c == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  // a single-component scan is not interleaved: its MCU is one block
  const bool single = C == 1;
  const long mcus_x = single ? comps[0].bw : mcux, mcus_y = single ? comps[0].bh : mcuy;
  int pred[3] = {0, 0, 0};
  std::vector<int> blocks;  // the MCU's quantised blocks, natural order
  int ws[64];
  for (long my = 0; my < mcus_y; ++my)
    for (long mx = 0; mx < mcus_x; ++mx) {
      for (int c = 0; c < C; ++c) {
        EncComp& k = comps[c];
        const int t = c == 0 ? 0 : 1;
        const int hh = single ? 1 : k.h, vv = single ? 1 : k.v;
        blocks.assign(static_cast<size_t>(hh) * vv * 64, 0);
        for (int y = 0; y < vv; ++y)
          for (int x = 0; x < hh; ++x) {
            int* blk = blocks.data() + (y * hh + x) * 64;
            const long by = my * vv + y, bx = mx * hh + x;
            if (by < k.bh) {
              if (bx < k.bw) {
                for (int r = 0; r < 8; ++r)
                  for (int q = 0; q < 8; ++q)
                    ws[8 * r + q] = k.plane[(by * 8 + r) * k.pw + bx * 8 + q] - 128;
                fdct_islow(ws);
                for (int i = 0; i < 64; ++i) blk[i] = quantize(ws[i], div[t][i]);
              } else {
                blk[0] = blk[-64];  // a dummy block at the right edge: the DC of the one to its left
              }
            } else {
              blk[0] = blocks[(y * hh) * 64 - 64];  // a dummy row: the DC of the row above's last block
            }
          }
        for (int b = 0; b < hh * vv; ++b) {
          const int* blk = blocks.data() + b * 64;
          int temp = blk[0] - pred[c];
          pred[c] = blk[0];
          int temp2 = temp;
          if (temp < 0) {
            temp = -temp;
            --temp2;
          }
          int nb = nbits(temp);
          w.bits(dct[t].code[nb], dct[t].size[nb]);
          if (nb) w.bits(static_cast<uint32_t>(temp2), nb);
          int run = 0;
          for (int i = 1; i < 64; ++i) {
            temp = blk[kNatural[i]];
            if (temp == 0) {
              ++run;
              continue;
            }
            while (run > 15) {
              w.bits(act[t].code[0xF0], act[t].size[0xF0]);
              run -= 16;
            }
            temp2 = temp;
            if (temp < 0) {
              temp = -temp;
              --temp2;
            }
            nb = nbits(temp);
            const int sym = (run << 4) + nb;
            w.bits(act[t].code[sym], act[t].size[sym]);
            w.bits(static_cast<uint32_t>(temp2), nb);
            run = 0;
          }
          if (run > 0) w.bits(act[t].code[0], act[t].size[0]);
        }
      }
    }
  w.flush();
  w.u16(0xFFD9);
  *size = w.n;
  return OK;
}
