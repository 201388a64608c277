// JPEG decoder and encoder with libjpeg's default arithmetic, for the port's
// image reading and writing on a machine without OpenCV or Pillow.
//
// The decoder gives what libjpeg (libjpeg-turbo's defaults, as OpenCV's
// imread asks for them) gives: Huffman-coded sequential (SOF0, SOF1) and
// progressive (SOF2) 8-bit frames of 1 or 3 components, any integral
// sampling (fancy triangle upsampling for 2h1v, 1h2v and 2h2v, replication
// otherwise), restart intervals, the integer "islow" IDCT in the 16-bit
// lanes of libjpeg-turbo's x86 SIMD code, and the fixed-point YCbCr -> RGB
// tables. A scan cut short decodes as libjpeg decodes it: the bits past
// the end read as zeros for the MCU in progress, and the later MCUs are left
// as they are (zero coefficients in a first scan); a progressive image whose
// low AC terms did not all arrive is smoothed from the DC of each block's
// 5 x 5 neighbours, as libjpeg-turbo 2.1 on does by default. Gray is
// replicated to three channels. Arithmetic coding,
// 12-bit and lossless or hierarchical frames, and 4-component files are
// refused with their own codes.
//
// The encoder gives what libjpeg gives for jpeg_set_defaults +
// jpeg_set_quality(q, TRUE): a JFIF APP0, baseline sequential, the Annex K
// quantization tables scaled by quality and the Annex K Huffman tables,
// 4:2:0 chroma (libjpeg's alternating-bias 2x2 averaging, its edge
// replication and dummy blocks), the islow FDCT and libjpeg-turbo's
// reciprocal quantization. Input RGB (3 channels) or gray (1).
//
// Plain C interface, bound with ctypes (native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> natural index; 16 extra entries for corrupt run lengths
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Err {
  E_OK = 0,
  E_NOT_JPEG = -1,
  E_ARITH = -2,
  E_PRECISION = -3,
  E_LOSSLESS = -4,
  E_CMYK = -5,
  E_CORRUPT = -6,
  E_NO_FRAME = -7,
  E_COMPONENTS = -8,
  E_SAMPLING = -9,
  E_SPACE = -10,
};

// --------------------------------------------------------------------------
// decoder
// --------------------------------------------------------------------------

struct HuffDec {
  bool present = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t look_nbits[512];  // 9-bit lookahead: 0 = longer code
  uint8_t look_sym[512];

  bool build(const uint8_t* bits, const uint8_t* v, int nvals) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int numsymbols = p;
    if (numsymbols != nvals || numsymbols > 256) return false;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) return false;
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memcpy(vals, v, nvals);
    std::memset(look_nbits, 0, sizeof(look_nbits));
    p = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 1; i <= bits[l - 1]; i++, p++) {
        int lookbits = huffcode[p] << (9 - l);
        for (int ctr = 1 << (9 - l); ctr > 0; ctr--) {
          look_nbits[lookbits] = (uint8_t)l;
          look_sym[lookbits] = vals[p];
          lookbits++;
        }
      }
    }
    present = true;
    return true;
  }
};

struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t buf = 0;  // MSB-aligned
  int cnt = 0;
  int marker = 0;  // marker met in the entropy data and not yet read
  bool insufficient = false;

  void fill() {
    while (cnt <= 56) {
      if (marker) return;
      if (pos >= n) {  // the source's fake EOI at the end of the file
        marker = 0xD9;
        return;
      }
      int c = d[pos++];
      if (c == 0xFF) {
        do {
          if (pos >= n) {
            marker = 0xD9;
            return;
          }
          c = d[pos++];
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker = c;
          return;
        }
      }
      buf |= (uint64_t)c << (56 - cnt);
      cnt += 8;
    }
  }
  void need(int k) {
    if (cnt < k) {
      fill();
      if (cnt < k) {  // past a marker: zeros
        insufficient = true;
        cnt = 64;
      }
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    need(k);
    int v = (int)(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int bit() { return get(1); }
  int decode(const HuffDec& h) {
    if (cnt < 9) fill();
    if (cnt >= 9) {
      int look = (int)(buf >> 55);
      int nb = h.look_nbits[look];
      if (nb) {
        buf <<= nb;
        cnt -= nb;
        return h.look_sym[look];
      }
    }
    int l = 1;
    int32_t code = get(1);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // bad code: libjpeg warns and returns 0
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  void reset_bits() {
    buf = 0;
    cnt = 0;
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)((-1u) << s) + 1 : r; }

struct Comp {
  int id, h, v, tq;
  int bw, bh;          // coefficient grid in blocks (MCU-aligned)
  int wblocks, hblocks;  // blocks that hold image data
  int dsw, dsh;        // downsampled size
  std::vector<int16_t> coef;
  uint16_t quant[64];
  bool quant_latched = false;
  int dc_pred = 0;
  // the successive-approximation bit of coefficients 0-9 (zigzag order)
  // after the latest scan that carried them, -1 before any, and the same
  // before the scan in progress (libjpeg's coef_bits and its copy)
  int coef_bits[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
  int prev_bits[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
  int16_t* block(int bx, int by) { return &coef[((size_t)by * bw + bx) * 64]; }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  int restart_interval = 0;
  bool frame = false, progressive = false;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Comp> comps;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool done = false;  // EOI (real or fake) reached
  int scans = 0;      // scans begun
  // the last iMCU row that the latest scan decoded from data: later rows
  // keep what the scans before it gave (libjpeg's last_good_iMCU_row)
  int last_good_row = 0;

  int read_u16(size_t at) { return (d[at] << 8) | d[at + 1]; }

  // the next marker at or after pos, skipping garbage; 0 at end of data
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) pos++;
      if (pos >= n) return 0;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) return 0;
      int m = d[pos++];
      if (m != 0) return m;
    }
  }

  int parse_sof(int m, size_t seg, int len) {
    if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF || m == 0xC5 || m == 0xC6 ||
        m == 0xCD || m == 0xCE)
      return (m == 0xCD || m == 0xCE) ? E_ARITH : E_LOSSLESS;
    if (m >= 0xC9) return E_ARITH;
    if (len < 6) return E_CORRUPT;
    int prec = d[seg];
    if (prec != 8) return E_PRECISION;
    height = read_u16(seg + 1);
    width = read_u16(seg + 3);
    int nc = d[seg + 5];
    if (nc == 4) return E_CMYK;
    if (nc != 1 && nc != 3) return E_COMPONENTS;
    if (len < 6 + 3 * nc || width <= 0 || height <= 0) return E_CORRUPT;
    comps.resize(nc);
    hmax = vmax = 1;
    for (int i = 0; i < nc; i++) {
      Comp& c = comps[i];
      c.id = d[seg + 6 + 3 * i];
      c.h = d[seg + 7 + 3 * i] >> 4;
      c.v = d[seg + 7 + 3 * i] & 15;
      c.tq = d[seg + 8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return E_SAMPLING;
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Comp& c : comps) {
      if (hmax % c.h || vmax % c.v) return E_SAMPLING;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dsw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dsh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.wblocks = (c.dsw + 7) / 8;
      c.hblocks = (c.dsh + 7) / 8;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    progressive = (m == 0xC2);
    frame = true;
    return E_OK;
  }

  int parse_dqt(size_t seg, int len) {
    size_t end = seg + len, p = seg;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      p++;
      if (tq > 3) return E_CORRUPT;
      int sz = pq ? 128 : 64;
      if (p + sz > end) return E_CORRUPT;
      for (int i = 0; i < 64; i++) {
        int v = pq ? read_u16(p + 2 * i) : d[p + i];
        qt[tq][kNatural[i]] = (uint16_t)v;
      }
      qt_present[tq] = true;
      p += sz;
    }
    return E_OK;
  }

  int parse_dht(size_t seg, int len) {
    size_t end = seg + len, p = seg;
    while (p < end) {
      if (p + 17 > end) return E_CORRUPT;
      int tc = d[p] >> 4, th = d[p] & 15;
      if (th > 3) return E_CORRUPT;
      const uint8_t* bits = d + p + 1;
      int total = 0;
      for (int i = 0; i < 16; i++) total += bits[i];
      if (total > 256 || p + 17 + total > end) return E_CORRUPT;
      HuffDec& h = tc ? ac[th] : dc[th];
      if (!h.build(bits, d + p + 17, total)) return E_CORRUPT;
      p += 17 + total;
    }
    return E_OK;
  }

  void parse_app(int m, size_t seg, int len) {
    if (m == 0xE0 && len >= 5 && std::memcmp(d + seg, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && len >= 12 && std::memcmp(d + seg, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[seg + 11];
    }
  }

  // ---- scans --------------------------------------------------------------
  int ns = 0;
  Comp* sc[4];
  int scomp_idx[4], td[4], ta[4];
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  int eobrun = 0;

  bool restart(BitReader& br, int& next_rst) {
    br.reset_bits();
    if (!br.marker) {
      // skip to the next marker
      size_t p = br.pos;
      for (;;) {
        while (p < n && d[p] != 0xFF) p++;
        if (p >= n) {
          br.marker = 0xD9;
          break;
        }
        while (p < n && d[p] == 0xFF) p++;
        if (p >= n) {
          br.marker = 0xD9;
          break;
        }
        int m = d[p++];
        if (m) {
          br.marker = m;
          break;
        }
      }
      br.pos = p;
    }
    int desired = next_rst;
    for (;;) {
      int m = br.marker;
      int action;
      if (m == 0xD0 + desired) {
        action = 0;
      } else if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 0 || action == 1) {
        br.marker = 0;
        break;
      }
      if (action == 3) break;
      // action 2: scan to the next marker and decide again
      br.marker = 0;
      size_t p = br.pos;
      int found = 0xD9;
      while (p < n) {
        if (d[p++] != 0xFF) continue;
        while (p < n && d[p] == 0xFF) p++;
        if (p >= n) break;
        int mm = d[p++];
        if (mm) {
          found = mm;
          break;
        }
      }
      br.pos = p;
      br.marker = found;
    }
    next_rst = (next_rst + 1) & 7;
    for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
    eobrun = 0;
    if (br.marker == 0) br.insufficient = false;
    return true;
  }

  void decode_block_baseline(BitReader& br, Comp& c, int16_t* blk, const HuffDec& dct,
                             const HuffDec& act) {
    int s = br.decode(dct);
    if (s) {
      int r = br.get(s);
      s = extend(r, s);
    }
    s += c.dc_pred;
    c.dc_pred = s;
    blk[0] = (int16_t)s;
    for (int k = 1; k < 64; k++) {
      s = br.decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = br.get(s);
        s = extend(r, s);
        blk[kNatural[k]] = (int16_t)s;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(BitReader& br, Comp& c, int16_t* blk, const HuffDec& dct) {
    int s = br.decode(dct);
    if (s) {
      int r = br.get(s);
      s = extend(r, s);
    }
    s += c.dc_pred;
    c.dc_pred = s;
    blk[0] = (int16_t)(int)((unsigned)s << Al);
  }

  void decode_dc_refine(BitReader& br, int16_t* blk) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << Al));
  }

  void decode_ac_first(BitReader& br, int16_t* blk, const HuffDec& act) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = Ss; k <= Se; k++) {
      int s = br.decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = br.get(s);
        s = extend(r, s);
        blk[kNatural[k]] = (int16_t)(int)((unsigned)s << Al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
    }
  }

  void decode_ac_refine(BitReader& br, int16_t* blk, const HuffDec& act) {
    int p1 = 1 << Al;
    int m1 = (int)((unsigned)-1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; k++) {
        int s = br.decode(act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else {
          if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            break;
          }
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1)) {
              if ((*coef & p1) == 0) {
                if (*coef >= 0)
                  *coef = (int16_t)(*coef + p1);
                else
                  *coef = (int16_t)(*coef + m1);
              }
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1)) {
            if ((*coef & p1) == 0) {
              if (*coef >= 0)
                *coef = (int16_t)(*coef + p1);
              else
                *coef = (int16_t)(*coef + m1);
            }
          }
        }
      }
      eobrun--;
    }
  }

  void decode_mcu_block(BitReader& br, int i, int bx, int by) {
    Comp& c = *sc[i];
    int16_t* blk = c.block(bx, by);
    if (!progressive) {
      decode_block_baseline(br, c, blk, dc[td[i]], ac[ta[i]]);
    } else if (Ss == 0) {
      if (Ah == 0)
        decode_dc_first(br, c, blk, dc[td[i]]);
      else
        decode_dc_refine(br, blk);
    } else if (Ah == 0) {
      decode_ac_first(br, blk, ac[ta[i]]);
    } else {
      decode_ac_refine(br, blk, ac[ta[i]]);
    }
  }

  // Decodes the entropy-coded data of the scan whose header ended at pos;
  // leaves pos at the marker that follows it.
  int decode_scan() {
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      if (!c.quant_latched) {
        if (!qt_present[c.tq]) return E_CORRUPT;
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.quant_latched = true;
      }
      bool need_dc = !progressive || (Ss == 0 && Ah == 0);
      bool need_ac = !progressive ? true : Ss > 0;
      if (need_dc && !dc[td[i]].present) return E_CORRUPT;
      if (need_ac && !ac[ta[i]].present) return E_CORRUPT;
      c.dc_pred = 0;
    }
    scans++;
    if (progressive)
      for (int i = 0; i < ns; i++) {
        Comp& c = *sc[i];
        for (int k = Ss < 1 ? Ss : 1; k <= (Se > 9 ? Se : 9) && k < 10; k++)
          c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
        for (int k = Ss; k <= Se && k < 10; k++) c.coef_bits[k] = Al;
      }
    eobrun = 0;
    BitReader br;
    br.d = d;
    br.n = n;
    br.pos = pos;
    int next_rst = 0;
    int restarts_to_go = restart_interval;
    auto mcu_start = [&]() {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          restart(br, next_rst);
          restarts_to_go = restart_interval;
        }
        restarts_to_go--;
      }
    };
    if (ns == 1) {
      Comp& c = *sc[0];
      for (int by = 0; by < c.hblocks; by++)
        for (int bx = 0; bx < c.wblocks; bx++) {
          mcu_start();
          if (br.insufficient) continue;
          last_good_row = by / c.v;
          decode_mcu_block(br, 0, bx, by);
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          mcu_start();
          if (br.insufficient) continue;
          last_good_row = my;
          for (int i = 0; i < ns; i++) {
            Comp& c = *sc[i];
            for (int yy = 0; yy < c.v; yy++)
              for (int xx = 0; xx < c.h; xx++)
                decode_mcu_block(br, i, mx * c.h + xx, my * c.v + yy);
          }
        }
    }
    // continue from the marker that ended the scan
    if (br.marker) {
      if (br.marker == 0xD9 && br.pos >= n) {
        done = true;  // the data ran out: the fake EOI
        pos = n;
        return E_OK;
      }
      // step back so that the main loop reads the marker again
      pos = br.pos - 2;
      while (pos > 0 && !(d[pos] == 0xFF && d[pos + 1] == br.marker)) pos--;
    } else {
      pos = br.pos;
    }
    return E_OK;
  }

  int parse_sos(size_t seg, int len) {
    if (!frame) return E_NO_FRAME;
    if (len < 1) return E_CORRUPT;
    ns = d[seg];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return E_CORRUPT;
    for (int i = 0; i < ns; i++) {
      int cid = d[seg + 1 + 2 * i];
      int tab = d[seg + 2 + 2 * i];
      int found = -1;
      for (size_t j = 0; j < comps.size(); j++)
        if (comps[j].id == cid) found = (int)j;
      if (found < 0) return E_CORRUPT;
      sc[i] = &comps[found];
      scomp_idx[i] = found;
      td[i] = (tab >> 4) & 3;
      ta[i] = tab & 3;
    }
    Ss = d[seg + 1 + 2 * ns];
    Se = d[seg + 2 + 2 * ns];
    Ah = d[seg + 3 + 2 * ns] >> 4;
    Al = d[seg + 3 + 2 * ns] & 15;
    if (!progressive) {
      Ss = 0;
      Se = 63;
      Ah = Al = 0;
    } else {
      if (Ss > Se || Se > 63 || (Ss == 0 && Se != 0) || (Ss > 0 && ns != 1) || Al > 13)
        return E_CORRUPT;
    }
    return E_OK;
  }

  int run() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return E_NOT_JPEG;
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0 || m == 0xD9) break;
      if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (pos + 2 > n) break;
      int len = read_u16(pos);
      if (len < 2) return E_CORRUPT;
      size_t seg = pos + 2;
      int body = len - 2;
      if (seg + body > n) {
        if (m == 0xDA || !frame) return frame ? E_OK : E_NO_FRAME;
        break;
      }
      pos = seg + body;
      int e = E_OK;
      if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        if (frame) return E_CORRUPT;
        e = parse_sof(m, seg, body);
      } else if (m == 0xCC) {
        return E_ARITH;
      } else if (m == 0xDB) {
        e = parse_dqt(seg, body);
      } else if (m == 0xC4) {
        e = parse_dht(seg, body);
      } else if (m == 0xDD) {
        if (body >= 2) restart_interval = read_u16(seg);
      } else if (m >= 0xE0 && m <= 0xEF) {
        parse_app(m, seg, body);
      } else if (m == 0xDA) {
        e = parse_sos(seg, body);
        if (e == E_OK) e = decode_scan();
        if (e == E_OK && done) break;
      }
      if (e != E_OK) return e;
    }
    return frame ? E_OK : E_NO_FRAME;
  }

  // ---- output -------------------------------------------------------------
  // libjpeg-turbo's islow IDCT as its x86 SIMD code computes it (what
  // OpenCV's libjpeg-turbo runs): the dequantized terms and the sums
  // z3, z4 and in0 +- in4 of each pass in 16-bit lanes that wrap, each
  // pass's output saturated to 16 bits, the pixels to [-128, 127] + 128,
  // and a block whose rows 1-7 are zero taken as (in0 << 2) in 16 bits.
  // On coefficients that stay in range (every well-formed file) this is
  // the C code's arithmetic; garbage coefficients in a cut scan differ.
  void idct_plane(Comp& c, std::vector<uint8_t>& plane, int pw) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    for (int by = 0; by < c.hblocks; by++)
      for (int bx = 0; bx < c.wblocks; bx++) {
        const int16_t* in = c.block(bx, by);
        int ws[64];
        bool dc_rows = true;
        for (int k = 8; k < 64 && dc_rows; k++) dc_rows = in[k] == 0;
        for (int col = 0; col < 8; col++) {
          const int16_t* ip = in + col;
          const uint16_t* q = c.quant + col;
          int* w = ws + col;
          auto dq = [&](int k) { return (int64_t)(int16_t)((int)ip[8 * k] * (int)q[8 * k]); };
          if (dc_rows) {
            int v = (int16_t)(dq(0) * 4);
            for (int r = 0; r < 8; r++) w[8 * r] = v;
            continue;
          }
          int64_t z2 = dq(2), z3 = dq(6);
          int64_t z1 = (z2 + z3) * F0541;
          int64_t tmp2 = z1 + z3 * (-F1847);
          int64_t tmp3 = z1 + z2 * F0765;
          z2 = dq(0);
          z3 = dq(4);
          int64_t tmp0 = (int64_t)(int16_t)(z2 + z3) * 8192;
          int64_t tmp1 = (int64_t)(int16_t)(z2 - z3) * 8192;
          int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
          tmp0 = dq(7);
          tmp1 = dq(5);
          tmp2 = dq(3);
          tmp3 = dq(1);
          z1 = tmp0 + tmp3;
          z2 = tmp1 + tmp2;
          z3 = (int16_t)(tmp0 + tmp2);
          int64_t z4 = (int16_t)(tmp1 + tmp3);
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
          const int sh = 11;
          const int64_t rnd = 1 << 10;
          auto sat = [](int64_t x) { return (int)(x < -32768 ? -32768 : x > 32767 ? 32767 : x); };
          w[8 * 0] = sat((tmp10 + tmp3 + rnd) >> sh);
          w[8 * 7] = sat((tmp10 - tmp3 + rnd) >> sh);
          w[8 * 1] = sat((tmp11 + tmp2 + rnd) >> sh);
          w[8 * 6] = sat((tmp11 - tmp2 + rnd) >> sh);
          w[8 * 2] = sat((tmp12 + tmp1 + rnd) >> sh);
          w[8 * 5] = sat((tmp12 - tmp1 + rnd) >> sh);
          w[8 * 3] = sat((tmp13 + tmp0 + rnd) >> sh);
          w[8 * 4] = sat((tmp13 - tmp0 + rnd) >> sh);
        }
        for (int row = 0; row < 8; row++) {
          const int* w = ws + 8 * row;
          uint8_t* out = plane.data() + (size_t)(by * 8 + row) * pw + bx * 8;
          int64_t z2 = w[2], z3 = w[6];
          int64_t z1 = (z2 + z3) * F0541;
          int64_t tmp2 = z1 + z3 * (-F1847);
          int64_t tmp3 = z1 + z2 * F0765;
          int64_t tmp0 = (int64_t)(int16_t)(w[0] + w[4]) * 8192;
          int64_t tmp1 = (int64_t)(int16_t)(w[0] - w[4]) * 8192;
          int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
          tmp0 = w[7];
          tmp1 = w[5];
          tmp2 = w[3];
          tmp3 = w[1];
          z1 = tmp0 + tmp3;
          z2 = tmp1 + tmp2;
          z3 = (int16_t)(tmp0 + tmp2);
          int64_t z4 = (int16_t)(tmp1 + tmp3);
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
          const int sh = 18;
          const int64_t rnd = 1 << 17;
          auto put = [&](int64_t x) {
            int64_t v = (x + rnd) >> sh;
            return (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
          };
          out[0] = put(tmp10 + tmp3);
          out[7] = put(tmp10 - tmp3);
          out[1] = put(tmp11 + tmp2);
          out[6] = put(tmp11 - tmp2);
          out[2] = put(tmp12 + tmp1);
          out[5] = put(tmp12 - tmp1);
          out[3] = put(tmp13 + tmp0);
          out[4] = put(tmp13 - tmp0);
        }
      }
  }

  // libjpeg's interblock smoothing of a progressive image whose scans did
  // not all arrive (decompress_smooth_data, libjpeg-turbo 2.1 on): true if
  // any component still lacks bits of coefficients 1-9 and every component
  // has its DC.
  bool smoothing_ok() {
    if (!progressive) return false;
    bool useful = false;
    for (Comp& c : comps) {
      static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
      for (int k = 0; k < 10; k++)
        if (c.quant[kPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // The coefficients of c with libjpeg's estimates of the missing low AC
  // terms (and, with no AC data at all, of the DC) from the DC of the 5 x 5
  // neighbouring blocks, each estimate only where the coefficient is still 0.
  std::vector<int16_t> smoothed(Comp& c) {
    std::vector<int16_t> out = c.coef;
    int total = mcuy;
    int last_col = c.wblocks - 1;
    for (int r = 0; r < total; r++) {
      // rows the latest scan reached: its bits; later rows: those before it
      int prev_latch[10];
      const int* bits = c.coef_bits;
      if (r > last_good_row) {
        for (int k = 1; k < 10; k++) prev_latch[k] = scans > 1 ? c.prev_bits[k] : -1;
        prev_latch[0] = c.coef_bits[0];
        bits = prev_latch;
      }
      bool change_dc = true;
      for (int k = 1; k < 10; k++)
        if (bits[k] != -1) change_dc = false;
      const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16],
                    Q11 = c.quant[9], Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10],
                    Q21 = c.quant[17], Q30 = c.quant[24];
      int block_rows = c.v;
      if (r == total - 1) {
        block_rows = c.hblocks % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      int image_block_rows = block_rows * total;
      for (int br = 0; br < block_rows; br++) {
        int g = r * c.v + br;
        if (g >= c.hblocks) break;
        int ibr = r * block_rows + br;
        int prev = ibr > 0 ? g - 1 : g;
        int prev2 = ibr > 1 ? g - 2 : prev;
        int next = ibr < image_block_rows - 1 ? g + 1 : g;
        int next2 = ibr < image_block_rows - 2 ? g + 2 : next;
        auto dcat = [&](int row, int col) -> int { return c.block(col, row)[0]; };
        int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13,
            DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
        DC01 = DC02 = DC03 = DC04 = DC05 = dcat(prev2, 0);
        DC06 = DC07 = DC08 = DC09 = DC10 = dcat(prev, 0);
        DC11 = DC12 = DC13 = DC14 = DC15 = dcat(g, 0);
        DC16 = DC17 = DC18 = DC19 = DC20 = dcat(next, 0);
        DC21 = DC22 = DC23 = DC24 = DC25 = dcat(next2, 0);
        for (int col = 0; col <= last_col; col++) {
          if (col == 0 && col < last_col) {
            DC04 = DC05 = dcat(prev2, 1);
            DC09 = DC10 = dcat(prev, 1);
            DC14 = DC15 = dcat(g, 1);
            DC19 = DC20 = dcat(next, 1);
            DC24 = DC25 = dcat(next2, 1);
          }
          if (col + 1 < last_col) {
            DC05 = dcat(prev2, col + 2);
            DC10 = dcat(prev, col + 2);
            DC15 = dcat(g, col + 2);
            DC20 = dcat(next, col + 2);
            DC25 = dcat(next2, col + 2);
          }
          int16_t* ws = &out[((size_t)g * c.bw + col) * 64];
          auto estimate = [&](int k, int pos, int64_t q, int64_t num) {
            int Al = bits[k];
            if (Al == 0 || ws[pos] != 0) return;
            int pred;
            if (num >= 0) {
              pred = (int)(((q << 7) + num) / (q << 8));
              if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
            } else {
              pred = (int)(((q << 7) - num) / (q << 8));
              if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
              pred = -pred;
            }
            ws[pos] = (int16_t)pred;
          };
          estimate(1, 1, Q01, Q00 * (change_dc
              ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
              : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)));
          estimate(2, 8, Q10, Q00 * (change_dc
              ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
                 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
              : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)));
          estimate(3, 16, Q20, Q00 * (change_dc
              ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
              : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)));
          estimate(4, 9, Q11, Q00 * (change_dc
              ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
              : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                 DC06 + 10 * DC07 - 10 * DC09)));
          estimate(5, 2, Q02, Q00 * (change_dc
              ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                 DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
              : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)));
          if (change_dc) {
            estimate(6, 3, Q03, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
            estimate(7, 10, Q12, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
            estimate(8, 17, Q21, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
            estimate(9, 24, Q30, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
            int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                                 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                                 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            int pred = num >= 0 ? (int)(((Q00 << 7) + num) / (Q00 << 8))
                                : -(int)(((Q00 << 7) - num) / (Q00 << 8));
            ws[0] = (int16_t)pred;
          }
          DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
          DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
          DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
          DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
          DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
        }
      }
    }
    return out;
  }

  // The component upsampled to (height, >= width), libjpeg's methods.
  void upsample(Comp& c, const std::vector<uint8_t>& pl, int pw, std::vector<uint8_t>& out,
                int ow) {
    int he = hmax / c.h, ve = vmax / c.v;
    int dsw = c.dsw, dsh = c.dsh;
    auto at = [&](int y, int x) -> int {
      if (y < 0) y = 0;
      if (y > dsh - 1) y = dsh - 1;
      return pl[(size_t)y * pw + x];
    };
    if (he == 1 && ve == 1) {
      for (int y = 0; y < height; y++) std::memcpy(&out[(size_t)y * ow], &pl[(size_t)y * pw], width);
      return;
    }
    bool fancy_h2 = dsw > 2;
    if (he == 2 && ve == 1 && fancy_h2) {
      for (int y = 0; y < height; y++) {
        uint8_t* o = &out[(size_t)y * ow];
        const uint8_t* in = &pl[(size_t)y * pw];
        int inv = in[0];
        o[0] = (uint8_t)inv;
        o[1] = (uint8_t)((inv * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < dsw - 1; i++) {
          int v3 = in[i] * 3;
          o[2 * i] = (uint8_t)((v3 + in[i - 1] + 1) >> 2);
          o[2 * i + 1] = (uint8_t)((v3 + in[i + 1] + 2) >> 2);
        }
        int last = in[dsw - 1];
        o[2 * dsw - 2] = (uint8_t)((last * 3 + in[dsw - 2] + 1) >> 2);
        o[2 * dsw - 1] = (uint8_t)last;
      }
      return;
    }
    if (he == 1 && ve == 2) {
      for (int y = 0; y < height; y++) {
        int r = y >> 1, v = y & 1;
        int r1 = v == 0 ? r - 1 : r + 1;
        int bias = v == 0 ? 1 : 2;
        uint8_t* o = &out[(size_t)y * ow];
        for (int x = 0; x < dsw; x++) o[x] = (uint8_t)((at(r, x) * 3 + at(r1, x) + bias) >> 2);
      }
      return;
    }
    if (he == 2 && ve == 2 && fancy_h2) {
      std::vector<int> sums(dsw);
      for (int y = 0; y < height; y++) {
        int r = y >> 1, v = y & 1;
        int r1 = v == 0 ? r - 1 : r + 1;
        for (int x = 0; x < dsw; x++) sums[x] = at(r, x) * 3 + at(r1, x);
        uint8_t* o = &out[(size_t)y * ow];
        o[0] = (uint8_t)((sums[0] * 4 + 8) >> 4);
        o[1] = (uint8_t)((sums[0] * 3 + sums[1] + 7) >> 4);
        for (int i = 1; i < dsw - 1; i++) {
          o[2 * i] = (uint8_t)((sums[i] * 3 + sums[i - 1] + 8) >> 4);
          o[2 * i + 1] = (uint8_t)((sums[i] * 3 + sums[i + 1] + 7) >> 4);
        }
        o[2 * dsw - 2] = (uint8_t)((sums[dsw - 1] * 3 + sums[dsw - 2] + 8) >> 4);
        o[2 * dsw - 1] = (uint8_t)((sums[dsw - 1] * 4 + 7) >> 4);
      }
      return;
    }
    // replication (int_upsample, and the 2h methods at a width of 1 or 2)
    for (int y = 0; y < height; y++) {
      uint8_t* o = &out[(size_t)y * ow];
      int r = y / ve;
      for (int x = 0; x < dsw * he; x++) o[x] = (uint8_t)at(r, x / he);
    }
  }

  int output(uint8_t* rgb) {
    int nc = (int)comps.size();
    for (Comp& c : comps)
      if (!c.quant_latched) {
        // a component no scan reached: libjpeg outputs its zero blocks
        if (!qt_present[c.tq]) return E_CORRUPT;
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.quant_latched = true;
      }
    int ow = 0;
    for (Comp& c : comps) {
      int w = c.dsw * (hmax / c.h);
      if (w > ow) ow = w;
    }
    if (ow < width) ow = width;
    std::vector<std::vector<uint8_t>> up(nc);
    bool smooth = smoothing_ok();
    for (int i = 0; i < nc; i++) {
      Comp& c = comps[i];
      if (smooth) c.coef = smoothed(c);
      int pw = c.wblocks * 8;
      std::vector<uint8_t> plane((size_t)pw * c.hblocks * 8);
      idct_plane(c, plane, pw);
      up[i].assign((size_t)ow * height, 0);
      upsample(c, plane, pw, up[i], ow);
    }
    size_t npix = (size_t)width * height;
    if (nc == 1) {
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++) {
          uint8_t g = up[0][(size_t)y * ow + x];
          uint8_t* o = rgb + ((size_t)y * width + x) * 3;
          o[0] = o[1] = o[2] = g;
        }
      return E_OK;
    }
    bool is_rgb;
    if (jfif)
      is_rgb = false;
    else if (adobe)
      is_rgb = adobe_transform == 0;
    else
      is_rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
    if (is_rgb) {
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++) {
          uint8_t* o = rgb + ((size_t)y * width + x) * 3;
          size_t k = (size_t)y * ow + x;
          o[0] = up[0][k];
          o[1] = up[1][k];
          o[2] = up[2][k];
        }
      return E_OK;
    }
    static int cr_r[256], cb_b[256];
    static int64_t cr_g[256], cb_g[256];
    static bool ready = false;
    if (!ready) {
      const int64_t one_half = (int64_t)1 << 15;
      auto fix = [](double x) { return (int64_t)(x * 65536 + 0.5); };
      for (int i = 0, x = -128; i < 256; i++, x++) {
        cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
        cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + one_half;
      }
      ready = true;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < height; y++)
      for (int x = 0; x < width; x++) {
        size_t k = (size_t)y * ow + x;
        int yy = up[0][k], cb = up[1][k], cr = up[2][k];
        uint8_t* o = rgb + ((size_t)y * width + x) * 3;
        o[0] = clamp(yy + cr_r[cr]);
        o[1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        o[2] = clamp(yy + cb_b[cb]);
      }
    (void)npix;
    return E_OK;
  }
};

// --------------------------------------------------------------------------
// encoder
// --------------------------------------------------------------------------

const uint8_t kStdLuma[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
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

struct HuffEnc {
  uint32_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, p++) {
        code[vals[p]] = c++;
        size[vals[p]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;
  void byte(int b) { out.push_back((uint8_t)b); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 255);
  }
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      int b = (int)((acc >> nbits) & 255);
      byte(b);
      if (b == 0xFF) byte(0);
    }
  }
  void flush() {
    if (nbits) {
      int b = (int)(((acc << (8 - nbits)) | (0xFF >> nbits)) & 255);
      byte(b);
      if (b == 0xFF) byte(0);
      nbits = 0;
    }
    acc = 0;
  }
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

void fdct_islow(int* data) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return (int)((x + ((int64_t)1 << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; pass++) {
    for (int i = 0; i < 8; i++) {
      int* p = pass == 0 ? data + 8 * i : data + i;
      int st = pass == 0 ? 1 : 8;
      int64_t tmp0 = p[0] + p[7 * st], tmp7 = p[0] - p[7 * st];
      int64_t tmp1 = p[st] + p[6 * st], tmp6 = p[st] - p[6 * st];
      int64_t tmp2 = p[2 * st] + p[5 * st], tmp5 = p[2 * st] - p[5 * st];
      int64_t tmp3 = p[3 * st] + p[4 * st], tmp4 = p[3 * st] - p[4 * st];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int sh_even = pass == 0 ? 0 : 2;  // PASS1_BITS
      int sh_odd = pass == 0 ? 11 : 15;  // CONST_BITS -/+ PASS1_BITS
      if (pass == 0) {
        p[0] = (int)((tmp10 + tmp11) * 4);
        p[4 * st] = (int)((tmp10 - tmp11) * 4);
      } else {
        p[0] = descale(tmp10 + tmp11, sh_even);
        p[4 * st] = descale(tmp10 - tmp11, sh_even);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * st] = descale(z1 + tmp13 * F0765, sh_odd);
      p[6 * st] = descale(z1 + tmp12 * (-F1847), sh_odd);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
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
      p[7 * st] = descale(tmp4 + z1 + z3, sh_odd);
      p[5 * st] = descale(tmp5 + z2 + z4, sh_odd);
      p[3 * st] = descale(tmp6 + z2 + z3, sh_odd);
      p[st] = descale(tmp7 + z1 + z4, sh_odd);
    }
  }
}

struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift
};

// libjpeg-turbo's compute_reciprocal for a 16-bit DCTELEM
Divisor reciprocal(uint32_t divisor) {
  Divisor dv;
  int b = 0;
  while ((1u << (b + 1)) <= divisor) b++;  // floor(log2)
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  dv.recip = fq;
  dv.corr = c;
  dv.shift = r;
  return dv;
}

void quant_table(const uint8_t* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = ((long)basic[i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 32767) t = 32767;
    if (t > 255) t = 255;  // force_baseline
    out[i] = (uint16_t)t;
  }
}

struct Encoder {
  int w, h, nc, quality;
  Writer wr;
  uint16_t q[2][64];
  Divisor div[2][64];
  HuffEnc dch[2], ach[2];

  void marker_segments() {
    wr.byte(0xFF);
    wr.byte(0xD8);
    // JFIF APP0: version 1.01, no units, density 1:1, no thumbnail
    const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01,
                            0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    for (uint8_t b : app0) wr.byte(b);
    int ntab = nc == 3 ? 2 : 1;
    for (int t = 0; t < ntab; t++) {
      wr.byte(0xFF);
      wr.byte(0xDB);
      wr.u16(67);
      wr.byte(t);
      for (int i = 0; i < 64; i++) wr.byte(q[t][kNatural[i]]);
    }
    wr.byte(0xFF);
    wr.byte(0xC0);
    wr.u16(8 + 3 * nc);
    wr.byte(8);
    wr.u16(h);
    wr.u16(w);
    wr.byte(nc);
    if (nc == 3) {
      wr.byte(1), wr.byte(0x22), wr.byte(0);
      wr.byte(2), wr.byte(0x11), wr.byte(1);
      wr.byte(3), wr.byte(0x11), wr.byte(1);
    } else {
      wr.byte(1), wr.byte(0x11), wr.byte(0);
    }
    for (int t = 0; t < ntab; t++) {
      const uint8_t* bits[2] = {t ? kDcChromaBits : kDcLumaBits, t ? kAcChromaBits : kAcLumaBits};
      const uint8_t* vals[2] = {kDcVals, t ? kAcChromaVals : kAcLumaVals};
      for (int k = 0; k < 2; k++) {
        int total = 0;
        for (int i = 0; i < 16; i++) total += bits[k][i];
        wr.byte(0xFF);
        wr.byte(0xC4);
        wr.u16(2 + 17 + total);
        wr.byte((k << 4) | t);
        for (int i = 0; i < 16; i++) wr.byte(bits[k][i]);
        for (int i = 0; i < total; i++) wr.byte(vals[k][i]);
      }
    }
    wr.byte(0xFF);
    wr.byte(0xDA);
    wr.u16(6 + 2 * nc);
    wr.byte(nc);
    if (nc == 3) {
      wr.byte(1), wr.byte(0x00);
      wr.byte(2), wr.byte(0x11);
      wr.byte(3), wr.byte(0x11);
    } else {
      wr.byte(1), wr.byte(0x00);
    }
    wr.byte(0);
    wr.byte(63);
    wr.byte(0);
  }

  // Forward DCT and quantization of the 8x8 block at (x0, y0) of a padded plane.
  void block(const uint8_t* plane, int pw, int x0, int y0, int t, int16_t* out) {
    int data[64];
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) data[8 * y + x] = (int)plane[(size_t)(y0 + y) * pw + x0 + x] - 128;
    fdct_islow(data);
    for (int i = 0; i < 64; i++) {
      const Divisor& dv = div[t][i];
      int v = data[i];
      uint32_t a = (uint32_t)(v < 0 ? -v : v);
      uint32_t qv = (uint32_t)(((uint64_t)(a + dv.corr) * dv.recip) >> dv.shift);
      out[i] = (int16_t)(v < 0 ? -(int)qv : (int)qv);
    }
  }

  void encode_block(const int16_t* blk, int& last_dc, int t) {
    int temp = blk[0] - last_dc;
    last_dc = blk[0];
    int a = temp < 0 ? -temp : temp;
    int nb = nbits_of(a);
    wr.put(dch[t].code[nb], dch[t].size[nb]);
    if (nb) wr.put((uint32_t)(temp < 0 ? temp - 1 : temp), nb);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      int v = blk[kNatural[k]];
      if (v == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        wr.put(ach[t].code[0xF0], ach[t].size[0xF0]);
        r -= 16;
      }
      a = v < 0 ? -v : v;
      nb = nbits_of(a);
      int sym = (r << 4) + nb;
      wr.put(ach[t].code[sym], ach[t].size[sym]);
      wr.put((uint32_t)(v < 0 ? v - 1 : v), nb);
      r = 0;
    }
    if (r > 0) wr.put(ach[t].code[0], ach[t].size[0]);
  }

  int run(const uint8_t* img) {
    quant_table(kStdLuma, quality, q[0]);
    quant_table(kStdChroma, quality, q[1]);
    for (int t = 0; t < 2; t++)
      for (int i = 0; i < 64; i++) div[t][i] = reciprocal((uint32_t)q[t][i] << 3);
    dch[0].build(kDcLumaBits, kDcVals);
    dch[1].build(kDcChromaBits, kDcVals);
    ach[0].build(kAcLumaBits, kAcLumaVals);
    ach[1].build(kAcChromaBits, kAcChromaVals);
    marker_segments();
    if (nc == 1) {
      int wb = (w + 7) / 8, hb = (h + 7) / 8;
      int pw = wb * 8, ph = hb * 8;
      std::vector<uint8_t> plane((size_t)pw * ph);
      for (int y = 0; y < ph; y++) {
        const uint8_t* src = img + (size_t)(y < h ? y : h - 1) * w;
        uint8_t* dst = &plane[(size_t)y * pw];
        std::memcpy(dst, src, w);
        for (int x = w; x < pw; x++) dst[x] = src[w - 1];
      }
      int last = 0;
      int16_t blk[64];
      for (int by = 0; by < hb; by++)
        for (int bx = 0; bx < wb; bx++) {
          block(plane.data(), pw, bx * 8, by * 8, 0, blk);
          encode_block(blk, last, 0);
        }
    } else {
      // RGB -> YCbCr, libjpeg's tables
      static int64_t tab[8 * 256];
      static bool ready = false;
      if (!ready) {
        auto fix = [](double x) { return (int64_t)(x * 65536 + 0.5); };
        const int64_t half = (int64_t)1 << 15, cbcr_off = (int64_t)128 << 16;
        for (int i = 0; i < 256; i++) {
          tab[i + 0 * 256] = fix(0.29900) * i;
          tab[i + 1 * 256] = fix(0.58700) * i;
          tab[i + 2 * 256] = fix(0.11400) * i + half;
          tab[i + 3 * 256] = -fix(0.16874) * i;
          tab[i + 4 * 256] = -fix(0.33126) * i;
          tab[i + 5 * 256] = fix(0.50000) * i + cbcr_off + half - 1;
          tab[i + 6 * 256] = -fix(0.41869) * i;
          tab[i + 7 * 256] = -fix(0.08131) * i;
        }
        ready = true;
      }
      int mx = (w + 15) / 16, my = (h + 15) / 16;
      int ywb = (w + 7) / 8, yhb = (h + 7) / 8;
      int ypw = mx * 16, yph = my * 16;
      int cpw = mx * 8, cph = my * 8;
      // full-size planes padded right to 16 * mx by the last column and down
      // to an even row count by the last row (libjpeg's edge expansion)
      int hp = (h + 1) & ~1;
      std::vector<uint8_t> Y((size_t)ypw * yph), Cb((size_t)ypw * hp), Cr((size_t)ypw * hp);
      for (int y = 0; y < hp; y++) {
        const uint8_t* src = img + (size_t)(y < h ? y : h - 1) * w * 3;
        for (int x = 0; x < w; x++) {
          int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
          size_t k = (size_t)y * ypw + x;
          Y[k] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
          Cb[k] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
          Cr[k] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
        }
        for (int x = w; x < ypw; x++) {
          size_t k = (size_t)y * ypw;
          Y[k + x] = Y[k + w - 1];
          Cb[k + x] = Cb[k + w - 1];
          Cr[k + x] = Cr[k + w - 1];
        }
      }
      for (int y = hp; y < yph; y++) std::memcpy(&Y[(size_t)y * ypw], &Y[(size_t)(hp - 1) * ypw], ypw);
      // 2x2 averaging with the alternating bias 1, 2, 1, 2, ...
      std::vector<uint8_t> Cbd((size_t)cpw * cph), Crd((size_t)cpw * cph);
      int dsh = hp / 2;
      for (int y = 0; y < cph; y++) {
        int yy = y < dsh ? y : dsh - 1;
        for (int x = 0; x < cpw; x++) {
          int bias = (x & 1) ? 2 : 1;
          size_t a0 = (size_t)(2 * yy) * ypw + 2 * x, a1 = a0 + ypw;
          Cbd[(size_t)y * cpw + x] = (uint8_t)((Cb[a0] + Cb[a0 + 1] + Cb[a1] + Cb[a1 + 1] + bias) >> 2);
          Crd[(size_t)y * cpw + x] = (uint8_t)((Cr[a0] + Cr[a0 + 1] + Cr[a1] + Cr[a1 + 1] + bias) >> 2);
        }
      }
      int last[3] = {0, 0, 0};
      int16_t blk[4][64], cb[64], cr[64];
      for (int m_y = 0; m_y < my; m_y++)
        for (int m_x = 0; m_x < mx; m_x++) {
          // luma: real blocks, then dummy blocks (zero AC, DC of a neighbour)
          for (int yy = 0; yy < 2; yy++) {
            int by = m_y * 2 + yy;
            for (int xx = 0; xx < 2; xx++) {
              int bx = m_x * 2 + xx;
              int16_t* b = blk[yy * 2 + xx];
              if (by < yhb && bx < ywb) {
                block(Y.data(), ypw, bx * 8, by * 8, 0, b);
              } else {
                std::memset(b, 0, 64 * sizeof(int16_t));
                b[0] = by < yhb ? blk[yy * 2 + xx - 1][0] : blk[yy * 2 - 1][0];
              }
            }
          }
          for (int k = 0; k < 4; k++) encode_block(blk[k], last[0], 0);
          block(Cbd.data(), cpw, m_x * 8, m_y * 8, 1, cb);
          encode_block(cb, last[1], 1);
          block(Crd.data(), cpw, m_x * 8, m_y * 8, 1, cr);
          encode_block(cr, last[2], 1);
        }
    }
    wr.flush();
    wr.byte(0xFF);
    wr.byte(0xD9);
    return 0;
  }
};

}  // namespace

extern "C" {

// (h, w, components) of a JPEG stream from its frame header; 0 or an error code.
int jpeg_info(const uint8_t* data, size_t n, int* h, int* w, int* nc) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return E_NOT_JPEG;
  dec.pos = 2;
  for (;;) {
    int m = dec.next_marker();
    if (m == 0 || m == 0xD9 || m == 0xDA) return E_NO_FRAME;
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (dec.pos + 2 > n) return E_NO_FRAME;
    int len = dec.read_u16(dec.pos);
    size_t seg = dec.pos + 2;
    if (len < 2 || seg + len - 2 > n) return E_NO_FRAME;
    dec.pos = seg + len - 2;
    if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      int e = dec.parse_sof(m, seg, len - 2);
      if (e != E_OK) return e;
      *h = dec.height;
      *w = dec.width;
      *nc = (int)dec.comps.size();
      return E_OK;
    }
  }
}

// Decodes a JPEG stream into out (h * w * 3 RGB); 0 or an error code.
int jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int h, int w) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  int e = dec.run();
  if (e != E_OK) return e;
  if (dec.height != h || dec.width != w) return E_CORRUPT;
  return dec.output(out);
}

// Encodes RGB (nc 3) or gray (nc 1) pixels; returns the size in bytes, or
// -(size needed) when cap is too small (nothing written then).
long jpeg_encode(const uint8_t* img, int h, int w, int nc, int quality, uint8_t* out, size_t cap) {
  Encoder enc;
  enc.w = w;
  enc.h = h;
  enc.nc = nc;
  enc.quality = quality;
  enc.run(img);
  size_t n = enc.wr.out.size();
  if (n > cap) return -(long)n;
  std::memcpy(out, enc.wr.out.data(), n);
  return (long)n;
}

}  // extern "C"
