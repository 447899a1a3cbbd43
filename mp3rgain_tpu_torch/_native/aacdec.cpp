// AAC-LC decode front-end: the host-side entropy + spectral-prep stage of
// the TPU AAC decoder (ISO/IEC 14496-3 AAC Low Complexity).
//
// Parses ADTS frames (SCE/CPE/LFE syntactic elements), decodes section
// data, scalefactors, pulses, TNS and spectral Huffman data, requantizes
// (x^4/3 * 2^((sf-100)/4)), resolves window grouping/interleaving, applies
// M/S + intensity stereo, PNS and TNS on host (a few % of total FLOPs),
// and emits natural-order spectra + window metadata for the device
// back-end (IMDCT + windowing + overlap-add + shared DSP kernels).
//
// This replaces the reference's external AAC decoder (symphonia-codec-aac;
// the reference uses it at src/replaygain.rs:804-904).

#include "native.h"
#include "aac_tables.h"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

// Stage-time attribution, enabled with MP3RGAIN_AAC_TIME=1 (stderr dump
// per mg_aac_unpack_adts call). Accumulators are process-global; the
// unpack entry point is called with the GIL released but from one
// thread per file, so contention only skews the diagnostic, not decode.
struct AacTiming {
  bool enabled = [] {
    const char* e = getenv("MP3RGAIN_AAC_TIME");
    return e && e[0] && e[0] != '0';
  }();
  double reset = 0, huff = 0, requant = 0, post = 0, emit = 0, total = 0;
  static double now() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  }
  void dump() {
    fprintf(stderr,
            "aac host stages: reset %.1f ms, huffman+parse %.1f ms, "
            "requant %.1f ms, pns/stereo/tns %.1f ms, emit %.1f ms, "
            "other %.1f ms (total %.1f ms)\n",
            reset * 1e3, huff * 1e3, requant * 1e3, post * 1e3, emit * 1e3,
            (total - reset - huff - requant - post - emit) * 1e3,
            total * 1e3);
    reset = huff = requant = post = emit = total = 0;
  }
};
AacTiming g_aac_timing;

// ---------------------------------------------------------------------------
// Bit reader
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t len;       // bytes
  size_t bit;       // current absolute bit position
  bool overrun = false;

  // Branch-light word-based reads (n <= 32).
  uint64_t load64(size_t byte) const {
    uint64_t w;
    __builtin_memcpy(&w, data + byte, 8);
    return __builtin_bswap64(w);
  }

  uint32_t get(int n) {
    const size_t byte = bit >> 3;
    if (byte + 8 <= len) {
      const uint64_t w = load64(byte) << (bit & 7);
      bit += n;
      return n ? static_cast<uint32_t>(w >> (64 - n)) : 0;
    }
    return get_slow(n);
  }

  uint32_t get_slow(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      const size_t byte = bit >> 3;
      if (byte >= len) {
        overrun = true;
        return v << (n - i);
      }
      v = (v << 1) | ((data[byte] >> (7 - (bit & 7))) & 1);
      ++bit;
    }
    return v;
  }

  uint32_t peek(int n) const {
    const size_t byte = bit >> 3;
    if (byte + 8 <= len) {
      const uint64_t w = load64(byte) << (bit & 7);
      return n ? static_cast<uint32_t>(w >> (64 - n)) : 0;
    }
    uint32_t v = 0;
    size_t b = bit;
    for (int i = 0; i < n; ++i) {
      const size_t byi = b >> 3;
      const uint32_t x = byi < len ? ((data[byi] >> (7 - (b & 7))) & 1) : 0;
      v = (v << 1) | x;
      ++b;
    }
    return v;
  }

  void skip(size_t n) { bit += n; }
};

// ---------------------------------------------------------------------------
// Huffman decode (slow tree-free: linear code match via per-length tables)
// ---------------------------------------------------------------------------

struct Vlc {
  // two-level LUT like the MP3 path: 10-bit primary.
  static constexpr int kL1 = 10;
  std::vector<uint16_t> l1;   // value | (len<<10) packed? store idx | len
  std::vector<uint32_t> l2;   // not needed: max aac code len 19 -> secondary
  std::vector<uint16_t> l2v;

  void build(const uint32_t* codes, const uint8_t* lens, int n) {
    l1.assign(1 << kL1, 0xFFFF);
    std::vector<int> sub(1 << kL1, -1);
    for (int i = 0; i < n; ++i) {
      const int len = lens[i];
      const uint32_t code = codes[i];
      if (len <= kL1) {
        const int shift = kL1 - len;
        for (uint32_t j = 0; j < (1u << shift); ++j) {
          l1[(code << shift) + j] = static_cast<uint16_t>(i | (len << 9));
        }
      } else {
        const uint32_t prefix = code >> (len - kL1);
        if (sub[prefix] < 0) {
          sub[prefix] = static_cast<int>(l2v.size()) >> 10;
          l1[prefix] = static_cast<uint16_t>(0x8000 | sub[prefix]);
          l2v.resize(l2v.size() + (1 << 10), 0xFFFF);
        }
        const int rem_len = len - kL1;  // <= 9 (max aac len 19)
        const uint32_t rem = code & ((1u << rem_len) - 1);
        const int shift = 10 - rem_len;
        const uint32_t base = (sub[prefix] << 10) + (rem << shift);
        for (uint32_t j = 0; j < (1u << shift); ++j) {
          l2v[base + j] = static_cast<uint16_t>(i | (rem_len << 9));
        }
      }
    }
  }

  // Decode one codeword from a preloaded left-aligned 64-bit window.
  // Returns entry index or -1; *len receives the full codeword length.
  // Lets the spectral hot loop fetch codeword + sign bits from ONE
  // 64-bit load instead of separate peek/get rounds.
  int decode_w(uint64_t w, int* len) const {
    uint16_t v = l1[w >> (64 - kL1)];
    if (v == 0xFFFF) return -1;
    if (v & 0x8000) {
      v = l2v[((v & 0x7FFF) << 10) +
              static_cast<uint32_t>((w >> (64 - kL1 - 10)) & 0x3FF)];
      if (v == 0xFFFF) return -1;
      *len = kL1 + ((v >> 9) & 0x3F);
    } else {
      *len = (v >> 9) & 0x3F;
    }
    return v & 0x1FF;
  }

  // Returns entry index or -1.
  int decode(BitReader* br) const {
    uint16_t v = l1[br->peek(kL1)];
    if (v == 0xFFFF) return -1;
    if (v & 0x8000) {
      br->skip(kL1);
      v = l2v[((v & 0x7FFF) << 10) + br->peek(10)];
      if (v == 0xFFFF) return -1;
    }
    br->skip((v >> 9) & 0x3F);
    return v & 0x1FF;
  }
};

struct VlcSet {
  Vlc sf;
  Vlc spec[11];
  // Precomputed tuple dequantization: codeword index -> up to 4
  // unquantized values. Replaces the per-tuple runtime div/mod chains
  // (division by a non-constant modulus is the hottest arithmetic in
  // the spectral loop) with one 4-byte load.
  int8_t vals[11][289][4] = {};
  // Sign-applied tuple LUT for the unsigned codebooks: nnz[idx] sign
  // bits (MSB = first nonzero, ISO 14496-3 spectral_data order) select
  // the fully-signed 4-value row directly — the per-element
  // sign-branch chain was the serial bottleneck of the spectral loop.
  // 289*16 rows * 4 B * 10 books ~ 185 KB, L2-resident.
  uint8_t nnz[11][289] = {};
  int8_t signed_vals[11][289 * 16][4] = {};

  VlcSet() {
    sf.build(kAacSfCode, kAacSfLen, 121);
    for (int b = 0; b < 11; ++b) {
      std::vector<uint32_t> codes(kAacSpecSize[b]);
      for (int i = 0; i < kAacSpecSize[b]; ++i) codes[i] = kAacSpecCodes[b][i];
      spec[b].build(codes.data(), kAacSpecLens[b], kAacSpecSize[b]);
      const int dim = kAacSpecDim[b];
      const bool uns = kAacSpecUnsigned[b];
      const int lav = kAacSpecLav[b];
      const int mod = uns ? (lav + 1) : (2 * lav + 1);
      for (int idx = 0; idx < kAacSpecSize[b]; ++idx) {
        int t = idx;
        if (dim == 4) {
          for (int d = 3; d >= 0; --d) {
            vals[b][idx][d] = static_cast<int8_t>(t % mod - (uns ? 0 : lav));
            t /= mod;
          }
        } else {
          vals[b][idx][0] = static_cast<int8_t>(t / mod - (uns ? 0 : lav));
          vals[b][idx][1] = static_cast<int8_t>(t % mod - (uns ? 0 : lav));
        }
        int n = 0;
        for (int d = 0; d < 4; ++d) n += vals[b][idx][d] != 0;
        nnz[b][idx] = static_cast<uint8_t>(uns ? n : 0);
        const int nsb = nnz[b][idx];
        for (int sb = 0; sb < (1 << nsb); ++sb) {
          int8_t* row = signed_vals[b][idx * 16 + sb];
          int k = nsb;
          for (int d = 0; d < 4; ++d) {
            int v = vals[b][idx][d];
            if (uns && v != 0) {
              if ((sb >> --k) & 1) v = -v;
            }
            row[d] = static_cast<int8_t>(v);
          }
        }
      }
    }
  }
};

const VlcSet& vlcs() {
  static const VlcSet v;
  return v;
}

// ---------------------------------------------------------------------------
// ICS structures
// ---------------------------------------------------------------------------

constexpr int ONLY_LONG = 0, LONG_START = 1, EIGHT_SHORT = 2, LONG_STOP = 3;

struct IcsInfo {
  int window_sequence = 0;
  int window_shape = 0;
  int max_sfb = 0;
  int num_windows = 1;
  int num_window_groups = 1;
  int group_len[8] = {1};
  int num_swb = 0;
  const uint16_t* swb_offset = nullptr;
  int swb_size = 0;  // 1024 or 128
  int tns_max_bands = 64;  // ISO 14496-3 table 4.139, per sr index
};

struct TnsFilter {
  int length = 0;
  int order = 0;
  int direction = 0;
  double coef[20] = {};
};

struct TnsData {
  int n_filt[8] = {};
  TnsFilter filt[8][3];
};

struct Channel {
  IcsInfo ics;
  int global_gain = 0;
  int dbg_flags = 0;  // 1=tns, 2=pns, 4=intensity, 8=esc, 16=pulse
  uint8_t band_cb[8][64] = {};   // codebook per group/sfb
  double sf[8][64] = {};         // linear scalefactor gain per group/sfb
  int sf_int[8][64] = {};        // raw scalefactor integers (device requant)
  int is_pos[8][64] = {};        // intensity positions
  double noise_nrg[8][64] = {};  // PNS energies (linear)
  int noise_int[8][64] = {};     // raw PNS energy integers (device requant)
  TnsData tns;
  bool tns_present = false;
  bool overflow = false;  // |quantized| > int16: force host requant
  int32_t qcoef[1024] = {};  // quantized coefficients, decode order
  float spec[1024] = {};  // requantized, natural window order

  // Per-frame reset of only the state parsing doesn't fully overwrite:
  // qcoef (bands outside the coded sections keep their zeros), the |=
  // flag fields, and tns_present/overflow (an early parse error must
  // not leak a stale true into the frame's routing). The per-band
  // tables (band_cb, sf*, noise*, is_pos) are rewritten for every band
  // any reader visits (k < max_sfb), and spec is zeroed lazily at the
  // top of requant_channel — a full Channel copy memset ~34 KB per
  // channel-frame and dominated the non-Huffman host time.
  void reset_for_frame() {
    memset(qcoef, 0, sizeof(qcoef));
    global_gain = 0;
    dbg_flags = 0;
    tns_present = false;
    overflow = false;
  }
};

constexpr int CB_ZERO = 0, CB_NOISE = 13, CB_IS_MINUS = 14, CB_IS_PLUS = 15;

// |q|^(4/3) with sign, via a table over the non-escape magnitude range
// (pow() per coefficient was the hottest host-side operation by far).
// Escape magnitudes (codebook 11, up to 2^16 + 2^16-1) take the pow path.
constexpr int kReq43Size = 8207;  // max LAV 8191 + max pulse amplitude 15

const float* req43_table() {
  // float table (32 KB, L1-resident): ~6e-8 relative rounding vs the
  // double form — two orders inside the decoder acceptance tolerances
  // (and libavcodec's own requant tables are float too).
  static const std::vector<float> table = [] {
    std::vector<float> t(kReq43Size);
    for (int i = 0; i < kReq43Size; ++i)
      t[i] = static_cast<float>(pow(double(i), 4.0 / 3.0));
    return t;
  }();
  return table.data();
}

inline float requant43(int32_t x) {
  const int32_t a = x < 0 ? -x : x;
  const float m = a < kReq43Size
                      ? req43_table()[a]
                      : static_cast<float>(pow(double(a), 4.0 / 3.0));
  return x < 0 ? -m : m;
}

bool parse_ics_info(BitReader* br, int sr_index, IcsInfo* ics) {
  br->skip(1);  // ics_reserved_bit
  ics->window_sequence = br->get(2);
  ics->window_shape = br->get(1);
  if (ics->window_sequence == EIGHT_SHORT) {
    ics->max_sfb = br->get(4);
    const uint32_t grouping = br->get(7);
    ics->num_windows = 8;
    ics->num_window_groups = 1;
    ics->group_len[0] = 1;
    for (int i = 0; i < 7; ++i) {
      if (grouping & (1u << (6 - i))) {
        ics->group_len[ics->num_window_groups - 1]++;
      } else {
        ics->group_len[ics->num_window_groups] = 1;
        ics->num_window_groups++;
      }
    }
    ics->num_swb = kNumSwbShort[sr_index];
    ics->swb_offset = kSwbShort[sr_index];
    ics->swb_size = 128;
    ics->tns_max_bands = kAacTnsMaxBandsShort[sr_index];
  } else {
    ics->max_sfb = br->get(6);
    ics->num_windows = 1;
    ics->num_window_groups = 1;
    ics->group_len[0] = 1;
    ics->num_swb = kNumSwbLong[sr_index];
    ics->swb_offset = kSwbLong[sr_index];
    ics->swb_size = 1024;
    ics->tns_max_bands = kAacTnsMaxBandsLong[sr_index];
    if (br->get(1)) return false;  // predictor_data_present: not LC
  }
  return ics->max_sfb <= ics->num_swb;
}

bool parse_section_data(BitReader* br, Channel* ch) {
  const IcsInfo& ics = ch->ics;
  const int bits = ics.window_sequence == EIGHT_SHORT ? 3 : 5;
  const int esc = (1 << bits) - 1;
  for (int g = 0; g < ics.num_window_groups; ++g) {
    int k = 0;
    while (k < ics.max_sfb) {
      const int cb = br->get(4);
      int len = 0, inc;
      do {
        inc = br->get(bits);
        len += inc;
      } while (inc == esc && !br->overrun);
      if (br->overrun || k + len > ics.max_sfb) return false;
      for (int i = 0; i < len; ++i) ch->band_cb[g][k + i] = cb;
      k += len;
    }
  }
  return true;
}

bool parse_scale_factor_data(BitReader* br, Channel* ch) {
  const IcsInfo& ics = ch->ics;
  int sf = ch->global_gain;
  int is_position = 0;
  int noise_nrg = ch->global_gain - 90;
  bool noise_first = true;
  for (int g = 0; g < ics.num_window_groups; ++g) {
    for (int k = 0; k < ics.max_sfb; ++k) {
      const int cb = ch->band_cb[g][k];
      if (cb == CB_ZERO) continue;
      if (cb == CB_NOISE) ch->dbg_flags |= 2;
      if (cb == CB_IS_MINUS || cb == CB_IS_PLUS) ch->dbg_flags |= 4;
      if (cb == CB_IS_MINUS || cb == CB_IS_PLUS) {
        const int idx = vlcs().sf.decode(br);
        if (idx < 0) return false;
        is_position += idx - 60;
        ch->is_pos[g][k] = is_position;
      } else if (cb == CB_NOISE) {
        if (noise_first) {
          noise_nrg += br->get(9) - 256;
          noise_first = false;
        } else {
          const int idx = vlcs().sf.decode(br);
          if (idx < 0) return false;
          noise_nrg += idx - 60;
        }
        ch->noise_nrg[g][k] = pow(2.0, 0.25 * (noise_nrg - 100) - 15.0);
        ch->noise_int[g][k] = noise_nrg;
      } else {
        const int idx = vlcs().sf.decode(br);
        if (idx < 0) return false;
        sf += idx - 60;
        if (sf < 0 || sf > 255) return false;
        // 2^-15: normalized float output convention (int16 full scale
        // maps to 1.0), matching the reference decoder's float path.
        // sf is range-checked to 0..255, so the gain comes from a
        // once-built table (a pow() per coded band was ~5% of the
        // host front-end).
        static const double* kSfGain = [] {
          static double t[256];
          for (int s = 0; s < 256; ++s)
            t[s] = pow(2.0, 0.25 * (s - 100) - 15.0);
          return t;
        }();
        ch->sf[g][k] = kSfGain[sf];
        ch->sf_int[g][k] = sf;
      }
    }
  }
  return true;
}

struct PulseData {
  int num = 0;
  int start_sfb = 0;
  int offset[4];
  int amp[4];
};

void parse_pulse_data(BitReader* br, PulseData* p) {
  p->num = br->get(2) + 1;
  p->start_sfb = br->get(6);
  for (int i = 0; i < p->num; ++i) {
    p->offset[i] = br->get(5);
    p->amp[i] = br->get(4);
  }
}

void parse_tns_data(BitReader* br, const IcsInfo& ics, TnsData* tns) {
  const bool short_win = ics.window_sequence == EIGHT_SHORT;
  const int n_filt_bits = short_win ? 1 : 2;
  const int len_bits = short_win ? 4 : 6;
  const int order_bits = short_win ? 3 : 5;
  for (int w = 0; w < ics.num_windows; ++w) {
    tns->n_filt[w] = br->get(n_filt_bits);
    if (tns->n_filt[w] == 0) continue;
    const int coef_res = br->get(1);
    for (int f = 0; f < tns->n_filt[w]; ++f) {
      TnsFilter& fl = tns->filt[w][f];
      fl.length = br->get(len_bits);
      fl.order = br->get(order_bits);
      if (fl.order > 20) {  // LC max order is 12; clamp corrupt streams
        fl.order = 0;
        return;
      }
      if (fl.order) {
        fl.direction = br->get(1);
        const int compress = br->get(1);
        const int coef_bits = coef_res + 3 - compress;
        // Inverse quantization (14496-3 tns): sin-based.
        const double iqfac = ((1 << (coef_res + 3 - 1)) - 0.5) / (M_PI / 2.0);
        const double iqfac_m = ((1 << (coef_res + 3 - 1)) + 0.5) / (M_PI / 2.0);
        double tmp[20];
        for (int i = 0; i < fl.order; ++i) {
          int v = br->get(coef_bits);
          // sign-extend
          if (v >= (1 << (coef_bits - 1))) v -= 1 << coef_bits;
          tmp[i] = sin(v / (v >= 0 ? iqfac : iqfac_m));
        }
        // Conversion to LPC coefficients (levinson-style recursion).
        double a[21] = {1.0};
        double b[21];
        for (int m = 1; m <= fl.order; ++m) {
          for (int i = 1; i < m; ++i) {
            b[i] = a[i] + tmp[m - 1] * a[m - i];
          }
          for (int i = 1; i < m; ++i) a[i] = b[i];
          a[m] = tmp[m - 1];
        }
        for (int i = 0; i < fl.order; ++i) fl.coef[i] = a[i + 1];
      }
    }
  }
}

// Spectral data for one channel: Huffman decode into ch->qcoef
// (quantized integers, decode/grouped order — for long windows decode
// order IS natural spectral order) plus pulse application. Requantize
// and the grouped->natural reorder live in requant_channel so the
// device-requant path (mg_aac_unpack_adts_q) can skip them.
bool parse_spectral_data(BitReader* br, Channel* ch, const PulseData* pulse) {
  const IcsInfo& ics = ch->ics;
  const VlcSet& v = vlcs();
  // coefficients in decode (grouped/interleaved) order
  const double t0 = g_aac_timing.enabled ? AacTiming::now() : 0;
  int32_t* coef = ch->qcoef;
  int group_offset = 0;

  for (int g = 0; g < ics.num_window_groups; ++g) {
    const int glen = ics.group_len[g];
    for (int k = 0; k < ics.max_sfb; ++k) {
      const int cb = ch->band_cb[g][k];
      const int band_start = ics.swb_offset[k];
      const int band_end = ics.swb_offset[k + 1];
      const int width = band_end - band_start;
      if (cb == CB_ZERO || cb == CB_NOISE || cb >= CB_IS_MINUS) continue;
      if (cb > 11) return false;
      const Vlc& vb = v.spec[cb - 1];
      const int dim = kAacSpecDim[cb - 1];
      const bool uns = kAacSpecUnsigned[cb - 1];
      const int total = width * glen;
      const int8_t (*dequant)[4] = v.vals[cb - 1];
      // Hoist the per-coefficient position math and bound check: the
      // band's stores are contiguous at base+i+d, and almost every
      // band fits entirely below 1024.
      const int base = group_offset + band_start * glen;
      const bool in_bounds = base >= 0 && base + total <= 1024;
      if (cb != 11 && in_bounds) {
        // Fast path for the non-escape books (the vast majority of
        // real content): keep the left-aligned bit window in a
        // register across tuples (codeword <= 19 bits + <= 4 sign
        // bits: one 8-byte load serves ~2 tuples) and apply sign bits
        // through the precomputed signed_vals LUT — one 4-byte row
        // load replaces the per-element sign-branch chain that
        // serialized the loop.
        const uint8_t* nnz_lut = v.nnz[cb - 1];
        const int8_t (*slut)[4] = v.signed_vals[cb - 1];
        size_t bit = br->bit;
        uint64_t w = 0;
        int avail = 0;
        int i = 0;
        for (; i < total; i += dim) {
          if (avail < 23) {
            const size_t byte = bit >> 3;
            if (byte + 8 > br->len) break;  // tail: per-tuple path
            w = br->load64(byte) << (bit & 7);
            avail = static_cast<int>(64 - (bit & 7));
          }
          int clen;
          const int idx = vb.decode_w(w, &clen);
          if (idx < 0) {
            br->bit = bit;
            return false;
          }
          const int nsb = nnz_lut[idx];
          // ((w<<clen)>>1)>>(63-nsb) extracts the top nsb bits with a
          // well-defined shift for nsb == 0 (a plain >>(64-nsb) would
          // shift by 64).
          const uint32_t sb =
              static_cast<uint32_t>(((w << clen) >> 1) >> (63 - nsb));
          const int8_t* row = slut[idx * 16 + sb];
          int32_t* out = coef + base + i;
          for (int d = 0; d < dim; ++d) out[d] = row[d];
          const int nbits = clen + nsb;
          w <<= nbits;
          avail -= nbits;
          bit += nbits;
        }
        br->bit = bit;
        if (i >= total) continue;  // band done; next band
        // Fall through to the general loop for the remaining tuples
        // (buffer tail), starting at i.
        for (; i < total; i += dim) {
          const int idx = vb.decode(br);
          if (idx < 0 || br->overrun) return false;
          int vals4[4];
          for (int d = 0; d < 4; ++d) vals4[d] = v.vals[cb - 1][idx][d];
          if (uns) {
            int nnzc = 0;
            for (int d = 0; d < dim; ++d) nnzc += vals4[d] != 0;
            if (nnzc) {
              uint32_t sb = br->get(nnzc);
              for (int d = 0; d < dim; ++d) {
                if (vals4[d]) {
                  if ((sb >> --nnzc) & 1) vals4[d] = -vals4[d];
                }
              }
            }
          }
          for (int d = 0; d < dim; ++d) coef[base + i + d] = vals4[d];
        }
        continue;
      }
      for (int i = 0; i < total; i += dim) {
        // Fast path: one left-aligned 64-bit window covers the codeword
        // (<= 19 bits) plus the tuple's sign bits (<= 4) — one load +
        // bswap per tuple instead of separate peek and get rounds.
        // Bitstream order: all sign bits for the tuple, then escape
        // sequences per coefficient (ISO 14496-3 spectral_data()); the
        // first nonzero gets the most-significant sign bit.
        int vals[4];
        const size_t byte = br->bit >> 3;
        if (byte + 8 <= br->len) {
          uint64_t w = br->load64(byte) << (br->bit & 7);
          int clen;
          const int idx = vb.decode_w(w, &clen);
          if (idx < 0) return false;
          // copy all 4 (rows are zero-padded): the nnz count below
          // reads vals[2..3] even for 2-tuple codebooks
          for (int d = 0; d < 4; ++d) vals[d] = dequant[idx][d];
          int nbits = clen;
          if (uns) {
            // dequant rows are zero-padded to 4, so counting all four
            // entries equals counting the tuple's dim entries.
            int nnz = (vals[0] != 0) + (vals[1] != 0) + (vals[2] != 0) +
                      (vals[3] != 0);
            if (nnz) {
              w <<= clen;
              uint32_t sb = static_cast<uint32_t>(w >> (64 - nnz));
              nbits += nnz;
              for (int d = 0; d < dim; ++d) {
                if (vals[d]) {
                  if ((sb >> --nnz) & 1) vals[d] = -vals[d];
                }
              }
            }
          }
          br->bit += nbits;
        } else {
          const int idx = vb.decode(br);
          if (idx < 0 || br->overrun) return false;
          for (int d = 0; d < dim; ++d) vals[d] = dequant[idx][d];
          if (uns) {
            int nnz = 0;
            for (int d = 0; d < dim; ++d) nnz += vals[d] != 0;
            if (nnz) {
              uint32_t sb = br->get(nnz);
              for (int d = 0; d < dim; ++d) {
                if (vals[d]) {
                  if ((sb >> --nnz) & 1) vals[d] = -vals[d];
                }
              }
            }
          }
        }
        if (cb != 11 && in_bounds) {
          // Common case: no escapes possible, whole band in bounds —
          // plain unchecked stores the compiler can vectorize.
          for (int d = 0; d < dim; ++d) coef[base + i + d] = vals[d];
        } else {
          for (int d = 0; d < dim; ++d) {
            int val = vals[d];
            if (cb == 11 && (val == 16 || val == -16)) {
              int n = 4;
              while (br->get(1) && n < 16) ++n;
              const int off = br->get(n);
              const int mag = (1 << n) + off;
              val = val < 0 ? -mag : mag;
              if (mag > 32767) ch->overflow = true;
            }
            // position: within group g, band k, interleaved by window
            const int pos = base + i + d;
            if (pos >= 0 && pos < 1024) coef[pos] = val;
          }
        }
      }
    }
    group_offset += glen * 128;
  }

  // Pulses (ISO 14496-3 4.6.3.3): add to the quantized magnitudes before
  // requantization. Only legal for long windows, where the grouped decode
  // order above equals the natural spectral order, so positions index
  // `coef` directly. A zero quantized value takes the negative amplitude.
  if (pulse && pulse->num > 0) {
    if (pulse->start_sfb > ics.num_swb) return false;
    int k = ics.swb_offset[pulse->start_sfb];
    for (int j = 0; j < pulse->num; ++j) {
      k += pulse->offset[j];
      if (k >= 1024) return false;
      if (coef[k] > 0) {
        coef[k] += pulse->amp[j];
      } else {
        coef[k] -= pulse->amp[j];
      }
    }
  }

  if (g_aac_timing.enabled) g_aac_timing.huff += AacTiming::now() - t0;
  return true;
}

// Requantize ch->qcoef + map grouped/interleaved order to natural window
// order. spec[] is zero-initialized, so zero coefficients and non-coding
// bands (zero/noise/intensity) are skipped outright.
void requant_channel(Channel* ch) {
  const IcsInfo& ics = ch->ics;
  const int32_t* coef = ch->qcoef;
  int group_offset = 0;
  const double t1 = g_aac_timing.enabled ? AacTiming::now() : 0;
  // spec is zeroed here (not in the per-frame reset) so the q-mode
  // path, which skips requantization entirely, never pays for it.
  memset(ch->spec, 0, sizeof(ch->spec));
  if (ics.window_sequence != EIGHT_SHORT) {
    // Long windows: one group of one window — decode order IS natural
    // order, so this is a straight sparse pass over the coded bands.
    for (int k = 0; k < ics.max_sfb && k < 64; ++k) {
      const int cb = ch->band_cb[0][k];
      if (cb < 1 || cb > 11) continue;
      const float gain = static_cast<float>(ch->sf[0][k]);
      const int end = ics.swb_offset[k + 1] < 1024 ? ics.swb_offset[k + 1]
                                                   : 1024;
      for (int i = ics.swb_offset[k]; i < end; ++i) {
        const int32_t x = coef[i];
        if (x) ch->spec[i] = requant43(x) * gain;
      }
    }
  } else {
    for (int g = 0; g < ics.num_window_groups; ++g) {
      const int glen = ics.group_len[g];
      const int win0 = group_offset / 128;
      for (int k = 0; k < ics.max_sfb && k < 64; ++k) {
        const int cb = ch->band_cb[g][k];
        if (cb < 1 || cb > 11) continue;
        const int band_start = ics.swb_offset[k];
        const int band_end = ics.swb_offset[k + 1];
        const float gain = static_cast<float>(ch->sf[g][k]);
        int src = group_offset + band_start * glen;
        for (int w = 0; w < glen; ++w) {
          const int dst0 = (win0 + w) * 128;
          for (int i = band_start; i < band_end; ++i, ++src) {
            const int dst = dst0 + i;
            if (src >= 1024 || dst >= 1024) continue;
            const int32_t x = coef[src];
            if (x) ch->spec[dst] = requant43(x) * gain;
          }
        }
      }
      group_offset += glen * 128;
    }
  }
  if (g_aac_timing.enabled) g_aac_timing.requant += AacTiming::now() - t1;
}

// TNS synthesis filtering per window (all-pole, direction-aware).
void apply_tns(Channel* ch) {
  const IcsInfo& ics = ch->ics;
  if (!ch->tns_present) return;
  for (int w = 0; w < ics.num_windows; ++w) {
    int bottom = ics.num_swb;
    for (int f = 0; f < ch->tns.n_filt[w]; ++f) {
      const TnsFilter& fl = ch->tns.filt[w][f];
      const int top = bottom;
      bottom = top - fl.length < 0 ? 0 : top - fl.length;
      if (fl.order == 0) continue;
      // Band range is clipped against min(tns_max_bands, max_sfb)
      // (ISO 14496-3 4.6.9.2).
      const int max_band =
          ics.max_sfb < ics.tns_max_bands ? ics.max_sfb : ics.tns_max_bands;
      const int start_b = bottom < max_band ? bottom : max_band;
      const int end_b = top < max_band ? top : max_band;
      int start = ics.swb_offset[start_b];
      int end = ics.swb_offset[end_b];
      const int tns_max = ics.window_sequence == EIGHT_SHORT ? 128 : 1024;
      if (start > tns_max) start = tns_max;
      if (end > tns_max) end = tns_max;
      int size = end - start;
      if (size <= 0) continue;
      float* base = ch->spec + w * (ics.window_sequence == EIGHT_SHORT ? 128 : 0);
      if (fl.direction) {
        for (int i = end - 1; i >= start; --i) {
          double acc = base[i];
          for (int j = 1; j <= fl.order && i + j < end; ++j) {
            acc -= fl.coef[j - 1] * base[i + j];
          }
          base[i] = static_cast<float>(acc);
        }
      } else {
        for (int i = start; i < end; ++i) {
          double acc = base[i];
          for (int j = 1; j <= fl.order && i - j >= start; ++j) {
            acc -= fl.coef[j - 1] * base[i - j];
          }
          base[i] = static_cast<float>(acc);
        }
      }
    }
  }
}

// PNS noise (deterministic LCG; any white noise of correct energy is
// spec-compliant — decoders differ here by design).
void apply_pns(Channel* ch, uint32_t* rng_state) {
  const IcsInfo& ics = ch->ics;
  int win0 = 0;
  for (int g = 0; g < ics.num_window_groups; win0 += ics.group_len[g], ++g) {
    for (int k = 0; k < ics.max_sfb; ++k) {
      if (ch->band_cb[g][k] != CB_NOISE) continue;
      const int band_start = ics.swb_offset[k];
      const int band_end = ics.swb_offset[k + 1];
      for (int w = 0; w < ics.group_len[g]; ++w) {
        const int win = win0 + w;
        float* base = ch->spec +
                      (ics.window_sequence == EIGHT_SHORT ? win * 128 : 0);
        double energy = 0;
        for (int i = band_start; i < band_end; ++i) {
          *rng_state = *rng_state * 1664525u + 1013904223u;
          const float r = static_cast<float>(
              static_cast<int32_t>(*rng_state) * (1.0 / 2147483648.0));
          base[i] = r;
          energy += r * r;
        }
        const double scale =
            ch->noise_nrg[g][k] / sqrt(energy + 1e-30);
        for (int i = band_start; i < band_end; ++i) {
          base[i] = static_cast<float>(base[i] * scale);
        }
      }
    }
  }
}

// M/S and intensity stereo for a channel pair.
void apply_stereo(Channel* l, Channel* r, const uint8_t* ms_mask, int ms_all) {
  const IcsInfo& ics = l->ics;
  for (int g = 0, win0 = 0; g < ics.num_window_groups;
       win0 += ics.group_len[g], ++g) {
    for (int k = 0; k < ics.max_sfb; ++k) {
      const int cb_r = r->band_cb[g][k];
      const int band_start = ics.swb_offset[k];
      const int band_end = ics.swb_offset[k + 1];
      const bool ms_on = ms_all == 2 || (ms_all == 1 && ms_mask[g * 64 + k]);
      for (int w = 0; w < ics.group_len[g]; ++w) {
        const int off =
            ics.window_sequence == EIGHT_SHORT ? (win0 + w) * 128 : 0;
        if (cb_r == CB_IS_MINUS || cb_r == CB_IS_PLUS) {
          // Intensity: right reconstructed from left.
          double scale = pow(0.5, 0.25 * r->is_pos[g][k]);
          int sign = cb_r == CB_IS_MINUS ? -1 : 1;
          if (ms_on) sign = -sign;  // ms_used inverts intensity direction
          for (int i = band_start; i < band_end; ++i) {
            r->spec[off + i] =
                static_cast<float>(sign * scale * l->spec[off + i]);
          }
        } else if (ms_on && cb_r != CB_NOISE) {
          for (int i = band_start; i < band_end; ++i) {
            const float m = l->spec[off + i];
            const float s = r->spec[off + i];
            l->spec[off + i] = m + s;
            r->spec[off + i] = m - s;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Element / frame parsing
// ---------------------------------------------------------------------------

bool parse_ics(BitReader* br, int sr_index, bool common_window,
               const IcsInfo* shared_ics, Channel* ch) {
  ch->global_gain = br->get(8);
  if (common_window) {
    ch->ics = *shared_ics;
  } else {
    if (!parse_ics_info(br, sr_index, &ch->ics)) return false;
  }
  if (!parse_section_data(br, ch)) return false;
  if (!parse_scale_factor_data(br, ch)) return false;
  PulseData pulse;
  if (br->get(1)) {  // pulse_data_present
    parse_pulse_data(br, &pulse);
    if (ch->ics.window_sequence == EIGHT_SHORT) return false;  // illegal
    ch->dbg_flags |= 16;
  }
  ch->tns_present = br->get(1);
  if (ch->tns_present) parse_tns_data(br, ch->ics, &ch->tns);
  if (br->get(1)) return false;  // gain_control: not LC
  return parse_spectral_data(br, ch, &pulse);
}

// Portable float32 -> float16 (round-to-nearest-even). Inputs are
// pre-scaled to |x| <= ~2^14 so overflow only guards pathological
// escape-heavy frames.
inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  __builtin_memcpy(&x, &f, 4);
  const uint16_t sign = (x >> 16) & 0x8000;
  const int32_t e = static_cast<int32_t>((x >> 23) & 0xFF) - 127 + 15;
  uint32_t m = x & 0x7FFFFF;
  if (e >= 31) return sign | 0x7C00;  // overflow -> inf
  if (e <= 0) {                       // subnormal or zero
    if (e < -10) return sign;
    m |= 0x800000;
    const int shift = 14 - e;  // 14..24
    uint16_t v = static_cast<uint16_t>(m >> shift);
    const uint32_t rem = m & ((1u << shift) - 1);
    const uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (v & 1))) ++v;
    return sign | v;
  }
  uint16_t v = static_cast<uint16_t>((e << 10) | (m >> 13));
  const uint32_t rem = m & 0x1FFF;
  if (rem > 0x1000 || (rem == 0x1000 && (v & 1))) ++v;  // carry ok
  return sign | v;
}

// Write one frame-channel's spectrum as block-scaled float16: spec16 =
// f16(spec * 2^-e) with e = max(0, ilogb(max|spec|) - 13), so the
// frame's largest magnitude lands in [2^13, 2^14) — full f16 mantissa
// precision on the dominant coefficients, ~5e-4 relative error overall
// (inside every acceptance tolerance; the f32 format remains for the
// decoder oracle paths).
inline int8_t spec_to_f16(const float* spec, uint16_t* out) {
  float maxabs = 0.0f;
  for (int i = 0; i < 1024; ++i) {
    const float a = fabsf(spec[i]);
    if (a > maxabs) maxabs = a;
  }
  int e = 0;
  if (maxabs > 0.0f) {
    e = ilogbf(maxabs) - 13;
    if (e < 0) e = 0;
  }
  const float scale = e ? exp2f(static_cast<float>(-e)) : 1.0f;
  for (int i = 0; i < 1024; ++i) out[i] = f32_to_f16(spec[i] * scale);
  return static_cast<int8_t>(e);
}

}  // namespace

extern "C" {

// Output record layout per frame-channel (kept in sync with
// mp3rgain_tpu/decode/aac_frontend.py):
enum {
  AAC_FRAME = 0,
  AAC_CHANNEL,
  AAC_WINDOW_SEQ,
  AAC_WINDOW_SHAPE,
  AAC_NCH,
  AAC_SR,
  AAC_VALID,
  AAC_INFO_N = 8,
};

// Unpack an ADTS AAC-LC stream into natural-order requantized spectra.
// Exactly one of `spec` (f32) / `spec16`+`sexp` (block-scaled f16 +
// per-frame exponent) / `qspec` (device-requant mode, see below) is
// non-null; info: (cap, AAC_INFO_N) i32.
// Returns frame-channel count (retry with larger cap if > cap).
//
// Device-requant (Q) mode: long-window frames skip requantize, PNS,
// stereo and TNS entirely on host; per lane the outputs are the raw
// quantized coefficients (q8, natural order int8 — values outside
// [-128, 127] ship as a sparse escape sideband: q8 holds 0 and
// esc_idx/esc_val record (lane*1024+pos, value)), per-band raw
// scalefactor integers (lvl: sf / PNS energy / intensity position),
// band types (btype: 0 zero, 1 normal, 2 noise, 3 is+, 4 is-) and
// ms_used flags (msf) — the device does the spectral prep. Frames the
// device path cannot express (EIGHT_SHORT windows, TNS, |q| > int16)
// fall back to the full host decode and ship as COMPACTED block-scaled
// f16 rows (fb16/fbexp, in lane order; lane indices recoverable from
// flag bit 32 in info[7]). *esc_count / *fb_count return the totals
// seen (retry with larger caps if either exceeds its cap).
static int64_t unpack_adts_impl(const uint8_t* data, size_t len,
                                float* spec, uint16_t* spec16,
                                int8_t* sexp, int32_t* info, int64_t cap,
                                int8_t* q8 = nullptr,
                                int16_t* lvl = nullptr,
                                uint8_t* btype = nullptr,
                                uint8_t* msf = nullptr,
                                uint16_t* fb16 = nullptr,
                                int8_t* fbexp = nullptr,
                                int32_t* esc_idx = nullptr,
                                int16_t* esc_val = nullptr,
                                int64_t esc_cap = 0,
                                int64_t* esc_count = nullptr,
                                int64_t fb_cap = 0,
                                int64_t* fb_count = nullptr) {
  static const int kSr[16] = {96000, 88200, 64000, 48000, 44100, 32000,
                              24000, 22050, 16000, 12000, 11025, 8000,
                              0, 0, 0, 0};
  const double tt0 = g_aac_timing.enabled ? AacTiming::now() : 0;
  int64_t n_out = 0;
  int64_t frame_idx = 0;
  uint32_t rng_state = 0x1f2e3d4c;
  size_t pos = 0;

  std::vector<Channel> chans(2);

  while (pos + 7 <= len) {
    if (data[pos] != 0xFF || (data[pos + 1] & 0xF0) != 0xF0) {
      ++pos;
      continue;
    }
    const int protection_absent = data[pos + 1] & 1;
    const int sr_index = (data[pos + 2] >> 2) & 0xF;
    const int ch_conf =
        ((data[pos + 2] & 1) << 2) | ((data[pos + 3] >> 6) & 3);
    const size_t full_len = ((data[pos + 3] & 0x3) << 11) |
                            (data[pos + 4] << 3) | (data[pos + 5] >> 5);
    if (full_len < 7 || pos + full_len > len || kSr[sr_index] == 0) {
      ++pos;
      continue;
    }
    const size_t header = protection_absent ? 7 : 9;
    BitReader br{data + pos + header, full_len - header, 0};

    const double tr0 = g_aac_timing.enabled ? AacTiming::now() : 0;
    chans[0].reset_for_frame();
    chans[1].reset_for_frame();
    if (g_aac_timing.enabled) g_aac_timing.reset += AacTiming::now() - tr0;
    int nch = 0;
    bool ok = true;
    bool is_cpe = false, cpe_common = false;
    uint8_t ms_mask[8 * 64] = {};
    int ms_type = 0;

    // raw_data_block: elements until END (id 7).
    while (ok && !br.overrun) {
      const int id = br.get(3);
      if (id == 7) break;  // END
      if (id == 0 || id == 3) {  // SCE / LFE
        br.skip(4);  // element_instance_tag
        ok = parse_ics(&br, sr_index, false, nullptr, &chans[nch < 2 ? nch : 1]);
        if (nch < 2) ++nch;
      } else if (id == 1) {  // CPE
        br.skip(4);
        const int common_window = br.get(1);
        IcsInfo shared;
        ms_type = 0;
        memset(ms_mask, 0, sizeof(ms_mask));
        if (common_window) {
          if (!parse_ics_info(&br, sr_index, &shared)) {
            ok = false;
            break;
          }
          ms_type = br.get(2);
          if (ms_type == 1) {
            for (int g = 0; g < shared.num_window_groups; ++g) {
              for (int k = 0; k < shared.max_sfb; ++k) {
                ms_mask[g * 64 + k] = br.get(1);
              }
            }
          }
        }
        ok = parse_ics(&br, sr_index, common_window, &shared, &chans[0]) &&
             parse_ics(&br, sr_index, common_window, &shared, &chans[1]);
        is_cpe = true;
        cpe_common = common_window != 0;
        nch = 2;
      } else if (id == 4) {  // DSE
        br.skip(4);
        const int align = br.get(1);
        int cnt = br.get(8);
        if (cnt == 255) cnt += br.get(8);
        if (align) br.bit = (br.bit + 7) & ~size_t(7);
        br.skip(cnt * 8);
      } else if (id == 6) {  // FIL
        int cnt = br.get(4);
        if (cnt == 15) cnt += br.get(8) - 1;
        br.skip(cnt * 8);
      } else if (id == 5) {  // PCE — skip whole remaining frame (rare)
        ok = false;
      } else {  // CCE or reserved: unsupported, drop frame
        ok = false;
      }
    }

    const int out_ch = nch == 0 ? (ch_conf == 1 ? 1 : 2) : nch;

    // Frame-level host-vs-device routing (Q mode). The whole frame goes
    // one way: stereo couples the channels, so a device lane must never
    // read a fallback lane.
    bool frame_fb = false;
    if (q8 && ok) {
      for (int c = 0; c < nch; ++c) {
        const Channel& ch = chans[c];
        if (ch.ics.window_sequence == EIGHT_SHORT || ch.tns_present ||
            ch.overflow) {
          frame_fb = true;
        }
      }
    }

    // Post-parse pipeline (requantize -> PNS -> stereo -> TNS), skipped
    // entirely for device-routed frames (the device replays it from the
    // quantized coefficients + band metadata; PNS is decoder-specific by
    // design, so the device uses its own deterministic noise).
    const bool host_dsp = ok && (!q8 || frame_fb);
    if (host_dsp) {
      for (int c = 0; c < nch; ++c) requant_channel(&chans[c]);
      const double tq0 = g_aac_timing.enabled ? AacTiming::now() : 0;
      for (int c = 0; c < nch; ++c) apply_pns(&chans[c], &rng_state);
      if (is_cpe && cpe_common) {
        apply_stereo(&chans[0], &chans[1], ms_mask, ms_type);
      }
      for (int c = 0; c < nch; ++c) apply_tns(&chans[c]);
      if (g_aac_timing.enabled) g_aac_timing.post += AacTiming::now() - tq0;
    }

    const double te0 = g_aac_timing.enabled ? AacTiming::now() : 0;
    for (int c = 0; c < out_ch; ++c) {
      Channel& ch = chans[c];
      const int64_t rec = n_out++;
      if (rec < cap) {
        int32_t* in = info + rec * AAC_INFO_N;
        if (spec) {
          float* sp = spec + rec * 1024;
          if (ok) {
            memcpy(sp, ch.spec, sizeof(ch.spec));
          } else {
            memset(sp, 0, 1024 * sizeof(float));
          }
        } else if (spec16) {
          uint16_t* sp = spec16 + rec * 1024;
          if (ok) {
            sexp[rec] = spec_to_f16(ch.spec, sp);
          } else {
            memset(sp, 0, 1024 * sizeof(uint16_t));
            sexp[rec] = 0;
          }
        } else {
          int8_t* qs = q8 + rec * 1024;
          int16_t* lv = lvl + rec * 64;
          uint8_t* bt = btype + rec * 64;
          uint8_t* mf = msf + rec * 64;
          memset(lv, 0, 64 * sizeof(int16_t));
          memset(bt, 0, 64);
          memset(mf, 0, 64);
          if (ok && !frame_fb) {
            // Long windows: decode order is natural order already.
            // |q| > 127 goes to the sparse escape sideband (q8 = 0 so
            // the device scatter-ADD reconstructs the exact value).
            // Books 1-10 emit |q| <= 16 and a pulse adds <= 15 (4-bit
            // amplitude), so a row can only exceed int8 through a
            // cb-11 band; skip the range scan outright when the row
            // has none — the common case on real content.
            bool may_escape = false;
            for (int k = 0; k < ch.ics.max_sfb && !may_escape; ++k) {
              may_escape = ch.band_cb[0][k] == 11;
            }
            int32_t mn = 0, mx = 0;
            if (may_escape) {
              for (int i = 0; i < 1024; ++i) {
                const int32_t q = ch.qcoef[i];
                mn = q < mn ? q : mn;
                mx = q > mx ? q : mx;
              }
            }
            if (mn >= -128 && mx <= 127) {
              for (int i = 0; i < 1024; ++i) {
                qs[i] = static_cast<int8_t>(ch.qcoef[i]);
              }
            } else {
              for (int i = 0; i < 1024; ++i) {
                const int32_t q = ch.qcoef[i];
                if (q >= -128 && q <= 127) {
                  qs[i] = static_cast<int8_t>(q);
                } else {
                  qs[i] = 0;
                  if (*esc_count < esc_cap) {
                    esc_idx[*esc_count] =
                        static_cast<int32_t>(rec * 1024 + i);
                    esc_val[*esc_count] = static_cast<int16_t>(q);
                  }
                  ++*esc_count;
                }
              }
            }
            const IcsInfo& ics = ch.ics;
            const int nsfb = ics.max_sfb < 64 ? ics.max_sfb : 64;
            for (int k = 0; k < nsfb; ++k) {
              const int cb = ch.band_cb[0][k];
              if (cb >= 1 && cb <= 11) {
                bt[k] = 1;
                lv[k] = static_cast<int16_t>(ch.sf_int[0][k]);
              } else if (cb == CB_NOISE) {
                bt[k] = 2;
                lv[k] = static_cast<int16_t>(ch.noise_int[0][k]);
              } else if (cb == CB_IS_PLUS || cb == CB_IS_MINUS) {
                bt[k] = cb == CB_IS_PLUS ? 3 : 4;
                lv[k] = static_cast<int16_t>(ch.is_pos[0][k]);
              }
              if (is_cpe && cpe_common) {
                mf[k] = ms_type == 2 ? 1 : (ms_type == 1 ? ms_mask[k] : 0);
              }
            }
          } else {
            memset(qs, 0, 1024);
            if (ok) {  // fallback: full host decode, compacted f16 row
              if (*fb_count < fb_cap) {
                fbexp[*fb_count] = spec_to_f16(ch.spec,
                                               fb16 + *fb_count * 1024);
              }
              ++*fb_count;
            }  // !ok lanes ship as all-zero qspec, no f16 row
          }
        }
        in[AAC_FRAME] = static_cast<int32_t>(frame_idx);
        in[AAC_CHANNEL] = c;
        in[AAC_WINDOW_SEQ] = ok ? ch.ics.window_sequence : 0;
        in[AAC_WINDOW_SHAPE] = ok ? ch.ics.window_shape : 0;
        in[AAC_NCH] = out_ch;
        in[AAC_SR] = kSr[sr_index];
        in[AAC_VALID] = ok ? 1 : 0;
        in[7] = (ch.tns_present ? 1 : 0) | ch.dbg_flags |
                (frame_fb && ok ? 32 : 0);  // diagnostics + fb routing
      }
    }
    if (g_aac_timing.enabled) g_aac_timing.emit += AacTiming::now() - te0;
    ++frame_idx;
    pos += full_len;
  }
  if (g_aac_timing.enabled) {
    g_aac_timing.total += AacTiming::now() - tt0;
    g_aac_timing.dump();
  }
  return n_out;
}

int64_t mg_aac_unpack_adts(const uint8_t* data, size_t len, float* spec,
                           int32_t* info, int64_t cap) {
  return unpack_adts_impl(data, len, spec, nullptr, nullptr, info, cap);
}

// Half-precision variant for the batch analysis path: halves the
// host->device payload; the f32 variant remains the decoder oracle.
int64_t mg_aac_unpack_adts_f16(const uint8_t* data, size_t len,
                               uint16_t* spec16, int8_t* sexp,
                               int32_t* info, int64_t cap) {
  return unpack_adts_impl(data, len, nullptr, spec16, sexp, info, cap);
}

// Device-requant variant: quantized coefficients + band metadata out;
// the requantize/PNS/stereo spectral prep runs on the accelerator
// (decode/aac_prep.py). Frames the device path cannot express ship as
// block-scaled f16 fallback rows (see unpack_adts_impl docs above).
int64_t mg_aac_unpack_adts_q(const uint8_t* data, size_t len,
                             int8_t* q8, int16_t* lvl, uint8_t* btype,
                             uint8_t* msf, uint16_t* fb16, int8_t* fbexp,
                             int64_t fb_cap, int64_t* fb_count,
                             int32_t* esc_idx, int16_t* esc_val,
                             int64_t esc_cap, int64_t* esc_count,
                             int32_t* info, int64_t cap) {
  *esc_count = 0;
  *fb_count = 0;
  return unpack_adts_impl(data, len, nullptr, nullptr, nullptr, info, cap,
                          q8, lvl, btype, msf, fb16, fbexp,
                          esc_idx, esc_val, esc_cap, esc_count,
                          fb_cap, fb_count);
}

}  // extern "C"
