// The torch port's copy of mp3rgain_tpu/_native/mp3dec.cpp; the port builds it with g++ at
// first use (mp3rgain_tpu_torch/native.py). tests/test_torch_host_copies.py
// holds its outputs equal to the original's.
//
// MP3 decode front-end: the host-side entropy stage of the TPU decoder.
//
// Unpacks an entire MP3 file into dense per-granule-channel tensors that the
// JAX/Pallas decode back-end consumes: side info fields, scalefactors, and
// Huffman-decoded quantized spectra (576 ints per granule-channel). This
// replaces the packet/entropy stage of the reference's external decoder
// (symphonia-bundle-mp3; reference uses it at src/replaygain.rs:804-904).
// Everything after this stage (requantize, stereo, antialias, IMDCT,
// polyphase synthesis, DSP) runs on device.
//
// Format logic follows ISO/IEC 11172-3 (MPEG1) and ISO/IEC 13818-3 (LSF);
// tables come from the generated huffman_tables.h.

#include "native.h"
#include "huffman_tables.h"

#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Frame walk (identical behavior to bitstream.cpp's iterate_frames)
// ---------------------------------------------------------------------------

constexpr uint32_t kBitrateMpeg1[15] = {0,  32,  40,  48,  56,  64,  80, 96,
                                        112, 128, 160, 192, 224, 256, 320};
constexpr uint32_t kBitrateMpeg2[15] = {0,  8,  16, 24, 32,  40,  48, 56,
                                        64, 80, 96, 112, 128, 144, 160};
constexpr uint32_t kSampleRate[3][3] = {{44100, 48000, 32000},
                                        {22050, 24000, 16000},
                                        {11025, 12000, 8000}};

struct FrameHeader {
  int version;  // 1, 2, 25
  bool has_crc;
  uint32_t bitrate_kbps;
  uint32_t sample_rate;
  int sr_index;   // 0..2 within version
  bool padding;
  int channel_mode;    // 0 stereo, 1 joint, 2 dual, 3 mono
  int mode_extension;  // 0..3
  size_t frame_size;

  int granule_count() const { return version == 1 ? 2 : 1; }
  int channel_count() const { return channel_mode == 3 ? 1 : 2; }
  size_t side_info_offset() const { return has_crc ? 6 : 4; }
  size_t side_info_len() const {
    if (version == 1) return channel_mode == 3 ? 17 : 32;
    return channel_mode == 3 ? 9 : 17;
  }
  int sr_row() const {  // row into kBandSize* tables
    const int base = version == 1 ? 0 : (version == 2 ? 3 : 6);
    return base + sr_index;
  }
  bool lsf() const { return version != 1; }
};

bool parse_header(const uint8_t* p, size_t avail, FrameHeader* h) {
  if (avail < 4) return false;
  if (p[0] != 0xFF || (p[1] & 0xE0) != 0xE0) return false;
  const int version_bits = (p[1] >> 3) & 0x03;
  switch (version_bits) {
    case 0b00: h->version = 25; break;
    case 0b10: h->version = 2; break;
    case 0b11: h->version = 1; break;
    default: return false;
  }
  if (((p[1] >> 1) & 0x03) != 0b01) return false;
  h->has_crc = (p[1] & 0x01) == 0;
  const int bitrate_index = (p[2] >> 4) & 0x0F;
  if (bitrate_index == 0 || bitrate_index == 15) return false;
  h->bitrate_kbps = (h->version == 1) ? kBitrateMpeg1[bitrate_index]
                                      : kBitrateMpeg2[bitrate_index];
  const int sr_index = (p[2] >> 2) & 0x03;
  if (sr_index == 3) return false;
  h->sr_index = sr_index;
  const int vi = (h->version == 1) ? 0 : (h->version == 2 ? 1 : 2);
  h->sample_rate = kSampleRate[vi][sr_index];
  h->padding = (p[2] & 0x02) != 0;
  h->channel_mode = (p[3] >> 6) & 0x03;
  h->mode_extension = (p[3] >> 4) & 0x03;
  const size_t samples = (h->version == 1) ? 1152 : 576;
  h->frame_size = (samples * h->bitrate_kbps * 125) / h->sample_rate +
                  (h->padding ? 1 : 0);
  return true;
}

size_t skip_id3v2(const uint8_t* data, size_t len) {
  if (len < 10 || memcmp(data, "ID3", 3) != 0) return 0;
  const size_t size = (static_cast<size_t>(data[6] & 0x7F) << 21) |
                      (static_cast<size_t>(data[7] & 0x7F) << 14) |
                      (static_cast<size_t>(data[8] & 0x7F) << 7) |
                      (static_cast<size_t>(data[9] & 0x7F));
  return 10 + size;
}

uint32_t read_u32_le(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

size_t find_audio_end(const uint8_t* data, size_t len) {
  size_t audio_end = len;
  if (audio_end >= 128 && memcmp(data + audio_end - 128, "TAG", 3) == 0) {
    audio_end -= 128;
  }
  if (audio_end >= 32 && memcmp(data + audio_end - 32, "APETAGEX", 8) == 0) {
    const size_t footer_start = audio_end - 32;
    const size_t tag_size = read_u32_le(data + footer_start + 12);
    const uint32_t flags = read_u32_le(data + footer_start + 20);
    const size_t header_size = (flags & (1u << 31)) ? 32 : 0;
    if (footer_start + 32 >= tag_size + header_size) {
      audio_end = footer_start + 32 - tag_size - header_size;
    }
  }
  return audio_end;
}

bool is_xing_frame(const uint8_t* data, size_t len, size_t frame_offset,
                   const FrameHeader& h) {
  const size_t xing_offset =
      frame_offset + h.side_info_offset() + h.side_info_len();
  if (xing_offset + 4 > len) return false;
  const uint8_t* m = data + xing_offset;
  return memcmp(m, "Xing", 4) == 0 || memcmp(m, "Info", 4) == 0;
}

// ---------------------------------------------------------------------------
// Bit readers
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
// Huffman decode LUTs (two-level: 9-bit primary, 10-bit secondary)
// ---------------------------------------------------------------------------

constexpr int kL1Bits = 9;
constexpr int kL2Bits = 10;

struct HuffLut {
  // Primary: value = (x<<4)|y | (len<<8) when len <= 9; 0x8000|sub_index when
  // escape; 0xFFFF invalid.
  std::vector<uint16_t> l1;
  std::vector<uint16_t> l2;  // concatenated 10-bit secondary tables

  void build(const HuffEntry* entries, int n) {
    l1.assign(1 << kL1Bits, 0xFFFF);
    std::vector<int> sub_of_prefix(1 << kL1Bits, -1);
    for (int i = 0; i < n; ++i) {
      const HuffEntry& e = entries[i];
      if (e.len <= kL1Bits) {
        const int shift = kL1Bits - e.len;
        const uint32_t base = e.code << shift;
        const uint16_t v =
            static_cast<uint16_t>((e.x << 4) | e.y | (e.len << 8));
        for (uint32_t j = 0; j < (1u << shift); ++j) l1[base + j] = v;
      } else {
        const uint32_t prefix = e.code >> (e.len - kL1Bits);
        if (sub_of_prefix[prefix] < 0) {
          sub_of_prefix[prefix] = static_cast<int>(l2.size()) >> kL2Bits;
          l1[prefix] = static_cast<uint16_t>(0x8000 | sub_of_prefix[prefix]);
          l2.resize(l2.size() + (1 << kL2Bits), 0xFFFF);
        }
        const int sub = sub_of_prefix[prefix];
        const int rem_len = e.len - kL1Bits;  // <= 10
        const uint32_t rem = e.code & ((1u << rem_len) - 1);
        const int shift = kL2Bits - rem_len;
        const uint32_t base = (sub << kL2Bits) + (rem << shift);
        const uint16_t v =
            static_cast<uint16_t>((e.x << 4) | e.y | (rem_len << 8));
        for (uint32_t j = 0; j < (1u << shift); ++j) l2[base + j] = v;
      }
    }
  }

  // Decode one (x, y); returns false on invalid code.
  bool decode(BitReader* br, int* x, int* y) const {
    uint16_t v = l1[br->peek(kL1Bits)];
    if (v == 0xFFFF) return false;
    if (v & 0x8000) {
      const int sub = v & 0x7FFF;
      br->skip(kL1Bits);
      v = l2[(sub << kL2Bits) + br->peek(kL2Bits)];
      if (v == 0xFFFF) return false;
      br->skip(v >> 8);
    } else {
      br->skip(v >> 8);
    }
    *x = (v >> 4) & 0xF;
    *y = v & 0xF;
    return true;
  }
};

struct HuffmanSet {
  HuffLut luts[15];
  int lut_index[34];  // table id -> lut slot, -1 for none
  // count1 table A LUT: 6-bit peek -> (value<<4)|len
  uint8_t quad_a[64];

  HuffmanSet() {
    const HuffEntry* tabs[15] = {
        kHuffTable1, kHuffTable2, kHuffTable3, kHuffTable5, kHuffTable6,
        kHuffTable7, kHuffTable8, kHuffTable9, kHuffTable10, kHuffTable11,
        kHuffTable12, kHuffTable13, kHuffTable15, kHuffTable16, kHuffTable24};
    for (int i = 0; i < 34; ++i) lut_index[i] = -1;
    for (int i = 0; i < 15; ++i) {
      luts[i].build(tabs[i], kHuffTableSizes[i]);
      lut_index[kHuffTableIds[i]] = i;
    }
    memset(quad_a, 0xFF, sizeof(quad_a));
    for (int v = 0; v < 16; ++v) {
      const int len = kQuadALen[v];
      const uint32_t base = kQuadACode[v] << (6 - len);
      for (uint32_t j = 0; j < (1u << (6 - len)); ++j) {
        quad_a[base + j] = static_cast<uint8_t>((v << 4) | len);
      }
    }
  }
};

const HuffmanSet& huffman() {
  static const HuffmanSet set;
  return set;
}

// ---------------------------------------------------------------------------
// Side info / granule structures
// ---------------------------------------------------------------------------

struct GranuleInfo {
  int part2_3_length = 0;
  int big_values = 0;
  int global_gain = 0;
  int scalefac_compress = 0;
  int window_switching = 0;
  int block_type = 0;
  int mixed_block_flag = 0;
  int table_select[3] = {0, 0, 0};
  int subblock_gain[3] = {0, 0, 0};
  int region0_count = 0;
  int region1_count = 0;
  int preflag = 0;
  int scalefac_scale = 0;
  int count1table_select = 0;
};

struct SideInfo {
  int main_data_begin = 0;
  int scfsi[2][4] = {};
  GranuleInfo gr[2][2];  // [granule][channel]
};

void parse_side_info(const uint8_t* p, const FrameHeader& h, SideInfo* si) {
  BitReader br{p, h.side_info_len(), 0};
  const int nch = h.channel_count();
  if (!h.lsf()) {
    si->main_data_begin = br.get(9);
    br.get(nch == 1 ? 5 : 3);  // private bits
    for (int ch = 0; ch < nch; ++ch) {
      for (int b = 0; b < 4; ++b) si->scfsi[ch][b] = br.get(1);
    }
  } else {
    si->main_data_begin = br.get(8);
    br.get(nch == 1 ? 1 : 2);
  }
  for (int g = 0; g < h.granule_count(); ++g) {
    for (int ch = 0; ch < nch; ++ch) {
      GranuleInfo& gi = si->gr[g][ch];
      gi.part2_3_length = br.get(12);
      gi.big_values = br.get(9);
      gi.global_gain = br.get(8);
      gi.scalefac_compress = br.get(h.lsf() ? 9 : 4);
      gi.window_switching = br.get(1);
      if (gi.window_switching) {
        gi.block_type = br.get(2);
        gi.mixed_block_flag = br.get(1);
        gi.table_select[0] = br.get(5);
        gi.table_select[1] = br.get(5);
        gi.table_select[2] = 0;
        for (int w = 0; w < 3; ++w) gi.subblock_gain[w] = br.get(3);
        // Implicit region counts (ISO 2.4.2.7): region0 = 8 for pure short,
        // 7 otherwise; region1 covers the remainder.
        gi.region0_count = (gi.block_type == 2 && !gi.mixed_block_flag) ? 8 : 7;
        gi.region1_count = 20 - gi.region0_count;
      } else {
        for (int r = 0; r < 3; ++r) gi.table_select[r] = br.get(5);
        gi.region0_count = br.get(4);
        gi.region1_count = br.get(3);
        gi.block_type = 0;
        gi.mixed_block_flag = 0;
      }
      if (!h.lsf()) gi.preflag = br.get(1);
      gi.scalefac_scale = br.get(1);
      gi.count1table_select = br.get(1);
    }
  }
}

// ---------------------------------------------------------------------------
// Scalefactors
// ---------------------------------------------------------------------------

// Output layout per granule-channel: scf[0..22] = long sfbs, scf[23..61] =
// short sfbs sfb-major (sfb * 3 + window).
constexpr int kScfLong = 0;
constexpr int kScfShort = 23;
constexpr int kScfSlots = 64;

// MPEG1 scfsi band groups over long sfbs (ISO 2.4.2.7 scfsi_band).
constexpr int kScfsiBands[5] = {0, 6, 11, 16, 21};

void read_scalefactors_mpeg1(BitReader* br, const GranuleInfo& gi,
                             const int* scfsi, bool granule1,
                             const int32_t* prev_scf, int32_t* scf) {
  const int slen1 = kSlen1[gi.scalefac_compress];
  const int slen2 = kSlen2[gi.scalefac_compress];
  if (gi.block_type == 2 && gi.window_switching) {
    if (gi.mixed_block_flag) {
      for (int sfb = 0; sfb < 8; ++sfb) {
        scf[kScfLong + sfb] = br->get(slen1);
      }
      for (int sfb = 3; sfb < 6; ++sfb) {
        for (int w = 0; w < 3; ++w) scf[kScfShort + sfb * 3 + w] = br->get(slen1);
      }
      for (int sfb = 6; sfb < 12; ++sfb) {
        for (int w = 0; w < 3; ++w) scf[kScfShort + sfb * 3 + w] = br->get(slen2);
      }
    } else {
      for (int sfb = 0; sfb < 6; ++sfb) {
        for (int w = 0; w < 3; ++w) scf[kScfShort + sfb * 3 + w] = br->get(slen1);
      }
      for (int sfb = 6; sfb < 12; ++sfb) {
        for (int w = 0; w < 3; ++w) scf[kScfShort + sfb * 3 + w] = br->get(slen2);
      }
    }
  } else {
    for (int group = 0; group < 4; ++group) {
      const int slen = group < 2 ? slen1 : slen2;
      const bool copy = granule1 && scfsi[group];
      for (int sfb = kScfsiBands[group]; sfb < kScfsiBands[group + 1]; ++sfb) {
        scf[kScfLong + sfb] =
            copy ? prev_scf[kScfLong + sfb] : static_cast<int32_t>(br->get(slen));
      }
    }
  }
}

// LSF (MPEG2/2.5) scalefactors, incl. the intensity-stereo variant for ch1
// (ISO 13818-3 2.4.3.2; same algorithm as common decoders' lsf_sf_expand).
void lsf_sf_expand(int* slen, int sf, int n1, int n2, int n3) {
  if (n3) {
    slen[3] = sf % n3;
    sf /= n3;
  } else {
    slen[3] = 0;
  }
  if (n2) {
    slen[2] = sf % n2;
    sf /= n2;
  } else {
    slen[2] = 0;
  }
  slen[1] = sf % n1;
  sf /= n1;
  slen[0] = sf;
}

void read_scalefactors_lsf(BitReader* br, GranuleInfo* gi, bool intensity_ch,
                           int* intensity_scale, int32_t* scf) {
  int sf = gi->scalefac_compress;
  int slen[4];
  int row;
  if (intensity_ch) {
    *intensity_scale = sf & 1;
    sf >>= 1;
    if (sf < 180) {
      lsf_sf_expand(slen, sf, 6, 6, 0);
      row = 3;
    } else if (sf < 244) {
      lsf_sf_expand(slen, sf - 180, 4, 4, 0);
      row = 4;
    } else {
      lsf_sf_expand(slen, sf - 244, 3, 1, 0);
      row = 5;
    }
  } else {
    if (sf < 400) {
      lsf_sf_expand(slen, sf, 5, 4, 4);
      row = 0;
    } else if (sf < 500) {
      lsf_sf_expand(slen, sf - 400, 5, 4, 0);
      row = 1;
    } else {
      lsf_sf_expand(slen, sf - 500, 3, 1, 0);
      row = 2;
      gi->preflag = 1;
    }
  }
  const int kind = gi->block_type == 2 ? (gi->mixed_block_flag ? 2 : 1) : 0;

  // Read the flat scalefactor sequence and map into long/short slots.
  int vals[40];
  int n = 0;
  for (int part = 0; part < 4; ++part) {
    const int count = kLsfNsfTable[row][kind][part];
    for (int i = 0; i < count && n < 40; ++i) {
      vals[n++] = slen[part] ? static_cast<int>(br->get(slen[part])) : 0;
    }
  }
  int v = 0;
  if (kind == 0) {
    for (int sfb = 0; sfb < n && sfb < 22; ++sfb) scf[kScfLong + sfb] = vals[v++];
  } else if (kind == 1) {
    for (int sfb = 0; sfb < 13 && v + 2 < n + 3; ++sfb) {
      for (int w = 0; w < 3; ++w) {
        scf[kScfShort + sfb * 3 + w] = v < n ? vals[v] : 0;
        ++v;
      }
    }
  } else {
    for (int sfb = 0; sfb < 6; ++sfb) scf[kScfLong + sfb] = v < n ? vals[v++] : 0;
    for (int sfb = 3; sfb < 13; ++sfb) {
      for (int w = 0; w < 3; ++w) {
        scf[kScfShort + sfb * 3 + w] = v < n ? vals[v] : 0;
        ++v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Huffman spectrum decode
// ---------------------------------------------------------------------------

void decode_spectrum(BitReader* br, size_t part2_3_end_bit,
                     const GranuleInfo& gi, const FrameHeader& h,
                     int32_t* is, int* big_end_out, int* count1_end_out) {
  const HuffmanSet& hs = huffman();

  // Region boundaries in sample indices.
  const uint8_t* bl = kBandSizeLong[h.sr_row()];
  int long_index[23];
  long_index[0] = 0;
  for (int i = 0; i < 22; ++i) long_index[i + 1] = long_index[i] + bl[i];

  int region1_start, region2_start;
  if (gi.window_switching && gi.block_type == 2) {
    // Implied region0 = 9 window-bands = 3 short sfbs x 3 windows;
    // rate-dependent (72 at 8 kHz where short bands are 8 wide).
    const uint8_t* bs = kBandSizeShort[h.sr_row()];
    region1_start = 3 * (bs[0] + bs[1] + bs[2]);
    region2_start = 576;
  } else if (gi.window_switching) {
    region1_start = long_index[8];
    region2_start = 576;
  } else {
    const int r0 = gi.region0_count + 1 < 23 ? gi.region0_count + 1 : 22;
    int r1 = gi.region0_count + gi.region1_count + 2;
    if (r1 > 22) r1 = 22;
    region1_start = long_index[r0];
    region2_start = long_index[r1];
  }

  int big_end = gi.big_values * 2;
  if (big_end > 576) big_end = 576;

  int pos = 0;
  while (pos < big_end && !br->overrun && br->bit < part2_3_end_bit) {
    const int region = pos < region1_start ? 0 : (pos < region2_start ? 1 : 2);
    const int tsel = gi.table_select[region];
    const int tid = kHuffSelect[tsel].table_id;
    const int linbits = kHuffSelect[tsel].linbits;
    if (tid == 0) {
      is[pos] = 0;
      is[pos + 1] = 0;
      pos += 2;
      continue;
    }
    int x, y;
    if (!hs.luts[hs.lut_index[tid]].decode(br, &x, &y)) {
      br->overrun = true;
      break;
    }
    if (x == 15 && linbits) x += br->get(linbits);
    if (x && br->get(1)) x = -x;
    if (y == 15 && linbits) y += br->get(linbits);
    if (y && br->get(1)) y = -y;
    is[pos] = x;
    is[pos + 1] = y;
    pos += 2;
  }
  big_end = pos;

  // count1 quadruples until part2_3 bits are consumed (overshoot discarded).
  while (pos + 4 <= 576 && !br->overrun && br->bit < part2_3_end_bit) {
    const size_t before = br->bit;
    int v;
    if (gi.count1table_select) {
      v = 15 - static_cast<int>(br->get(4));  // table B: code = ~value
    } else {
      const uint8_t e = hs.quad_a[br->peek(6)];
      v = e >> 4;
      br->skip(e & 0xF);
    }
    int quad[4] = {(v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1};
    for (int i = 0; i < 4; ++i) {
      if (quad[i] && br->get(1)) quad[i] = -quad[i];
    }
    if (br->bit > part2_3_end_bit) {
      br->bit = before;  // rewind the overshooting quad
      break;
    }
    for (int i = 0; i < 4; ++i) is[pos + i] = quad[i];
    pos += 4;
  }
  *big_end_out = big_end;
  *count1_end_out = pos;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// info field indices (keep in sync with mp3rgain_tpu/decode/frontend.py).
enum {
  GCH_FRAME = 0,
  GCH_GRANULE,
  GCH_CHANNEL,
  GCH_GLOBAL_GAIN,
  GCH_SCALEFAC_SCALE,
  GCH_PREFLAG,
  GCH_BLOCK_TYPE,
  GCH_MIXED,
  GCH_SBG0,
  GCH_SBG1,
  GCH_SBG2,
  GCH_VERSION,
  GCH_SR_ROW,
  GCH_CHANNEL_MODE,
  GCH_MODE_EXT,
  GCH_SAMPLE_RATE,
  GCH_BIG_END,
  GCH_COUNT1_END,
  GCH_VALID,
  GCH_INTENSITY_SCALE,
  GCH_NCHANNELS,
  GCH_INFO_N = 24,
};

// Unpack the whole file. Writes up to cap_gch granule-channel records into
// info (GCH_INFO_N i32 each), scf (64 i32 each), is (576 i32 each).
// Returns the number of granule-channels (caller retries with a larger cap
// if the return value exceeds cap_gch).
int64_t mg_mp3_unpack(const uint8_t* data, size_t len, int32_t* info,
                      int32_t* scf, int32_t* is, int64_t cap_gch) {
  const size_t audio_end = find_audio_end(data, len);
  size_t pos = skip_id3v2(data, len);

  std::vector<uint8_t> reservoir;
  reservoir.reserve(1 << 16);

  int64_t n_gch = 0;
  int64_t frame_idx = 0;
  int32_t prev_scf[2][kScfSlots] = {};

  while (pos + 4 <= audio_end) {
    FrameHeader h;
    if (!parse_header(data + pos, len - pos, &h)) {
      ++pos;
      continue;
    }
    const size_t next_pos = pos + h.frame_size;
    bool valid_frame;
    if (next_pos + 2 <= audio_end) {
      valid_frame = data[next_pos] == 0xFF && (data[next_pos + 1] & 0xE0) == 0xE0;
    } else {
      valid_frame = next_pos <= audio_end;
    }
    if (!valid_frame) {
      ++pos;
      continue;
    }
    if (is_xing_frame(data, len, pos, h)) {
      pos = next_pos;
      continue;
    }

    SideInfo si;
    parse_side_info(data + pos + h.side_info_offset(), h, &si);

    // Append this frame's main data to the reservoir.
    const size_t md_start = pos + h.side_info_offset() + h.side_info_len();
    const size_t md_end = next_pos < audio_end ? next_pos : audio_end;
    const size_t prev_size = reservoir.size();
    if (md_end > md_start) {
      reservoir.insert(reservoir.end(), data + md_start, data + md_end);
    }

    const bool reservoir_ok =
        static_cast<size_t>(si.main_data_begin) <= prev_size;
    size_t gr_bit =
        reservoir_ok ? (prev_size - si.main_data_begin) * 8 : 0;

    const int nch = h.channel_count();
    for (int g = 0; g < h.granule_count(); ++g) {
      for (int ch = 0; ch < nch; ++ch) {
        GranuleInfo gi = si.gr[g][ch];
        const int64_t rec = n_gch++;
        if (rec >= cap_gch) continue;

        int32_t* rinfo = info + rec * GCH_INFO_N;
        int32_t* rscf = scf + rec * kScfSlots;
        int32_t* ris = is + rec * 576;
        memset(rinfo, 0, GCH_INFO_N * sizeof(int32_t));
        memset(rscf, 0, kScfSlots * sizeof(int32_t));
        memset(ris, 0, 576 * sizeof(int32_t));

        int intensity_scale = 0;
        int big_end = 0, count1_end = 0;
        bool ok = reservoir_ok;
        size_t reservoir_bit_check = 0;
        if (ok) {
          BitReader br{reservoir.data(), reservoir.size(), gr_bit};
          const size_t end_bit = gr_bit + gi.part2_3_length;
          if (!h.lsf()) {
            read_scalefactors_mpeg1(&br, gi, si.scfsi[ch], g == 1,
                                    prev_scf[ch], rscf);
          } else {
            const bool intensity_ch =
                ch == 1 && h.channel_mode == 1 && (h.mode_extension & 1);
            read_scalefactors_lsf(&br, &gi, intensity_ch, &intensity_scale,
                                  rscf);
          }
          if (br.bit <= end_bit && !br.overrun) {
            decode_spectrum(&br, end_bit, gi, h, ris, &big_end, &count1_end);
          }
          ok = !br.overrun && br.bit <= end_bit + 64;
          reservoir_bit_check = end_bit - br.bit;  // unused-bit slack
          gr_bit += gi.part2_3_length;
          if (!h.lsf()) {
            memcpy(prev_scf[ch], rscf, kScfSlots * sizeof(int32_t));
          }
        }
        if (!ok) {
          memset(ris, 0, 576 * sizeof(int32_t));
          big_end = count1_end = 0;
        }

        rinfo[GCH_FRAME] = static_cast<int32_t>(frame_idx);
        rinfo[GCH_GRANULE] = g;
        rinfo[GCH_CHANNEL] = ch;
        rinfo[GCH_GLOBAL_GAIN] = gi.global_gain;
        rinfo[GCH_SCALEFAC_SCALE] = gi.scalefac_scale;
        rinfo[GCH_PREFLAG] = gi.preflag;
        rinfo[GCH_BLOCK_TYPE] = gi.window_switching ? gi.block_type : 0;
        rinfo[GCH_MIXED] = gi.mixed_block_flag;
        rinfo[GCH_SBG0] = gi.subblock_gain[0];
        rinfo[GCH_SBG1] = gi.subblock_gain[1];
        rinfo[GCH_SBG2] = gi.subblock_gain[2];
        rinfo[GCH_VERSION] = h.version;
        rinfo[GCH_SR_ROW] = h.sr_row();
        rinfo[GCH_CHANNEL_MODE] = h.channel_mode;
        rinfo[GCH_MODE_EXT] = h.mode_extension;
        rinfo[GCH_SAMPLE_RATE] = static_cast<int32_t>(h.sample_rate);
        rinfo[GCH_BIG_END] = big_end;
        rinfo[GCH_COUNT1_END] = count1_end;
        rinfo[GCH_VALID] = ok ? 1 : 0;
        rinfo[21] = static_cast<int32_t>(reservoir_bit_check);  // slack
        rinfo[GCH_INTENSITY_SCALE] = intensity_scale;
        rinfo[GCH_NCHANNELS] = nch;
      }
    }

    // Bound reservoir growth (keep the last 64 KiB; main_data_begin < 512).
    if (reservoir.size() > (1u << 16)) {
      const size_t drop = reservoir.size() - (1u << 15);
      reservoir.erase(reservoir.begin(), reservoir.begin() + drop);
      gr_bit = gr_bit > drop * 8 ? gr_bit - drop * 8 : 0;
    }

    ++frame_idx;
    pos = next_pos;
  }
  return n_gch;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Light unpack: byte walk + side info + scalefactors + reservoir windows,
// leaving the Huffman spectral decode to the device entropy kernel
// (mp3rgain_tpu/decode/entropy_kernel.py). Meta layout must match
// entropy_kernel.LIGHT_* constants.
// ---------------------------------------------------------------------------

namespace {

// table id -> entropy_tables group id (kHuffTableIds order, 0 = table 0).
int table_group(int tid) {
  for (int i = 0; i < 15; ++i) {
    if (kHuffTableIds[i] == tid) return i + 1;
  }
  return 0;
}

}  // namespace

extern "C" {

enum {
  LM_P0 = 0,
  LM_P23,
  LM_BVP,
  LM_R0P,
  LM_R1P,
  LM_G0,
  LM_G1,
  LM_G2,
  LM_L0,
  LM_L1,
  LM_L2,
  LM_GCNT,
  LIGHT_META_N = 12,
};

// Like mg_mp3_unpack but emits per-gch raw Huffman bit windows + decode
// metadata instead of decoded spectra. md rows are md_stride bytes; a row
// holds the reservoir bytes covering [part3_start, part3_end] plus up to
// 8 bytes of real following reservoir data (the kernel may legally read
// past part2_3_length mid-symbol, as the host BitReader does).
//
// Two emitters share this implementation (see the extern "C" wrappers):
//   dense  — (info GCH_INFO_N i32, scf 64 i32) per gch: the oracle/test
//            form (mg_mp3_unpack_light, unchanged contract);
//   packed — the transfer form the batch prep ships as-is: ip (2 u16,
//            frontend.pack_info_light layout), scf_main (12 u8 low
//            nibbles of slots 0..23) + sparse short-window/high-bit
//            sidebands (frontend.pack_scf_rows layout). Emitting packed
//            directly cuts the walk's write traffic ~4x (the dense
//            int32 info+scf rows were ~3.2 MB per 60 s track vs
//            ~0.15 MB packed) — the light walk is write-bound.
static int64_t unpack_light_impl(
    const uint8_t* data, size_t len, int32_t* info, int32_t* scf,
    uint16_t* ip, uint8_t* scf_main, int32_t* srows, uint8_t* sdata,
    int32_t* hrows, uint8_t* hmask, uint8_t* md, int64_t md_stride,
    int32_t* meta, int64_t cap_gch, int32_t* out_hdr) {
  const size_t audio_end = find_audio_end(data, len);
  size_t pos = skip_id3v2(data, len);

  std::vector<uint8_t> reservoir;
  reservoir.reserve(1 << 16);

  int64_t n_gch = 0;
  int64_t frame_idx = 0;
  int64_t ns = 0, nh = 0;
  int32_t prev_scf[2][kScfSlots] = {};
  int32_t scfbuf[kScfSlots];

  while (pos + 4 <= audio_end) {
    FrameHeader h;
    if (!parse_header(data + pos, len - pos, &h)) {
      ++pos;
      continue;
    }
    const size_t next_pos = pos + h.frame_size;
    bool valid_frame;
    if (next_pos + 2 <= audio_end) {
      valid_frame = data[next_pos] == 0xFF && (data[next_pos + 1] & 0xE0) == 0xE0;
    } else {
      valid_frame = next_pos <= audio_end;
    }
    if (!valid_frame) {
      ++pos;
      continue;
    }
    if (is_xing_frame(data, len, pos, h)) {
      pos = next_pos;
      continue;
    }

    SideInfo si;
    parse_side_info(data + pos + h.side_info_offset(), h, &si);

    const size_t md_start = pos + h.side_info_offset() + h.side_info_len();
    const size_t md_end = next_pos < audio_end ? next_pos : audio_end;
    const size_t prev_size = reservoir.size();
    if (md_end > md_start) {
      reservoir.insert(reservoir.end(), data + md_start, data + md_end);
    }

    const bool reservoir_ok =
        static_cast<size_t>(si.main_data_begin) <= prev_size;
    size_t gr_bit =
        reservoir_ok ? (prev_size - si.main_data_begin) * 8 : 0;

    const int nch = h.channel_count();
    for (int g = 0; g < h.granule_count(); ++g) {
      for (int ch = 0; ch < nch; ++ch) {
        GranuleInfo gi = si.gr[g][ch];
        const int64_t rec = n_gch++;
        if (rec >= cap_gch) continue;

        int32_t* rinfo = info ? info + rec * GCH_INFO_N : nullptr;
        int32_t* rscf = scf ? scf + rec * kScfSlots : scfbuf;
        int32_t* rmeta = meta + rec * LIGHT_META_N;
        uint8_t* rmd = md + rec * md_stride;
        if (rinfo) memset(rinfo, 0, GCH_INFO_N * sizeof(int32_t));
        memset(rscf, 0, kScfSlots * sizeof(int32_t));
        memset(rmeta, 0, LIGHT_META_N * sizeof(int32_t));

        int intensity_scale = 0;
        bool ok = reservoir_ok;
        if (ok) {
          BitReader br{reservoir.data(), reservoir.size(), gr_bit};
          const size_t end_bit = gr_bit + gi.part2_3_length;
          if (!h.lsf()) {
            read_scalefactors_mpeg1(&br, gi, si.scfsi[ch], g == 1,
                                    prev_scf[ch], rscf);
          } else {
            const bool intensity_ch =
                ch == 1 && h.channel_mode == 1 && (h.mode_extension & 1);
            read_scalefactors_lsf(&br, &gi, intensity_ch, &intensity_scale,
                                  rscf);
          }
          ok = !br.overrun && br.bit <= end_bit;
          if (ok && gi.part2_3_length > 0) {
            // Copy the part3 window (byte-aligned) + 8 real pad bytes.
            const size_t start_byte = br.bit >> 3;
            const size_t p0 = br.bit & 7;
            const size_t p23 = end_bit - br.bit;
            size_t nbytes = (p0 + p23 + 7) / 8 + 8;
            if (static_cast<int64_t>(nbytes) > md_stride) {
              nbytes = static_cast<size_t>(md_stride);
            }
            size_t avail = reservoir.size() > start_byte
                               ? reservoir.size() - start_byte
                               : 0;
            const size_t ncopy = avail < nbytes ? avail : nbytes;
            memcpy(rmd, reservoir.data() + start_byte, ncopy);
            // The packer (mg_entropy_pack3) reads at most
            // ceil((p0 + p23 + 95)/32) words <= nbytes + 8 bytes of this
            // row; zero just past the copied extent instead of the whole
            // 528-byte stride (the tail memset was the bulk of the md
            // write traffic on typical 1-2 KB windows).
            size_t zend = nbytes + 8;
            if (zend > static_cast<size_t>(md_stride)) {
              zend = static_cast<size_t>(md_stride);
            }
            if (zend > ncopy) memset(rmd + ncopy, 0, zend - ncopy);
            rmeta[LM_P0] = static_cast<int32_t>(p0);
            rmeta[LM_P23] = static_cast<int32_t>(p23);

            // Region pair bounds + table groups (decode_spectrum logic).
            const uint8_t* bl = kBandSizeLong[h.sr_row()];
            int long_index[23];
            long_index[0] = 0;
            for (int i = 0; i < 22; ++i) {
              long_index[i + 1] = long_index[i] + bl[i];
            }
            int region1_start, region2_start;
            if (gi.window_switching && gi.block_type == 2) {
              const uint8_t* bs = kBandSizeShort[h.sr_row()];
              region1_start = 3 * (bs[0] + bs[1] + bs[2]);
              region2_start = 576;
            } else if (gi.window_switching) {
              region1_start = long_index[8];
              region2_start = 576;
            } else {
              const int r0 =
                  gi.region0_count + 1 < 23 ? gi.region0_count + 1 : 22;
              int r1 = gi.region0_count + gi.region1_count + 2;
              if (r1 > 22) r1 = 22;
              region1_start = long_index[r0];
              region2_start = long_index[r1];
            }
            int big_pairs = gi.big_values;
            if (big_pairs > 288) big_pairs = 288;
            rmeta[LM_BVP] = big_pairs;
            rmeta[LM_R0P] = (region1_start + 1) / 2;
            rmeta[LM_R1P] = (region2_start + 1) / 2;
            for (int r = 0; r < 3; ++r) {
              const int tsel = gi.table_select[r];
              rmeta[LM_G0 + r] = table_group(kHuffSelect[tsel].table_id);
              rmeta[LM_L0 + r] = kHuffSelect[tsel].linbits;
            }
            rmeta[LM_GCNT] = gi.count1table_select ? 17 : 16;
          } else if (ok) {
            // Zero meta -> the packer reads at most 2 words of this row.
            memset(rmd, 0, 16);
          }
          gr_bit += gi.part2_3_length;
          if (!h.lsf()) {
            memcpy(prev_scf[ch], rscf, kScfSlots * sizeof(int32_t));
          }
        }
        if (!ok) {
          memset(rscf, 0, kScfSlots * sizeof(int32_t));
          memset(rmd, 0, 16);
        }

        if (rinfo) {
          rinfo[GCH_FRAME] = static_cast<int32_t>(frame_idx);
          rinfo[GCH_GRANULE] = g;
          rinfo[GCH_CHANNEL] = ch;
          rinfo[GCH_GLOBAL_GAIN] = gi.global_gain;
          rinfo[GCH_SCALEFAC_SCALE] = gi.scalefac_scale;
          rinfo[GCH_PREFLAG] = gi.preflag;
          rinfo[GCH_BLOCK_TYPE] = gi.window_switching ? gi.block_type : 0;
          rinfo[GCH_MIXED] = gi.mixed_block_flag;
          rinfo[GCH_SBG0] = gi.subblock_gain[0];
          rinfo[GCH_SBG1] = gi.subblock_gain[1];
          rinfo[GCH_SBG2] = gi.subblock_gain[2];
          rinfo[GCH_VERSION] = h.version;
          rinfo[GCH_SR_ROW] = h.sr_row();
          rinfo[GCH_CHANNEL_MODE] = h.channel_mode;
          rinfo[GCH_MODE_EXT] = h.mode_extension;
          rinfo[GCH_SAMPLE_RATE] = static_cast<int32_t>(h.sample_rate);
          // BIG_END / COUNT1_END come from the device entropy kernel.
          rinfo[GCH_VALID] = ok ? 1 : 0;
          rinfo[GCH_INTENSITY_SCALE] = intensity_scale;
          rinfo[GCH_NCHANNELS] = nch;
        }
        if (ip) {
          // frontend.pack_info_light layout (keep in sync).
          const int bt = gi.window_switching ? gi.block_type : 0;
          ip[rec * 2 + 0] = static_cast<uint16_t>(
              (gi.global_gain & 255) | ((bt & 3) << 8) |
              ((gi.mixed_block_flag & 1) << 10) |
              ((gi.scalefac_scale & 1) << 11) | ((gi.preflag & 1) << 12) |
              ((intensity_scale & 1) << 13) |
              ((h.channel_mode == 1 ? 1 : 0) << 14) |
              ((h.lsf() ? 1 : 0) << 15));
          ip[rec * 2 + 1] = static_cast<uint16_t>(
              (gi.subblock_gain[0] & 7) | ((gi.subblock_gain[1] & 7) << 3) |
              ((gi.subblock_gain[2] & 7) << 6) |
              ((h.mode_extension & 3) << 9) | ((h.sr_row() & 15) << 11));
          // frontend.pack_scf_rows layout (keep in sync).
          uint32_t any_short = 0, any_hi = 0;
          for (int s = 0; s < kScfSlots; ++s) {
            const uint32_t v = static_cast<uint32_t>(rscf[s]);
            any_hi |= v >> 4;
            if (s >= 24) any_short |= v & 15u;
          }
          uint8_t* m = scf_main + rec * 12;
          for (int j = 0; j < 12; ++j)
            m[j] = static_cast<uint8_t>(((rscf[2 * j] & 15) << 4) |
                                        (rscf[2 * j + 1] & 15));
          if (any_short) {
            srows[ns] = static_cast<int32_t>(rec);
            uint8_t* d = sdata + ns * 20;
            for (int j = 0; j < 20; ++j)
              d[j] = static_cast<uint8_t>(((rscf[24 + 2 * j] & 15) << 4) |
                                          (rscf[24 + 2 * j + 1] & 15));
            ++ns;
          }
          if (any_hi) {
            hrows[nh] = static_cast<int32_t>(rec);
            uint8_t* hm = hmask + nh * 8;
            for (int b = 0; b < 8; ++b) {
              uint8_t bitsv = 0;
              for (int i = 0; i < 8; ++i)
                bitsv |= static_cast<uint8_t>(
                    (rscf[b * 8 + i] >= 16) ? (1u << i) : 0u);
              hm[b] = bitsv;
            }
            ++nh;
          }
        }
        if (out_hdr && rec == 0) {
          out_hdr[0] = static_cast<int32_t>(h.sample_rate);
          out_hdr[1] = nch;
        }
      }
    }

    if (reservoir.size() > (1u << 16)) {
      const size_t drop = reservoir.size() - (1u << 15);
      reservoir.erase(reservoir.begin(), reservoir.begin() + drop);
      gr_bit = gr_bit > drop * 8 ? gr_bit - drop * 8 : 0;
    }

    ++frame_idx;
    pos = next_pos;
  }
  if (out_hdr) {
    out_hdr[2] = static_cast<int32_t>(ns);
    out_hdr[3] = static_cast<int32_t>(nh);
  }
  return n_gch;
}

int64_t mg_mp3_unpack_light(const uint8_t* data, size_t len, int32_t* info,
                            int32_t* scf, uint8_t* md, int64_t md_stride,
                            int32_t* meta, int64_t cap_gch) {
  return unpack_light_impl(data, len, info, scf, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, md, md_stride, meta,
                           cap_gch, nullptr);
}

// Exact granule-channel count: the same frame-acceptance walk as
// unpack_light_impl (resync validation, Xing skip, audio_end bound)
// without any parsing or stores. Lets callers allocate exact-size
// manifest buffers — the len/40 worst-case guess over-allocated ~4x on
// typical 192 kbps content, and a 64-track wave of those fresh multi-MB
// mmaps was the dominant walk cost on page-fault-slow hosts.
int64_t mg_mp3_count_gch(const uint8_t* data, size_t len) {
  const size_t audio_end = find_audio_end(data, len);
  size_t pos = skip_id3v2(data, len);
  int64_t n = 0;
  while (pos + 4 <= audio_end) {
    FrameHeader h;
    if (!parse_header(data + pos, len - pos, &h)) {
      ++pos;
      continue;
    }
    const size_t next_pos = pos + h.frame_size;
    bool valid_frame;
    if (next_pos + 2 <= audio_end) {
      valid_frame =
          data[next_pos] == 0xFF && (data[next_pos + 1] & 0xE0) == 0xE0;
    } else {
      valid_frame = next_pos <= audio_end;
    }
    if (!valid_frame) {
      ++pos;
      continue;
    }
    if (is_xing_frame(data, len, pos, h)) {
      pos = next_pos;
      continue;
    }
    n += h.granule_count() * h.channel_count();
    pos = next_pos;
  }
  return n;
}

// Packed-emission light walk: ip (cap,2) u16, scf_main (cap,12) u8,
// srows/sdata + hrows/hmask sidebands (capacity cap rows each), md/meta
// as in mg_mp3_unpack_light. out_hdr receives [sample_rate, n_channels,
// n_short_rows, n_hi_rows].
int64_t mg_mp3_unpack_light2(const uint8_t* data, size_t len, uint16_t* ip,
                             uint8_t* scf_main, int32_t* srows,
                             uint8_t* sdata, int32_t* hrows, uint8_t* hmask,
                             uint8_t* md, int64_t md_stride, int32_t* meta,
                             int64_t cap_gch, int32_t* out_hdr) {
  return unpack_light_impl(data, len, nullptr, nullptr, ip, scf_main, srows,
                           sdata, hrows, hmask, md, md_stride, meta, cap_gch,
                           out_hdr);
}

// Pack light-unpacked granule-channels into the entropy kernel's device
// layout in one pass. The stream buffer is ragged at SUBGROUP
// granularity: each block of `lanes` sorted granule-channels is split
// into lanes/subg contiguous subgroups of `subg` lanes, and subgroup
// (b, s)'s words live at flat word-group offset sg_off[b*nsg + s]
// (units of one (8, subg) int32 group) in a packed (g_pad, 8, subg)
// big-endian word buffer, with sg_w8[b*nsg + s] groups of capacity —
// per-subgroup instead of per-block, so the device payload tracks the
// true bitstream size of each 128-lane span of the sorted order (the
// kernel re-assembles a block's scratch from nsg independent DMAs).
// Three transfer-size/time refinements carried over from the earlier
// per-block packer:
//   - per-LANE word counts: only ceil((p0 + p23 + 95)/32) words of a
//     lane's window are copied (the kernel's extract never reads further
//     — max legal read is 28 bits past pend, inside the 64-bit slack);
//     the remainder of the lane's column is zeroed, so capacity padding
//     costs sequential stores, not strided copies;
//   - k-outer transpose: for each word index k the whole (subg,) row is
//     written contiguously while source rows stay hot in L2;
//   - metadata ships bit-packed: 5 uint16 rows per lane (layout below,
//     mirrored by entropy_kernel.Half) instead of 12+ full rows.
// md_rows / meta_rows are per-ROW base pointers (uint64), so callers
// never concatenate per-track arrays. order[r] >= n marks padding.
//
// Packed meta layout (entropy_kernel.py META_ROWS = 5 must match):
//   w0: part3 bits p23[0:12] | lead bits p0[12:15] | count1 table[15]
//   w1: big-value pairs bvp[0:9]  | region0 table group g0[9:13]
//   w2: region pair bound r0p[0:9] | region1 table group g1[9:13]
//   w3: region pair bound r1p[0:9] | region2 table group g2[9:13]
//   w4: linbits l0[0:4] | l1[4:8] | l2[8:12]
void mg_entropy_pack4(const uint64_t* md_rows, const uint64_t* meta_rows,
                      int64_t n, int64_t meta_n, const int32_t* order,
                      int64_t npad, int64_t lanes, int64_t subg,
                      const int32_t* sg_off, const int32_t* sg_w8,
                      int64_t md_stride, int64_t meta_rows_out,
                      int32_t* buf, uint16_t* metab) {
  const int64_t nwords_src = md_stride / 4;
  const int64_t meta_stride = meta_rows_out * lanes;
  const int64_t nb = npad / lanes;
  const int64_t nsg = lanes / subg;
  std::vector<const uint32_t*> rowp(static_cast<size_t>(subg));
  std::vector<int32_t> rown(static_cast<size_t>(subg));
  for (int64_t b = 0; b < nb; ++b) {
    uint16_t* mb = metab + b * meta_stride;
    for (int64_t s = 0; s < nsg; ++s) {
      const int64_t sg = b * nsg + s;
      const int64_t words = sg_w8[sg] * 8;
      int32_t* bb = buf + static_cast<int64_t>(sg_off[sg]) * 8 * subg;
      for (int64_t li = 0; li < subg; ++li) {
        const int64_t l = s * subg + li;
        const int64_t src = order[b * lanes + l];
        if (src < n) {
          rowp[li] = reinterpret_cast<const uint32_t*>(md_rows[src]);
          const int32_t* m =
              reinterpret_cast<const int32_t*>(meta_rows[src]);
          // Lane's true word extent: window bits + 64-bit overreach
          // slack.
          int64_t nw =
              (static_cast<int64_t>(m[LM_P0]) + m[LM_P23] + 95) >> 5;
          if (nw > words) nw = words;
          if (nw > nwords_src) nw = nwords_src;
          rown[li] = static_cast<int32_t>(nw);
          mb[0 * lanes + l] = static_cast<uint16_t>(
              (m[LM_P23] & 0xFFF) | ((m[LM_P0] & 7) << 12) |
              ((m[LM_GCNT] & 1) << 15));
          mb[1 * lanes + l] = static_cast<uint16_t>(
              (m[LM_BVP] & 511) | ((m[LM_G0] & 15) << 9));
          mb[2 * lanes + l] = static_cast<uint16_t>(
              (m[LM_R0P] & 511) | ((m[LM_G1] & 15) << 9));
          mb[3 * lanes + l] = static_cast<uint16_t>(
              (m[LM_R1P] & 511) | ((m[LM_G2] & 15) << 9));
          mb[4 * lanes + l] = static_cast<uint16_t>(
              (m[LM_L0] & 15) | ((m[LM_L1] & 15) << 4) |
              ((m[LM_L2] & 15) << 8));
        } else {
          rowp[li] = nullptr;
          rown[li] = 0;
          for (int64_t j = 0; j < meta_rows_out; ++j)
            mb[j * lanes + l] = 0;
        }
      }
      (void)meta_n;
      // Split the word range at the subgroup's min extent: below it
      // every lane is active (branch-free gather+bswap the compiler
      // can vectorize), above it the per-lane mask applies. Lanes are
      // sorted by window bits within the subgroup, so min tracks the
      // mean closely and most iterations take the branch-free form.
      int32_t min_rown = rown[0];
      for (int64_t li = 1; li < subg; ++li) {
        if (rown[li] < min_rown) min_rown = rown[li];
      }
      int64_t k = 0;
      for (; k < min_rown; ++k) {
        int32_t* out = bb + k * subg;
        for (int64_t li = 0; li < subg; ++li) {
          uint32_t w;
          memcpy(&w, rowp[li] + k, 4);
          out[li] = static_cast<int32_t>(__builtin_bswap32(w));
        }
      }
      for (; k < words; ++k) {
        int32_t* out = bb + k * subg;
        for (int64_t li = 0; li < subg; ++li) {
          if (k < rown[li]) {
            uint32_t w;
            memcpy(&w, rowp[li] + k, 4);
            out[li] = static_cast<int32_t>(__builtin_bswap32(w));
          } else {
            out[li] = 0;
          }
        }
      }
    }
  }
}

// Stable counting sort of the entropy batch's lane order by
// (est_steps, window_bits) — the exact key np.lexsort((bits, est)) used
// (lexsort measured ~95 ms on a 786k-lane batch, ~30% of the whole host
// prep; this is O(n) with a ~1.2M-bucket count array). est <= 288
// (entropy_kernel.MAX_STEPS), bits = p0 + p23 <= 7 + 4095; both are
// clamped for safety. Emits order (sorted -> source index) and inv
// (source -> sorted position).
void mg_sort_est_bits(const int32_t* est, const int64_t* bits, int64_t n,
                      int32_t* order, int32_t* inv) {
  constexpr int64_t kBitsRange = 4104;  // max bits 4103 (+1)
  constexpr int64_t kEstMax = 288;
  constexpr int64_t kKeys = (kEstMax + 1) * kBitsRange;
  std::vector<int32_t> count(static_cast<size_t>(kKeys) + 1, 0);
  std::vector<int32_t> key(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    int64_t e = est[i];
    if (e < 0) e = 0;
    if (e > kEstMax) e = kEstMax;
    int64_t b = bits[i];
    if (b < 0) b = 0;
    if (b >= kBitsRange) b = kBitsRange - 1;
    const int32_t k = static_cast<int32_t>(e * kBitsRange + b);
    key[static_cast<size_t>(i)] = k;
    ++count[static_cast<size_t>(k) + 1];
  }
  for (size_t k = 1; k <= static_cast<size_t>(kKeys); ++k)
    count[k] += count[k - 1];
  for (int64_t i = 0; i < n; ++i) {
    const int32_t pos = count[static_cast<size_t>(
        key[static_cast<size_t>(i)])]++;
    order[pos] = static_cast<int32_t>(i);
    inv[i] = pos;
  }
}

// Dense -> transfer-packed conversion for one track's light manifest:
// the bit-packed info words (frontend.pack_info_light layout) and the
// split scalefactor form (frontend.pack_scf_rows: 12-byte low-nibble
// main rows + sparse short-window / high-bit sidebands). The Python
// per-track fills this replaces cost ~160 ms per 64x60s batch (~45% of
// host prep) in small numpy ops. srows/hrows receive row_offset-based
// (global) indices; caller provides capacity-n sideband buffers and
// reads back *ns/*nh. Returns 0, or -1 if any scalefactor slot exceeds
// 5 bits (the Python path raises ValueError).
int32_t mg_pack_light_track(const int32_t* info, const int32_t* scf,
                            int64_t n, uint16_t* ip_out, uint8_t* scf_main,
                            int32_t* srows, uint8_t* sdata, int32_t* hrows,
                            uint8_t* hmask, int64_t row_offset,
                            int64_t* ns_out, int64_t* nh_out) {
  int64_t ns = 0, nh = 0;
  for (int64_t r = 0; r < n; ++r) {
    const int32_t* ri = info + r * GCH_INFO_N;
    ip_out[r * 2 + 0] = static_cast<uint16_t>(
        (ri[GCH_GLOBAL_GAIN] & 255) | ((ri[GCH_BLOCK_TYPE] & 3) << 8) |
        ((ri[GCH_MIXED] & 1) << 10) | ((ri[GCH_SCALEFAC_SCALE] & 1) << 11) |
        ((ri[GCH_PREFLAG] & 1) << 12) |
        ((ri[GCH_INTENSITY_SCALE] & 1) << 13) |
        ((ri[GCH_CHANNEL_MODE] == 1 ? 1 : 0) << 14) |
        ((ri[GCH_VERSION] != 1 ? 1 : 0) << 15));
    ip_out[r * 2 + 1] = static_cast<uint16_t>(
        (ri[GCH_SBG0] & 7) | ((ri[GCH_SBG1] & 7) << 3) |
        ((ri[GCH_SBG2] & 7) << 6) | ((ri[GCH_MODE_EXT] & 3) << 9) |
        ((ri[GCH_SR_ROW] & 15) << 11));

    const int32_t* rs = scf + r * 64;
    uint32_t any_short = 0, any_hi = 0, bad = 0;
    for (int64_t s = 0; s < 64; ++s) {
      const uint32_t v = static_cast<uint32_t>(rs[s]);
      bad |= v >> 5;
      any_hi |= v >> 4;
      if (s >= 24) any_short |= v & 15u;
    }
    if (bad) return -1;
    uint8_t* m = scf_main + r * 12;
    for (int64_t j = 0; j < 12; ++j)
      m[j] = static_cast<uint8_t>(((rs[2 * j] & 15) << 4) |
                                  (rs[2 * j + 1] & 15));
    if (any_short) {
      srows[ns] = static_cast<int32_t>(row_offset + r);
      uint8_t* d = sdata + ns * 20;
      for (int64_t j = 0; j < 20; ++j)
        d[j] = static_cast<uint8_t>(((rs[24 + 2 * j] & 15) << 4) |
                                    (rs[24 + 2 * j + 1] & 15));
      ++ns;
    }
    if (any_hi) {
      hrows[nh] = static_cast<int32_t>(row_offset + r);
      uint8_t* hm = hmask + nh * 8;
      for (int64_t b = 0; b < 8; ++b) {
        uint8_t bitsv = 0;
        for (int64_t i = 0; i < 8; ++i)
          bitsv |= static_cast<uint8_t>((rs[b * 8 + i] >= 16) ? (1u << i)
                                                              : 0u);
        hm[b] = bitsv;
      }
      ++nh;
    }
  }
  *ns_out = ns;
  *nh_out = nh;
  return 0;
}

}  // extern "C"
