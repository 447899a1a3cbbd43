// L0 bitstream core: MP3 frame sync, header parse, and lossless global_gain
// surgery inside Layer III side information.
//
// Behavioral contract mirrors the reference (file:line cites refer to
// the reference Rust mp3rgain's src/lib.rs; this file is the torch
// port's copy of mp3rgain_tpu/_native/bitstream.cpp):
//   - header parse / tables        lib.rs:153-252
//   - gain bit locations           lib.rs:262-298
//   - unaligned bit read/write     lib.rs:301-340
//   - ID3v2 skip / audio end       lib.rs:343-383
//   - Xing/Info frame skip         lib.rs:388-408
//   - resync frame iteration       lib.rs:412-461
//   - saturating/wrapping adjust   lib.rs:526-540
//   - channel-specific apply       lib.rs:677-734

#include "native.h"

#include <cstring>

namespace {

constexpr uint32_t kBitrateMpeg1[15] = {0,  32,  40,  48,  56,  64,  80, 96,
                                        112, 128, 160, 192, 224, 256, 320};
constexpr uint32_t kBitrateMpeg2[15] = {0,  8,  16, 24, 32,  40,  48, 56,
                                        64, 80, 96, 112, 128, 144, 160};
// [version_index][sr_index]; version_index 0=MPEG1, 1=MPEG2, 2=MPEG2.5.
constexpr uint32_t kSampleRate[3][3] = {{44100, 48000, 32000},
                                        {22050, 24000, 16000},
                                        {11025, 12000, 8000}};

struct FrameHeader {
  int version;  // 1, 2, 25
  bool has_crc;
  uint32_t bitrate_kbps;
  uint32_t sample_rate;
  bool padding;
  int channel_mode;  // 0 stereo, 1 joint, 2 dual, 3 mono
  size_t frame_size;

  int granule_count() const { return version == 1 ? 2 : 1; }
  int channel_count() const { return channel_mode == 3 ? 1 : 2; }
  size_t side_info_offset() const { return has_crc ? 6 : 4; }
};

// Parse a 4-byte frame header; returns false if not a valid Layer III header.
bool parse_header(const uint8_t* p, size_t avail, FrameHeader* h) {
  if (avail < 4) return false;
  if (p[0] != 0xFF || (p[1] & 0xE0) != 0xE0) return false;

  const int version_bits = (p[1] >> 3) & 0x03;
  switch (version_bits) {
    case 0b00: h->version = 25; break;
    case 0b10: h->version = 2; break;
    case 0b11: h->version = 1; break;
    default: return false;  // 0b01 reserved
  }

  if (((p[1] >> 1) & 0x03) != 0b01) return false;  // Layer III only
  h->has_crc = (p[1] & 0x01) == 0;

  const int bitrate_index = (p[2] >> 4) & 0x0F;
  if (bitrate_index == 0 || bitrate_index == 15) return false;
  h->bitrate_kbps = (h->version == 1) ? kBitrateMpeg1[bitrate_index]
                                      : kBitrateMpeg2[bitrate_index];

  const int sr_index = (p[2] >> 2) & 0x03;
  if (sr_index == 3) return false;
  const int vi = (h->version == 1) ? 0 : (h->version == 2 ? 1 : 2);
  h->sample_rate = kSampleRate[vi][sr_index];

  h->padding = (p[2] & 0x02) != 0;
  h->channel_mode = (p[3] >> 6) & 0x03;

  const size_t samples = (h->version == 1) ? 1152 : 576;
  h->frame_size = (samples * h->bitrate_kbps * 125) / h->sample_rate +
                  (h->padding ? 1 : 0);
  return true;
}

struct GainLocation {
  size_t byte_offset;
  uint8_t bit_offset;
};

// Bit-exact positions of each granule/channel global_gain (lib.rs:262-298).
// Writes up to 4 locations; returns the count (granules * channels).
int gain_locations(size_t frame_offset, const FrameHeader& h,
                   GainLocation out[4]) {
  const size_t side_info_start = frame_offset + h.side_info_offset();
  const int nch = h.channel_count();
  const int ngr = h.granule_count();
  const int bits_before =
      (h.version == 1) ? (nch == 1 ? 18 : 20) : (nch == 1 ? 9 : 10);
  const int bits_per = (h.version == 1) ? 59 : 63;

  int n = 0;
  for (int gr = 0; gr < ngr; ++gr) {
    for (int ch = 0; ch < nch; ++ch) {
      const int granule_start_bit = bits_before + (gr * nch + ch) * bits_per;
      const int global_gain_bit = granule_start_bit + 21;
      out[n].byte_offset = side_info_start + global_gain_bit / 8;
      out[n].bit_offset = static_cast<uint8_t>(global_gain_bit % 8);
      ++n;
    }
  }
  return n;
}

// Read 8 bits at an arbitrary bit offset, spanning <= 2 bytes (lib.rs:301-317).
uint8_t read_gain_at(const uint8_t* data, size_t len, const GainLocation& loc) {
  const size_t idx = loc.byte_offset;
  if (idx >= len) return 0;
  if (loc.bit_offset == 0) return data[idx];
  if (idx + 1 < len) {
    const int shift = loc.bit_offset;
    const uint8_t high = static_cast<uint8_t>(data[idx] << shift);
    const uint8_t low = static_cast<uint8_t>(data[idx + 1] >> (8 - shift));
    return high | low;
  }
  return static_cast<uint8_t>(data[idx] << loc.bit_offset);
}

// Write 8 bits at an arbitrary bit offset, incl. partial write at EOF
// (lib.rs:320-340).
void write_gain_at(uint8_t* data, size_t len, const GainLocation& loc,
                   uint8_t value) {
  const size_t idx = loc.byte_offset;
  if (idx >= len) return;
  if (loc.bit_offset == 0) {
    data[idx] = value;
  } else if (idx + 1 < len) {
    const int shift = loc.bit_offset;
    const uint8_t mask_high = static_cast<uint8_t>(0xFF << (8 - shift));
    const uint8_t mask_low = static_cast<uint8_t>(0xFF >> shift);
    data[idx] = (data[idx] & mask_high) | (value >> shift);
    data[idx + 1] = (data[idx + 1] & mask_low)
                    | static_cast<uint8_t>(value << (8 - shift));
  } else {
    const int shift = loc.bit_offset;
    const uint8_t mask_high = static_cast<uint8_t>(0xFF << (8 - shift));
    data[idx] = (data[idx] & mask_high) | (value >> shift);
  }
}

// Skip a leading ID3v2 tag (syncsafe size; lib.rs:343-354).
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

constexpr uint32_t kApeFlagHeaderPresent = 1u << 31;

// End of audio data before ID3v1 / APEv2 trailers (lib.rs:358-383).
size_t find_audio_end(const uint8_t* data, size_t len) {
  size_t audio_end = len;
  if (audio_end >= 128 &&
      memcmp(data + audio_end - 128, "TAG", 3) == 0) {
    audio_end -= 128;
  }
  if (audio_end >= 32 &&
      memcmp(data + audio_end - 32, "APETAGEX", 8) == 0) {
    const size_t footer_start = audio_end - 32;
    const size_t tag_size = read_u32_le(data + footer_start + 12);
    const uint32_t flags = read_u32_le(data + footer_start + 20);
    const size_t header_size = (flags & kApeFlagHeaderPresent) ? 32 : 0;
    if (footer_start + 32 >= tag_size + header_size) {
      audio_end = footer_start + 32 - tag_size - header_size;
    }
  }
  return audio_end;
}

// Xing/Info VBR header frame detection (lib.rs:388-408).
bool is_xing_frame(const uint8_t* data, size_t len, size_t frame_offset,
                   const FrameHeader& h) {
  size_t side_info_len;
  if (h.version == 1) {
    side_info_len = (h.channel_mode == 3) ? 17 : 32;
  } else {
    side_info_len = (h.channel_mode == 3) ? 9 : 17;
  }
  const size_t xing_offset = frame_offset + h.side_info_offset() + side_info_len;
  if (xing_offset + 4 > len) return false;
  const uint8_t* m = data + xing_offset;
  return memcmp(m, "Xing", 4) == 0 || memcmp(m, "Info", 4) == 0;
}

// Resync-scanning frame walk (lib.rs:412-461). Calls `fn(pos, header, locs,
// nloc)` per audio frame; returns frame count.
template <typename Fn>
int64_t iterate_frames(const uint8_t* data, size_t len, Fn&& fn) {
  const size_t audio_end = find_audio_end(data, len);
  size_t pos = skip_id3v2(data, len);
  int64_t frame_count = 0;

  while (pos + 4 <= audio_end) {
    FrameHeader h;
    if (!parse_header(data + pos, len - pos, &h)) {
      ++pos;
      continue;
    }
    const size_t next_pos = pos + h.frame_size;
    bool valid;
    if (next_pos + 2 <= audio_end) {
      valid = data[next_pos] == 0xFF && (data[next_pos + 1] & 0xE0) == 0xE0;
    } else {
      valid = next_pos <= audio_end;  // last frame
    }
    if (!valid) {
      ++pos;
      continue;
    }
    if (is_xing_frame(data, len, pos, h)) {
      pos = next_pos;
      continue;
    }
    GainLocation locs[4];
    const int nloc = gain_locations(pos, h, locs);
    fn(pos, h, locs, nloc);
    ++frame_count;
    pos = next_pos;
  }
  return frame_count;
}

// Saturating / wrapping gain step arithmetic (lib.rs:526-540).
uint8_t adjust_gain_value(uint8_t current, int32_t steps, int32_t mode) {
  if (mode == 0) {  // saturating
    if (steps > 0) {
      const int32_t add = steps < 255 ? steps : 255;
      const int32_t v = static_cast<int32_t>(current) + add;
      return v > 255 ? 255 : static_cast<uint8_t>(v);
    }
    const int32_t sub = (-steps) < 255 ? -steps : 255;
    const int32_t v = static_cast<int32_t>(current) - sub;
    return v < 0 ? 0 : static_cast<uint8_t>(v);
  }
  // wrapping
  int32_t v = (static_cast<int32_t>(current) + steps) % 256;
  return static_cast<uint8_t>((v + 256) % 256);
}

}  // namespace

extern "C" {

int32_t mg_analyze(const uint8_t* data, size_t len, MgAnalysis* out) {
  uint8_t min_gain = 255, max_gain = 0;
  uint64_t total = 0, count = 0;
  int first_version = 0, first_mode = 0;
  bool have_first = false;

  const int64_t frames = iterate_frames(
      data, len,
      [&](size_t, const FrameHeader& h, const GainLocation* locs, int n) {
        if (!have_first) {
          first_version = h.version;
          first_mode = h.channel_mode;
          have_first = true;
        }
        for (int i = 0; i < n; ++i) {
          const uint8_t g = read_gain_at(data, len, locs[i]);
          if (g < min_gain) min_gain = g;
          if (g > max_gain) max_gain = g;
          total += g;
          ++count;
        }
      });

  if (frames == 0) return -1;
  out->frame_count = frames;
  out->min_gain = min_gain;
  out->max_gain = max_gain;
  out->avg_gain = static_cast<double>(total) / static_cast<double>(count);
  out->mpeg_version = first_version;
  out->channel_mode = first_mode;
  return 0;
}

int64_t mg_apply_gain(uint8_t* data, size_t len, int32_t steps, int32_t mode) {
  return iterate_frames(
      data, len,
      [&](size_t, const FrameHeader&, const GainLocation* locs, int n) {
        for (int i = 0; i < n; ++i) {
          const uint8_t cur = read_gain_at(data, len, locs[i]);
          write_gain_at(data, len, locs[i],
                        adjust_gain_value(cur, steps, mode));
        }
      });
}

int64_t mg_apply_gain_channel(uint8_t* data, size_t len, int32_t channel,
                              int32_t steps) {
  // Locations are ordered [gr0_ch0, gr0_ch1, gr1_ch0, gr1_ch1] (lib.rs:718);
  // only index gr*nch+channel is touched per granule, saturating mode.
  return iterate_frames(
      data, len,
      [&](size_t, const FrameHeader& h, const GainLocation* locs, int n) {
        const int nch = h.channel_count();
        for (int gr = 0; gr < h.granule_count(); ++gr) {
          const int li = gr * nch + channel;
          if (li < n) {
            const uint8_t cur = read_gain_at(data, len, locs[li]);
            write_gain_at(data, len, locs[li],
                          adjust_gain_value(cur, steps, 0));
          }
        }
      });
}

int64_t mg_read_gains(const uint8_t* data, size_t len, uint8_t* gains,
                      int64_t cap) {
  int64_t n = 0;
  iterate_frames(data, len,
                 [&](size_t, const FrameHeader&, const GainLocation* locs,
                     int nloc) {
                   for (int i = 0; i < nloc; ++i) {
                     if (n < cap) gains[n] = read_gain_at(data, len, locs[i]);
                     ++n;
                   }
                 });
  return n <= cap ? n : -n;
}

int64_t mg_frame_index(const uint8_t* data, size_t len, int64_t* out,
                       int64_t cap) {
  int64_t n = 0;
  iterate_frames(data, len,
                 [&](size_t pos, const FrameHeader& h, const GainLocation*,
                     int) {
                   if (n < cap) {
                     uint32_t hdr_word = (static_cast<uint32_t>(data[pos]) << 24) |
                                         (static_cast<uint32_t>(data[pos + 1]) << 16) |
                                         (static_cast<uint32_t>(data[pos + 2]) << 8) |
                                         static_cast<uint32_t>(data[pos + 3]);
                     out[n * 3 + 0] = static_cast<int64_t>(pos);
                     out[n * 3 + 1] = static_cast<int64_t>(h.frame_size);
                     out[n * 3 + 2] = static_cast<int64_t>(hdr_word);
                   }
                   ++n;
                 });
  return n <= cap ? n : -n;
}

int64_t mg_find_audio_end(const uint8_t* data, size_t len) {
  return static_cast<int64_t>(find_audio_end(data, len));
}

uint8_t mg_read_bits8(const uint8_t* data, size_t len, size_t byte_offset,
                      uint8_t bit_offset) {
  const GainLocation loc{byte_offset, bit_offset};
  return read_gain_at(data, len, loc);
}

void mg_write_bits8(uint8_t* data, size_t len, size_t byte_offset,
                    uint8_t bit_offset, uint8_t value) {
  const GainLocation loc{byte_offset, bit_offset};
  write_gain_at(data, len, loc, value);
}

}  // extern "C"
