// APEv2 tag engine: parse / serialize / removal layout for APEv2 2000 tags
// at end-of-file, coexisting with trailing ID3v1.
//
// The torch port's copy of mp3rgain_tpu/_native/ape.cpp (code lines held
// equal by tests/test_torch_host_copies.py). Behavioral contract mirrors
// the reference Rust mp3rgain (src/lib.rs):
//   - footer search                lib.rs:944-966
//   - tag parse                    lib.rs:974-1027
//   - tag serialize                lib.rs:1037-1085
//   - removal layout               lib.rs:1088-1119

#include "native.h"

#include <cstring>

namespace {

constexpr uint32_t kApeVersion = 2000;
constexpr uint32_t kFlagHeaderPresent = 1u << 31;
constexpr uint32_t kFlagIsHeader = 1u << 29;

uint32_t read_u32_le(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

void write_u32_le(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

}  // namespace

extern "C" {

int64_t mg_ape_find_footer(const uint8_t* data, size_t len) {
  if (len < 32) return -1;
  size_t footer_start = len - 32;
  if (memcmp(data + footer_start, "APETAGEX", 8) == 0) {
    return static_cast<int64_t>(footer_start);
  }
  if (len >= 160) {
    footer_start = len - 32 - 128;
    if (memcmp(data + footer_start, "APETAGEX", 8) == 0 &&
        memcmp(data + len - 128, "TAG", 3) == 0) {
      return static_cast<int64_t>(footer_start);
    }
  }
  return -1;
}

int64_t mg_ape_parse(const uint8_t* data, size_t len, uint8_t* out,
                     int64_t cap, int64_t* item_count) {
  *item_count = 0;
  const int64_t footer = mg_ape_find_footer(data, len);
  if (footer < 0) return -1;
  const size_t footer_start = static_cast<size_t>(footer);

  if (read_u32_le(data + footer_start + 8) != kApeVersion) return -1;
  const size_t tag_size = read_u32_le(data + footer_start + 12);
  const size_t n_items = read_u32_le(data + footer_start + 16);
  if (footer_start + 32 < tag_size) return -1;
  const size_t items_start = footer_start + 32 - tag_size;

  int64_t written = 0;
  size_t pos = items_start;
  for (size_t i = 0; i < n_items; ++i) {
    if (pos + 8 > footer_start) break;
    const size_t value_size = read_u32_le(data + pos);
    pos += 8;  // value_size + item flags
    const size_t key_start = pos;
    while (pos < footer_start && data[pos] != 0) ++pos;
    if (pos >= footer_start) break;
    const size_t key_len = pos - key_start;
    ++pos;  // null terminator
    if (pos + value_size > footer_start) break;

    const int64_t rec = 8 + static_cast<int64_t>(key_len + value_size);
    if (written + rec <= cap) {
      uint8_t* p = out + written;
      write_u32_le(p, static_cast<uint32_t>(key_len));
      write_u32_le(p + 4, static_cast<uint32_t>(value_size));
      memcpy(p + 8, data + key_start, key_len);
      memcpy(p + 8 + key_len, data + pos, value_size);
    }
    written += rec;
    pos += value_size;
    ++(*item_count);
  }
  return written <= cap ? written : -written;
}

int64_t mg_ape_serialize(const uint8_t* items, size_t items_len,
                         int64_t item_count, uint8_t* out, int64_t cap) {
  if (item_count == 0) return 0;

  // First pass: compute serialized items size.
  size_t pos = 0;
  size_t items_data_len = 0;
  for (int64_t i = 0; i < item_count; ++i) {
    if (pos + 8 > items_len) return -1;
    const size_t key_len = read_u32_le(items + pos);
    const size_t value_len = read_u32_le(items + pos + 4);
    pos += 8 + key_len + value_len;
    if (pos > items_len) return -1;
    items_data_len += 4 + 4 + key_len + 1 + value_len;
  }

  const size_t tag_size = items_data_len + 32;  // items + footer
  const int64_t total = static_cast<int64_t>(32 + items_data_len + 32);
  if (total > cap) return -total;

  uint8_t* p = out;
  // Header (flags: header-present | is-header).
  memcpy(p, "APETAGEX", 8);
  write_u32_le(p + 8, kApeVersion);
  write_u32_le(p + 12, static_cast<uint32_t>(tag_size));
  write_u32_le(p + 16, static_cast<uint32_t>(item_count));
  write_u32_le(p + 20, kFlagHeaderPresent | kFlagIsHeader);
  memset(p + 24, 0, 8);
  p += 32;

  // Items: u32le value_size, u32le flags(0), key, NUL, value.
  pos = 0;
  for (int64_t i = 0; i < item_count; ++i) {
    const size_t key_len = read_u32_le(items + pos);
    const size_t value_len = read_u32_le(items + pos + 4);
    const uint8_t* key = items + pos + 8;
    const uint8_t* value = key + key_len;
    write_u32_le(p, static_cast<uint32_t>(value_len));
    write_u32_le(p + 4, 0);
    memcpy(p + 8, key, key_len);
    p[8 + key_len] = 0;
    memcpy(p + 9 + key_len, value, value_len);
    p += 9 + key_len + value_len;
    pos += 8 + key_len + value_len;
  }

  // Footer (flags: header-present).
  memcpy(p, "APETAGEX", 8);
  write_u32_le(p + 8, kApeVersion);
  write_u32_le(p + 12, static_cast<uint32_t>(tag_size));
  write_u32_le(p + 16, static_cast<uint32_t>(item_count));
  write_u32_le(p + 20, kFlagHeaderPresent);
  memset(p + 24, 0, 8);
  return total;
}

int32_t mg_ape_remove_region(const uint8_t* data, size_t len,
                             int64_t* audio_end, int64_t* tail_start) {
  *audio_end = static_cast<int64_t>(len);
  *tail_start = -1;
  const int64_t footer = mg_ape_find_footer(data, len);
  if (footer < 0) return -1;
  const size_t footer_start = static_cast<size_t>(footer);

  const size_t tag_size = read_u32_le(data + footer_start + 12);
  const uint32_t flags = read_u32_le(data + footer_start + 20);
  const size_t header_size = (flags & kFlagHeaderPresent) ? 32 : 0;

  if (footer_start + 32 >= tag_size + header_size) {
    *audio_end = static_cast<int64_t>(footer_start + 32 - tag_size - header_size);
  } else {
    *audio_end = 0;
  }

  const size_t id3v1_start = footer_start + 32;
  if (len > id3v1_start + 3 && memcmp(data + id3v1_start, "TAG", 3) == 0) {
    *tail_start = static_cast<int64_t>(id3v1_start);
  }
  return 0;
}

}  // extern "C"
