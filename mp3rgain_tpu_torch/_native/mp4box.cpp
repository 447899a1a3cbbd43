// The torch port's copy of mp3rgain_tpu/_native/mp4box.cpp; the port builds it with g++ at
// first use (mp3rgain_tpu_torch/native.py). tests/test_torch_host_copies.py
// holds its outputs equal to the original's.
//
// L2 MP4 metadata engine: ISO-BMFF box parsing and iTunes freeform
// ReplayGain tag read/write for M4A/AAC files.
//
// Behavioral contract mirrors the reference Rust mp3rgain (src/mp4meta.rs):
//   - box header / search           mp4meta.rs:52-233
//   - freeform tag parse/serialize  mp4meta.rs:236-330
//   - tag read path                 mp4meta.rs:333-417
//   - metadata rewriter (3 cases)   mp4meta.rs:433-726
//   - box size / chunk offset fix   mp4meta.rs:728-863
//   - ftyp brand sniffing           mp4meta.rs:872-889

#include "native.h"

#include <cstring>
#include <string>
#include <vector>

namespace {

uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

uint64_t be64(const uint8_t* p) {
  return (static_cast<uint64_t>(be32(p)) << 32) | be32(p + 4);
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(static_cast<uint8_t>(x >> 24));
  v.push_back(static_cast<uint8_t>(x >> 16));
  v.push_back(static_cast<uint8_t>(x >> 8));
  v.push_back(static_cast<uint8_t>(x));
}

void put_bytes(std::vector<uint8_t>& v, const void* p, size_t n) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  v.insert(v.end(), b, b + n);
}

uint32_t fourcc(const char* s) {
  return (static_cast<uint32_t>(static_cast<uint8_t>(s[0])) << 24) |
         (static_cast<uint32_t>(static_cast<uint8_t>(s[1])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(s[2])) << 8) |
         static_cast<uint32_t>(static_cast<uint8_t>(s[3]));
}

const uint32_t MOOV = fourcc("moov");
const uint32_t UDTA = fourcc("udta");
const uint32_t META = fourcc("meta");
const uint32_t ILST = fourcc("ilst");
const uint32_t MDAT = fourcc("mdat");
const uint32_t FREEFORM = fourcc("----");
const uint32_t MEAN = fourcc("mean");
const uint32_t NAME = fourcc("name");
const uint32_t DATA = fourcc("data");
const uint32_t STCO = fourcc("stco");
const uint32_t CO64 = fourcc("co64");
const uint32_t TRAK = fourcc("trak");
const uint32_t MDIA = fourcc("mdia");
const uint32_t MINF = fourcc("minf");
const uint32_t STBL = fourcc("stbl");

const char kItunesNamespace[] = "com.apple.iTunes";
const char* kRgNames[4] = {
    "replaygain_track_gain",
    "replaygain_track_peak",
    "replaygain_album_gain",
    "replaygain_album_peak",
};

struct BoxHeader {
  uint64_t size;       // 0 = extends to EOF
  uint32_t box_type;
  uint8_t header_size;  // 8 normal, 16 extended

  uint64_t content_size() const { return size == 0 ? 0 : size - header_size; }
};

// Read a box header at `pos`; returns false at EOF/short read.
bool read_box(const uint8_t* data, size_t len, size_t pos, BoxHeader* h) {
  if (pos + 8 > len) return false;
  uint32_t size32 = be32(data + pos);
  h->box_type = be32(data + pos + 4);
  if (size32 == 1) {
    if (pos + 16 > len) return false;
    h->size = be64(data + pos + 8);
    h->header_size = 16;
  } else {
    h->size = size32;  // 0 = to EOF
    h->header_size = 8;
  }
  return true;
}

// Top-level linear box search (mp4meta.rs:180-203).
bool find_box(const uint8_t* data, size_t len, uint32_t type, size_t* pos_out,
              BoxHeader* h_out) {
  size_t pos = 0;
  BoxHeader h;
  while (read_box(data, len, pos, &h)) {
    if (h.box_type == type) {
      *pos_out = pos;
      *h_out = h;
      return true;
    }
    if (h.size < h.header_size || h.size >= len - pos) break;
    pos += static_cast<size_t>(h.size);
  }
  return false;
}

// Search inside a container's content range (mp4meta.rs:206-233).
bool find_box_in(const uint8_t* data, size_t len, size_t start, size_t size,
                 uint32_t type, size_t* pos_out, BoxHeader* h_out) {
  const size_t end = size < len - start ? start + size : len;
  size_t pos = start;
  BoxHeader h;
  while (pos + 8 <= end && read_box(data, len, pos, &h)) {
    if (h.box_type == type) {
      *pos_out = pos;
      *h_out = h;
      return true;
    }
    // Corrupt sizes (0, < header, or past the container) end the walk.
    if (h.size < h.header_size || h.size > end - pos) break;
    pos += static_cast<size_t>(h.size);
  }
  return false;
}

struct Freeform {
  std::string ns, name, value;
};

// Parse mean/name/data children of a ---- box (mp4meta.rs:236-291).
bool parse_freeform(const uint8_t* data, size_t len, Freeform* out) {
  bool have_ns = false, have_name = false, have_value = false;
  size_t pos = 0;
  BoxHeader h;
  while (read_box(data, len, pos, &h)) {
    const size_t content_start = pos + h.header_size;
    const size_t content_size = static_cast<size_t>(h.content_size());
    const size_t content_end = content_start + content_size;
    if (content_end > len) break;
    if (h.box_type == MEAN && content_start + 4 < content_end) {
      out->ns.assign(reinterpret_cast<const char*>(data + content_start + 4),
                     content_end - content_start - 4);
      have_ns = true;
    } else if (h.box_type == NAME && content_start + 4 < content_end) {
      out->name.assign(reinterpret_cast<const char*>(data + content_start + 4),
                       content_end - content_start - 4);
      have_name = true;
    } else if (h.box_type == DATA && content_start + 8 < content_end) {
      out->value.assign(reinterpret_cast<const char*>(data + content_start + 8),
                        content_end - content_start - 8);
      have_value = true;
    }
    pos = content_end;
  }
  return have_ns && have_name && have_value;
}

// Serialize a freeform ---- box (mp4meta.rs:294-330).
std::vector<uint8_t> serialize_freeform(const std::string& ns,
                                        const std::string& name,
                                        const std::string& value) {
  std::vector<uint8_t> inner;
  put_be32(inner, static_cast<uint32_t>(12 + ns.size()));
  put_bytes(inner, "mean", 4);
  put_be32(inner, 0);
  put_bytes(inner, ns.data(), ns.size());
  put_be32(inner, static_cast<uint32_t>(12 + name.size()));
  put_bytes(inner, "name", 4);
  put_be32(inner, 0);
  put_bytes(inner, name.data(), name.size());
  put_be32(inner, static_cast<uint32_t>(16 + value.size()));
  put_bytes(inner, "data", 4);
  put_be32(inner, 0);
  put_be32(inner, 1);  // type 1 = UTF-8 text
  put_bytes(inner, value.data(), value.size());

  std::vector<uint8_t> out;
  put_be32(out, static_cast<uint32_t>(8 + inner.size()));
  put_bytes(out, "----", 4);
  put_bytes(out, inner.data(), inner.size());
  return out;
}

bool iequals(const std::string& a, const char* b) {
  size_t n = strlen(b);
  if (a.size() != n) return false;
  for (size_t i = 0; i < n; ++i) {
    char ca = a[i], cb = b[i];
    if (ca >= 'A' && ca <= 'Z') ca += 32;
    if (cb >= 'A' && cb <= 'Z') cb += 32;
    if (ca != cb) return false;
  }
  return true;
}

int rg_index(const Freeform& t) {
  if (t.ns != kItunesNamespace) return -1;
  for (int i = 0; i < 4; ++i) {
    if (iequals(t.name, kRgNames[i])) return i;
  }
  return -1;
}

// Rebuild an ilst: keep non-RG children, append new RG tags (mp4meta.rs:621-675).
std::vector<uint8_t> create_ilst(const std::string* tags,  // 4 entries
                                 const bool* present, const uint8_t* existing,
                                 size_t existing_len) {
  std::vector<uint8_t> content;
  size_t pos = 0;
  BoxHeader h;
  while (pos + 8 <= existing_len && read_box(existing, existing_len, pos, &h)) {
    if (h.size < h.header_size || h.size > existing_len - pos) break;
    bool is_rg = false;
    if (h.box_type == FREEFORM) {
      Freeform t;
      if (parse_freeform(existing + pos + h.header_size,
                         static_cast<size_t>(h.size) - h.header_size, &t)) {
        is_rg = rg_index(t) >= 0;
      }
    }
    if (!is_rg) put_bytes(content, existing + pos, static_cast<size_t>(h.size));
    pos += static_cast<size_t>(h.size);
  }
  for (int i = 0; i < 4; ++i) {
    if (present[i]) {
      auto ff = serialize_freeform(kItunesNamespace, kRgNames[i], tags[i]);
      put_bytes(content, ff.data(), ff.size());
    }
  }
  std::vector<uint8_t> ilst;
  put_be32(ilst, static_cast<uint32_t>(8 + content.size()));
  put_bytes(ilst, "ilst", 4);
  put_bytes(ilst, content.data(), content.size());
  return ilst;
}

std::vector<uint8_t> create_hdlr() {
  std::vector<uint8_t> body;
  put_be32(body, 0);            // version/flags
  put_be32(body, 0);            // pre_defined
  put_bytes(body, "mdir", 4);   // handler_type
  put_bytes(body, "appl", 4);   // manufacturer
  put_be32(body, 0);
  put_be32(body, 0);
  body.push_back(0);            // empty name
  std::vector<uint8_t> out;
  put_be32(out, static_cast<uint32_t>(8 + body.size()));
  put_bytes(out, "hdlr", 4);
  put_bytes(out, body.data(), body.size());
  return out;
}

std::vector<uint8_t> create_meta(const std::vector<uint8_t>& ilst) {
  auto hdlr = create_hdlr();
  std::vector<uint8_t> meta;
  put_be32(meta, static_cast<uint32_t>(8 + 4 + hdlr.size() + ilst.size()));
  put_bytes(meta, "meta", 4);
  put_be32(meta, 0);  // version/flags
  put_bytes(meta, hdlr.data(), hdlr.size());
  put_bytes(meta, ilst.data(), ilst.size());
  return meta;
}

std::vector<uint8_t> create_udta(const std::vector<uint8_t>& content) {
  std::vector<uint8_t> udta;
  put_be32(udta, static_cast<uint32_t>(8 + content.size()));
  put_bytes(udta, "udta", 4);
  put_bytes(udta, content.data(), content.size());
  return udta;
}

void update_box_size(std::vector<uint8_t>& data, size_t box_pos, int64_t diff) {
  if (box_pos + 4 > data.size()) return;
  const uint32_t cur = be32(data.data() + box_pos);
  if (cur <= 1) return;  // extended-size or to-EOF box
  const uint32_t neu = static_cast<uint32_t>(static_cast<int64_t>(cur) + diff);
  data[box_pos] = static_cast<uint8_t>(neu >> 24);
  data[box_pos + 1] = static_cast<uint8_t>(neu >> 16);
  data[box_pos + 2] = static_cast<uint8_t>(neu >> 8);
  data[box_pos + 3] = static_cast<uint8_t>(neu);
}

// Patch stco/co64 chunk offsets recursively (mp4meta.rs:772-863).
void update_offsets(std::vector<uint8_t>& data, size_t start, size_t end,
                    int64_t diff) {
  size_t pos = start;
  while (pos + 8 <= end) {
    const uint32_t size = be32(data.data() + pos);
    const uint32_t type = be32(data.data() + pos + 4);
    if (size == 0 || pos + size > end) break;
    if (type == STCO) {
      const size_t count_pos = pos + 12;
      if (count_pos + 4 <= data.size()) {
        const uint32_t count = be32(data.data() + count_pos);
        size_t off_pos = count_pos + 4;
        for (uint32_t i = 0; i < count; ++i) {
          if (off_pos + 4 > data.size()) break;
          const uint32_t off = be32(data.data() + off_pos);
          const uint32_t neu =
              static_cast<uint32_t>(static_cast<int64_t>(off) + diff);
          data[off_pos] = static_cast<uint8_t>(neu >> 24);
          data[off_pos + 1] = static_cast<uint8_t>(neu >> 16);
          data[off_pos + 2] = static_cast<uint8_t>(neu >> 8);
          data[off_pos + 3] = static_cast<uint8_t>(neu);
          off_pos += 4;
        }
      }
    } else if (type == CO64) {
      const size_t count_pos = pos + 12;
      if (count_pos + 4 <= data.size()) {
        const uint32_t count = be32(data.data() + count_pos);
        size_t off_pos = count_pos + 4;
        for (uint32_t i = 0; i < count; ++i) {
          if (off_pos + 8 > data.size()) break;
          const uint64_t off = be64(data.data() + off_pos);
          const uint64_t neu =
              static_cast<uint64_t>(static_cast<int64_t>(off) + diff);
          for (int b = 0; b < 8; ++b) {
            data[off_pos + b] = static_cast<uint8_t>(neu >> (56 - 8 * b));
          }
          off_pos += 8;
        }
      }
    } else if (type == TRAK || type == MDIA || type == MINF || type == STBL ||
               type == MOOV || type == UDTA) {
      update_offsets(data, pos + 8, pos + size, diff);
    }
    pos += size;
  }
}

// Unpack the 4-slot packed tag list used across the C ABI:
// per slot: u32le length (0xFFFFFFFF = absent) followed by that many bytes.
bool unpack_tags(const uint8_t* packed, size_t packed_len, std::string* tags,
                 bool* present) {
  size_t pos = 0;
  for (int i = 0; i < 4; ++i) {
    if (pos + 4 > packed_len) return false;
    uint32_t n = static_cast<uint32_t>(packed[pos]) |
                 (static_cast<uint32_t>(packed[pos + 1]) << 8) |
                 (static_cast<uint32_t>(packed[pos + 2]) << 16) |
                 (static_cast<uint32_t>(packed[pos + 3]) << 24);
    pos += 4;
    if (n == 0xFFFFFFFFu) {
      present[i] = false;
      continue;
    }
    if (pos + n > packed_len) return false;
    tags[i].assign(reinterpret_cast<const char*>(packed + pos), n);
    present[i] = true;
    pos += n;
  }
  return true;
}

}  // namespace

extern "C" {

int32_t mg_mp4_is_mp4(const uint8_t* data, size_t len) {
  // ftyp brand check (mp4meta.rs:872-889).
  if (len < 12) return 0;
  const uint32_t size = be32(data);
  if (memcmp(data + 4, "ftyp", 4) != 0 || size < 12) return 0;
  static const char* kBrands[] = {"M4A ", "M4B ", "M4P ", "M4V ",
                                  "mp41", "mp42", "isom", "iso2"};
  for (const char* b : kBrands) {
    if (memcmp(data + 8, b, 4) == 0) return 1;
  }
  return 0;
}

// Read RG tags; writes the 4-slot packed format into `out`.
// Returns bytes written, or -(needed).
int64_t mg_mp4_read_tags(const uint8_t* data, size_t len, uint8_t* out,
                         int64_t cap) {
  std::string tags[4];
  bool present[4] = {false, false, false, false};

  size_t moov_pos;
  BoxHeader moov;
  if (find_box(data, len, MOOV, &moov_pos, &moov)) {
    const size_t moov_cs = moov_pos + moov.header_size;
    const size_t moov_sz = static_cast<size_t>(moov.content_size());
    size_t udta_pos;
    BoxHeader udta;
    if (find_box_in(data, len, moov_cs, moov_sz, UDTA, &udta_pos, &udta)) {
      const size_t udta_cs = udta_pos + udta.header_size;
      const size_t udta_sz = static_cast<size_t>(udta.content_size());
      size_t meta_pos;
      BoxHeader meta;
      if (find_box_in(data, len, udta_cs, udta_sz, META, &meta_pos, &meta)) {
        const size_t meta_cs = meta_pos + meta.header_size + 4;
        const size_t meta_sz = static_cast<size_t>(meta.content_size()) - 4;
        size_t ilst_pos;
        BoxHeader ilst;
        if (find_box_in(data, len, meta_cs, meta_sz, ILST, &ilst_pos, &ilst)) {
          const size_t start = ilst_pos + ilst.header_size;
          const size_t end = start + static_cast<size_t>(ilst.content_size());
          size_t pos = start;
          BoxHeader h;
          while (pos + 8 <= end && read_box(data, len, pos, &h)) {
            if (h.box_type == FREEFORM && h.size >= h.header_size &&
                pos + h.size <= len) {
              Freeform t;
              if (parse_freeform(data + pos + h.header_size,
                                 static_cast<size_t>(h.size) - h.header_size,
                                 &t)) {
                const int idx = rg_index(t);
                if (idx >= 0) {
                  tags[idx] = t.value;
                  present[idx] = true;
                }
              }
            }
            if (h.size < h.header_size || h.size > end - pos) break;
            pos += static_cast<size_t>(h.size);
          }
        }
      }
    }
  }

  std::vector<uint8_t> packed;
  for (int i = 0; i < 4; ++i) {
    if (!present[i]) {
      packed.push_back(0xFF);
      packed.push_back(0xFF);
      packed.push_back(0xFF);
      packed.push_back(0xFF);
    } else {
      const uint32_t n = static_cast<uint32_t>(tags[i].size());
      packed.push_back(static_cast<uint8_t>(n));
      packed.push_back(static_cast<uint8_t>(n >> 8));
      packed.push_back(static_cast<uint8_t>(n >> 16));
      packed.push_back(static_cast<uint8_t>(n >> 24));
      put_bytes(packed, tags[i].data(), tags[i].size());
    }
  }
  if (static_cast<int64_t>(packed.size()) > cap) {
    return -static_cast<int64_t>(packed.size());
  }
  memcpy(out, packed.data(), packed.size());
  return static_cast<int64_t>(packed.size());
}

// Rewrite the file with new RG tags (4-slot packed input).
// Returns new file length, -(needed) if cap too small, or -1 on error
// (no moov box).
int64_t mg_mp4_write_tags(const uint8_t* data, size_t len,
                          const uint8_t* tags_packed, size_t tags_len,
                          uint8_t* out, int64_t cap) {
  std::string tags[4];
  bool present[4];
  if (!unpack_tags(tags_packed, tags_len, tags, present)) return -1;

  size_t moov_pos;
  BoxHeader moov;
  if (!find_box(data, len, MOOV, &moov_pos, &moov)) return -1;
  // Malformed size fields must not drive the rebuild out of bounds.
  if (moov.size < moov.header_size || moov_pos + moov.size > len) return -1;
  const size_t moov_cs = moov_pos + moov.header_size;
  const size_t moov_sz = static_cast<size_t>(moov.content_size());
  const size_t moov_end = moov_pos + static_cast<size_t>(moov.size);

  std::vector<uint8_t> result;
  result.reserve(len + 1024);

  size_t udta_pos = 0;
  BoxHeader udta;
  bool have_udta =
      find_box_in(data, len, moov_cs, moov_sz, UDTA, &udta_pos, &udta);
  if (have_udta &&
      (udta.size < udta.header_size || udta_pos + udta.size > len)) {
    return -1;
  }

  bool placed = false;
  if (have_udta) {
    const size_t udta_cs = udta_pos + udta.header_size;
    const size_t udta_sz = static_cast<size_t>(udta.content_size());
    size_t meta_pos = 0;
    BoxHeader meta;
    if (find_box_in(data, len, udta_cs, udta_sz, META, &meta_pos, &meta) &&
        meta.content_size() >= 4 &&
        meta_pos + meta.size <= len) {
      const size_t meta_cs = meta_pos + meta.header_size + 4;
      const size_t meta_sz = static_cast<size_t>(meta.content_size()) - 4;
      size_t ilst_pos = 0;
      BoxHeader ilst;
      if (find_box_in(data, len, meta_cs, meta_sz, ILST, &ilst_pos, &ilst) &&
          ilst.size >= ilst.header_size && ilst_pos + ilst.size <= len) {
        // Existing ilst: replace, preserving non-RG tags (mp4meta.rs:450-474).
        const size_t ilst_cs = ilst_pos + ilst.header_size;
        const size_t ilst_sz = static_cast<size_t>(ilst.content_size());
        auto new_ilst =
            create_ilst(tags, present, data + ilst_cs, ilst_sz);
        const int64_t diff = static_cast<int64_t>(new_ilst.size()) -
                             static_cast<int64_t>(ilst.size);
        put_bytes(result, data, ilst_pos);
        put_bytes(result, new_ilst.data(), new_ilst.size());
        put_bytes(result, data + ilst_pos + static_cast<size_t>(ilst.size),
                  len - ilst_pos - static_cast<size_t>(ilst.size));
        update_box_size(result, moov_pos, diff);
        update_box_size(result, udta_pos, diff);
        update_box_size(result, meta_pos, diff);
        placed = true;
      }
    }
    if (!placed) {
      // udta without meta/ilst: append meta at end of udta (mp4meta.rs:475-497).
      auto new_ilst = create_ilst(tags, present, nullptr, 0);
      auto meta_box = create_meta(new_ilst);
      const int64_t diff = static_cast<int64_t>(meta_box.size());
      const size_t udta_end = udta_pos + static_cast<size_t>(udta.size);
      put_bytes(result, data, udta_end);
      put_bytes(result, meta_box.data(), meta_box.size());
      put_bytes(result, data + udta_end, len - udta_end);
      update_box_size(result, moov_pos, diff);
      update_box_size(result, udta_pos, diff);
      placed = true;
    }
  } else {
    // No udta: create udta+meta+ilst at end of moov (mp4meta.rs:498-515).
    auto new_ilst = create_ilst(tags, present, nullptr, 0);
    auto meta_box = create_meta(new_ilst);
    auto udta_box = create_udta(meta_box);
    const int64_t diff = static_cast<int64_t>(udta_box.size());
    put_bytes(result, data, moov_end);
    put_bytes(result, udta_box.data(), udta_box.size());
    put_bytes(result, data + moov_end, len - moov_end);
    update_box_size(result, moov_pos, diff);
    placed = true;
  }

  // Patch chunk offsets when moov precedes mdat (mp4meta.rs:518-528).
  size_t mdat_pos;
  BoxHeader mdat;
  if (find_box(data, len, MDAT, &mdat_pos, &mdat) && mdat_pos > moov_pos) {
    const int64_t size_diff =
        static_cast<int64_t>(result.size()) - static_cast<int64_t>(len);
    if (size_diff != 0) {
      size_t new_moov_pos;
      BoxHeader new_moov;
      if (find_box(result.data(), result.size(), MOOV, &new_moov_pos,
                   &new_moov)) {
        update_offsets(result, moov_pos + 8,
                       moov_pos + static_cast<size_t>(new_moov.size),
                       size_diff);
      }
    }
  }

  if (static_cast<int64_t>(result.size()) > cap) {
    return -static_cast<int64_t>(result.size());
  }
  memcpy(out, result.data(), result.size());
  return static_cast<int64_t>(result.size());
}

}  // extern "C"
