// The torch port's native host core: C ABI of the MP3 gain surgery core
// (bitstream.cpp), the APEv2 tag engine (ape.cpp), the MP3 decode
// front-end (mp3dec.cpp), the MP4 box engine (mp4box.cpp) and the AAC-LC
// decode front-end (aacdec.cpp), copied from the JAX package's
// mp3rgain_tpu/_native and trimmed to what these five sources define. The port binds them with ctypes
// (mp3rgain_tpu_torch/native.py).
//
// All functions operate on caller-owned buffers; no file I/O and no global
// state.

#ifndef MP3RGAIN_TORCH_NATIVE_H
#define MP3RGAIN_TORCH_NATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// ---------------------------------------------------------------------------
// L0 bitstream core (the reference Rust mp3rgain, src/lib.rs)
// ---------------------------------------------------------------------------

// Result of a whole-file gain analysis (reference: src/lib.rs:57-75).
typedef struct {
  int64_t frame_count;
  uint8_t min_gain;
  uint8_t max_gain;
  double avg_gain;
  int32_t mpeg_version;  // 1, 2, or 25 (for 2.5)
  int32_t channel_mode;  // 0 stereo, 1 joint, 2 dual, 3 mono
} MgAnalysis;

// Analyze global_gain statistics over all audio frames.
// Returns 0 on success, -1 if no valid MP3 frames found.
int32_t mg_analyze(const uint8_t* data, size_t len, MgAnalysis* out);

// Apply `steps` to every global_gain field, in place.
// mode: 0 = saturating (clamp 0..255), 1 = wrapping (mod 256).
// Returns number of modified frames (>= 0).
int64_t mg_apply_gain(uint8_t* data, size_t len, int32_t steps, int32_t mode);

// Apply `steps` to a single channel (0 = left, 1 = right), saturating.
// Returns number of modified frames. Caller must pre-check mono files.
int64_t mg_apply_gain_channel(uint8_t* data, size_t len, int32_t channel,
                              int32_t steps);

// Export every global_gain value, in frame/granule/channel order.
// Returns count written, or -(needed) if cap is too small.
int64_t mg_read_gains(const uint8_t* data, size_t len, uint8_t* gains,
                      int64_t cap);

// Export the frame index: for each audio frame writes
// {offset, frame_size, header_word} triples into `out` (cap = triple count).
// Returns number of frames, or -(needed) if cap is too small.
int64_t mg_frame_index(const uint8_t* data, size_t len, int64_t* out,
                       int64_t cap);

// End of audio data (before APE/ID3v1 trailers); reference src/lib.rs:358-383.
int64_t mg_find_audio_end(const uint8_t* data, size_t len);

// Unaligned 8-bit field read/write (test hooks; reference src/lib.rs:301-340).
uint8_t mg_read_bits8(const uint8_t* data, size_t len, size_t byte_offset,
                      uint8_t bit_offset);
void mg_write_bits8(uint8_t* data, size_t len, size_t byte_offset,
                    uint8_t bit_offset, uint8_t value);

// ---------------------------------------------------------------------------
// APEv2 tag engine (the reference's src/lib.rs:838-1163)
// ---------------------------------------------------------------------------

// Find APEv2 footer start (at EOF, or before a trailing ID3v1 tag).
// Returns offset or -1 (reference src/lib.rs:944-966).
int64_t mg_ape_find_footer(const uint8_t* data, size_t len);

// Parse an APEv2 tag into a packed item list:
//   for each item: u32le key_len, u32le value_len, key bytes, value bytes.
// Returns number of bytes written to `out`, -1 if no/invalid tag,
// or -(needed) if cap too small. `*item_count` receives the item count.
int64_t mg_ape_parse(const uint8_t* data, size_t len, uint8_t* out,
                     int64_t cap, int64_t* item_count);

// Serialize a packed item list (format as above) into a full APEv2 tag
// (header + items + footer). Empty list serializes to 0 bytes.
// Returns bytes written or -(needed).
int64_t mg_ape_serialize(const uint8_t* items, size_t items_len,
                         int64_t item_count, uint8_t* out, int64_t cap);

// Compute the layout for removing an APE tag (reference src/lib.rs:1088-1119):
// *audio_end = end of audio bytes, *tail_start = start of trailing bytes to
// keep (ID3v1 after the APE tag) or -1 if none. Returns 0 if a tag was found,
// -1 if not (in which case the file is unchanged).
int32_t mg_ape_remove_region(const uint8_t* data, size_t len,
                             int64_t* audio_end, int64_t* tail_start);

// ---------------------------------------------------------------------------
// MP3 front-end (mp3dec.cpp). Each unpacker returns the granule-channel
// record count; a count above cap_gch means "call again with that cap".
int64_t mg_mp3_unpack(const uint8_t* data, size_t len, int32_t* info,
                      int32_t* scf, int32_t* is, int64_t cap_gch);
int64_t mg_mp3_unpack_light(const uint8_t* data, size_t len, int32_t* info,
                            int32_t* scf, uint8_t* md, int64_t md_stride,
                            int32_t* meta, int64_t cap_gch);
int64_t mg_mp3_count_gch(const uint8_t* data, size_t len);
int64_t mg_mp3_unpack_light2(const uint8_t* data, size_t len, uint16_t* ip,
                             uint8_t* scf_main, int32_t* srows,
                             uint8_t* sdata, int32_t* hrows, uint8_t* hmask,
                             uint8_t* md, int64_t md_stride, int32_t* meta,
                             int64_t cap_gch, int32_t* out_hdr);
void mg_entropy_pack4(const uint64_t* md_rows, const uint64_t* meta_rows,
                      int64_t n, int64_t meta_n, const int32_t* order,
                      int64_t npad, int64_t lanes, int64_t subg,
                      const int32_t* sg_off, const int32_t* sg_w8,
                      int64_t md_stride, int64_t meta_rows_out,
                      int32_t* buf, uint16_t* metab);
void mg_sort_est_bits(const int32_t* est, const int64_t* bits, int64_t n,
                      int32_t* order, int32_t* inv);
int32_t mg_pack_light_track(const int32_t* info, const int32_t* scf,
                            int64_t n, uint16_t* ip_out, uint8_t* scf_main,
                            int32_t* srows, uint8_t* sdata, int32_t* hrows,
                            uint8_t* hmask, int64_t row_offset,
                            int64_t* ns_out, int64_t* nh_out);

// MP4 box engine (mp4box.cpp).
int32_t mg_mp4_is_mp4(const uint8_t* data, size_t len);
int64_t mg_mp4_read_tags(const uint8_t* data, size_t len, uint8_t* out,
                         int64_t cap);
int64_t mg_mp4_write_tags(const uint8_t* data, size_t len,
                          const uint8_t* tags_packed, size_t tags_len,
                          uint8_t* out, int64_t cap);

// AAC-LC front-end (aacdec.cpp). Each unpacker walks an ADTS stream and
// returns the channel-frame lane count; a count above cap (or, for the q
// variant, *fb_count above fb_cap or *esc_count above esc_cap) means "call
// again with that capacity". The f32 variant writes natural-order
// requantized spectra, the f16 one block-scaled halves plus a per-lane
// exponent, the q one quantized coefficients, band metadata, compacted
// f16 fallback rows and the sparse escape sideband.
int64_t mg_aac_unpack_adts(const uint8_t* data, size_t len, float* spec,
                           int32_t* info, int64_t cap);
int64_t mg_aac_unpack_adts_f16(const uint8_t* data, size_t len,
                               uint16_t* spec16, int8_t* sexp,
                               int32_t* info, int64_t cap);
int64_t mg_aac_unpack_adts_q(const uint8_t* data, size_t len,
                             int8_t* q8, int16_t* lvl, uint8_t* btype,
                             uint8_t* msf, uint16_t* fb16, int8_t* fbexp,
                             int64_t fb_cap, int64_t* fb_count,
                             int32_t* esc_idx, int16_t* esc_val,
                             int64_t esc_cap, int64_t* esc_count,
                             int32_t* info, int64_t cap);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // MP3RGAIN_TORCH_NATIVE_H
