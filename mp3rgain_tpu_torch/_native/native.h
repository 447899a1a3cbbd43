// The torch port's native host core: C ABI of the MP3 decode front-end
// (mp3dec.cpp) and the MP4 box engine (mp4box.cpp), copied from the JAX
// package's mp3rgain_tpu/_native and trimmed to what these two sources
// define. The port binds them with ctypes (mp3rgain_tpu_torch/native.py).
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

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // MP3RGAIN_TORCH_NATIVE_H
