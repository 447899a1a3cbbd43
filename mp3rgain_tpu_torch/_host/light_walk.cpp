// The light MP3 walk into a main-data stream.
//
// _native/mp3dec.cpp's packed light walk (mg_mp3_unpack_light2) copies each
// granule-channel's Huffman window into a row of md_stride (528) bytes and
// keeps the reservoir in a growing vector. On typical content a row holds
// a quarter of its bytes, and every page of the rows is still faulted and
// zeroed, so the walk spends much of its time on fresh memory it never
// fills. This walk writes each accepted frame's main data once, back to
// back, into a caller-given stream that a count pre-pass sizes exactly,
// and reads the reservoir from that stream. Where the copied walk fills
// row r, it records the window's first byte in the stream (md_off[r]) and
// how many of its bytes the row holds before its zeros (md_count[r]): the
// row's bytes are stream[md_off[r] .. md_off[r] + md_count[r]) and zeros.
// The reservoir at a frame ends with that frame's main data, so a window
// near the end of a frame is cut there, as the copied walk cuts it; a row
// the copied walk zeroes (a bad reservoir, a scalefactor overrun, or no
// part 3 bits) counts 0 bytes at the stream's zero tail. Everything else
// it writes (ip, scf_main, srows, sdata, hrows, hmask, meta, the header)
// is byte for byte mg_mp3_unpack_light2's.
//
//   mg_light_stream_count: the rows and the main-data bytes of the frames
//     the walk accepts, in one pass of the copied walk's frame acceptance.
//   mg_light_stream_walk: the walk.
//
// The parser is the copied one, included unchanged.

#include "../_native/mp3dec.cpp"

namespace {

// A frame the light walk accepts at pos (resync check, Xing skipped by the
// caller): its header, or false.
bool accept_frame(const uint8_t* data, size_t len, size_t audio_end,
                  size_t pos, FrameHeader* h) {
  if (!parse_header(data + pos, len - pos, h)) return false;
  const size_t next_pos = pos + h->frame_size;
  if (next_pos + 2 <= audio_end) {
    return data[next_pos] == 0xFF && (data[next_pos + 1] & 0xE0) == 0xE0;
  }
  return next_pos <= audio_end;
}

// The frame's main data: [md_start, md_end) of data, empty where md_end <=
// md_start.
void main_data_span(size_t pos, size_t audio_end, const FrameHeader& h,
                    size_t* md_start, size_t* md_end) {
  const size_t next_pos = pos + h.frame_size;
  *md_start = pos + h.side_info_offset() + h.side_info_len();
  *md_end = next_pos < audio_end ? next_pos : audio_end;
}

}  // namespace

extern "C" {

// Returns the granule-channel rows of the frames the light walk accepts;
// writes their main-data bytes to *md_bytes.
int64_t mg_light_stream_count(const uint8_t* data, size_t len,
                              int64_t* md_bytes) {
  const size_t audio_end = find_audio_end(data, len);
  size_t pos = skip_id3v2(data, len);
  int64_t n = 0, bytes = 0;
  while (pos + 4 <= audio_end) {
    FrameHeader h;
    if (!accept_frame(data, len, audio_end, pos, &h)) {
      ++pos;
      continue;
    }
    if (!is_xing_frame(data, len, pos, h)) {
      size_t md_start, md_end;
      main_data_span(pos, audio_end, h, &md_start, &md_end);
      if (md_end > md_start) bytes += static_cast<int64_t>(md_end - md_start);
      n += h.granule_count() * h.channel_count();
    }
    pos += h.frame_size;
  }
  *md_bytes = bytes;
  return n;
}

// ip, scf_main, srows/sdata, hrows/hmask, meta, cap_gch and out_hdr as in
// mg_mp3_unpack_light2. stream: md_bytes (mg_light_stream_count's) bytes of
// main data, then stream_len - md_bytes >= 16 bytes that the walk zeroes.
// md_off (int64) / md_count (uint16): each row's window in the stream.
// Returns the row count, or -1 where the frames hold more main data than
// md_bytes (a count from other data).
int64_t mg_light_stream_walk(const uint8_t* data, size_t len, uint16_t* ip,
                             uint8_t* scf_main, int32_t* srows,
                             uint8_t* sdata, int32_t* hrows, uint8_t* hmask,
                             int32_t* meta, uint8_t* stream, int64_t md_bytes,
                             int64_t stream_len, int64_t* md_off,
                             uint16_t* md_count, int64_t cap_gch,
                             int32_t* out_hdr) {
  if (stream_len < md_bytes + 16) return -1;
  memset(stream + md_bytes, 0, static_cast<size_t>(stream_len - md_bytes));
  const size_t audio_end = find_audio_end(data, len);
  size_t pos = skip_id3v2(data, len);

  size_t size = 0;  // main-data bytes so far: the reservoir is stream[0, size)
  int64_t n_gch = 0;
  int64_t ns = 0, nh = 0;
  int32_t prev_scf[2][kScfSlots] = {};
  int32_t rscf[kScfSlots];

  while (pos + 4 <= audio_end) {
    FrameHeader h;
    if (!accept_frame(data, len, audio_end, pos, &h)) {
      ++pos;
      continue;
    }
    const size_t next_pos = pos + h.frame_size;
    if (is_xing_frame(data, len, pos, h)) {
      pos = next_pos;
      continue;
    }

    SideInfo si;
    parse_side_info(data + pos + h.side_info_offset(), h, &si);

    size_t md_start, md_end;
    main_data_span(pos, audio_end, h, &md_start, &md_end);
    const size_t prev_size = size;
    if (md_end > md_start) {
      if (static_cast<int64_t>(size + (md_end - md_start)) > md_bytes) return -1;
      memcpy(stream + size, data + md_start, md_end - md_start);
      size += md_end - md_start;
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

        int32_t* rmeta = meta + rec * LIGHT_META_N;
        memset(rscf, 0, kScfSlots * sizeof(int32_t));
        memset(rmeta, 0, LIGHT_META_N * sizeof(int32_t));
        md_off[rec] = md_bytes;  // the zero tail, until a window is found
        md_count[rec] = 0;

        int intensity_scale = 0;
        bool ok = reservoir_ok;
        if (ok) {
          BitReader br{stream, size, gr_bit};
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
            // The part3 window (byte-aligned) + 8 real pad bytes, cut at
            // MD_STRIDE and at the reservoir's end, as the copied walk
            // copies it.
            const size_t start_byte = br.bit >> 3;
            const size_t p0 = br.bit & 7;
            const size_t p23 = end_bit - br.bit;
            size_t nbytes = (p0 + p23 + 7) / 8 + 8;
            if (nbytes > 528) nbytes = 528;
            const size_t avail = size > start_byte ? size - start_byte : 0;
            md_off[rec] = static_cast<int64_t>(start_byte);
            md_count[rec] = static_cast<uint16_t>(avail < nbytes ? avail : nbytes);
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
          }
          gr_bit += gi.part2_3_length;
          if (!h.lsf()) {
            memcpy(prev_scf[ch], rscf, kScfSlots * sizeof(int32_t));
          }
        }
        if (!ok) {
          memset(rscf, 0, kScfSlots * sizeof(int32_t));
        }

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
        if (out_hdr && rec == 0) {
          out_hdr[0] = static_cast<int32_t>(h.sample_rate);
          out_hdr[1] = nch;
        }
      }
    }
    pos = next_pos;
  }
  if (out_hdr) {
    out_hdr[2] = static_cast<int32_t>(ns);
    out_hdr[3] = static_cast<int32_t>(nh);
  }
  return n_gch;
}

}  // extern "C"
