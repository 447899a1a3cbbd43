// Host plan of a light MP3 batch for the card's lane pack (K0,
// csrc/lane_pack.cu).
//
// decode/entropy_kernel.prepare_batch sorts a batch's granule-channels into
// blocks of `lanes` and packs their Huffman windows lane-major on the host
// (mg_entropy_pack4): word k of 128 sorted, randomly placed rows into one
// line, a gather bound by host memory. Here the host only plans and copies;
// K0 builds the same lane-major buffer on the card.
//
//   mg_lane_plan: from the meta rows, each row's step estimate, window bits,
//     big-value pairs and count1 quads; the stable counting sort of
//     mg_sort_est_bits on the same key (so the same order and inv); each
//     block's loop bounds and each subgroup's word-group extent and offset
//     (scalars, as prepare_batch makes them); each row's used word count
//     (its window bits + 64 bits of slack, capped by its subgroup's extent
//     and the md row, as mg_entropy_pack4 caps it), as offsets into the
//     compact word array, and its five packed uint16 meta words
//     (mg_entropy_pack4's layout), in walk order.
//   mg_lane_copy: each row's used words, back to back in walk order (the
//     reads run forward through each track), from a byte offset and a
//     byte count a row, so that the 528-byte rows and the main-data
//     stream are read by the same copy.
//
// Tracks are passed as base pointers with row strides (meta) or per-row
// byte offsets (md), so no per-row pointer array is built. field[] holds
// the meta column of each F_* field (decode/frontend.py LM_*).

#include <stdint.h>
#include <string.h>

#include <climits>
#include <memory>
#include <vector>

namespace {

enum { F_P0, F_P23, F_BVP, F_R0P, F_R1P, F_G0, F_G1, F_G2, F_L0, F_L1, F_L2,
       F_GCNT };

constexpr int64_t kMaxSteps = 288;    // entropy_kernel.MAX_STEPS
constexpr int64_t kBitsRange = 4104;  // mg_sort_est_bits' key: max bits 4103
constexpr int64_t kKeys = (kMaxSteps + 1) * kBitsRange;

// Python's floor division, which prepare_batch's bounds use.
int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

template <typename T>
T max_of(T a, T b) { return a < b ? b : a; }

}  // namespace

extern "C" {

// meta_base[t] / meta_stride[t] (int32 elements) / counts[t]: track t's
// meta rows. nb blocks of `lanes` lanes, subgroups of `subg` (both powers
// of two); md_words: 32-bit words in one md row. Writes order and inv
// (nb * lanes), scalars (nb, 3 + lanes / subg), word_off (n + 1), meta5
// (n, 5) and *g_real_out;
// returns the total word count, word_off[n]. Three passes over the rows:
// the meta (in walk order), the sort's scatter (which also takes each
// block's and subgroup's maxima, so nothing is gathered in sorted order)
// and the word counts (in walk order).
int64_t mg_lane_plan(const uint64_t* meta_base, const int64_t* meta_stride,
                     const int64_t* counts, int64_t ntracks,
                     const int32_t* field, int64_t nb, int64_t lanes,
                     int64_t subg, int64_t md_words, int32_t* order,
                     int32_t* inv, int32_t* scalars, int32_t* word_off,
                     uint16_t* meta5, int64_t* g_real_out) {
  const int64_t npad = nb * lanes;
  const int64_t nsg = lanes / subg;
  const int64_t cols = 3 + nsg;
  struct Row {
    int32_t bvp;
    int32_t quads;
    int64_t bits;
  };
  // Left uninitialised: the meta pass writes rows 0..n, and padding rows
  // (n..npad) get est = bits = bvp = quads = 0 and key 0 after it, as in
  // prepare_batch.
  std::unique_ptr<Row[]> rows(new Row[npad]);
  std::unique_ptr<int32_t[]> key(new int32_t[npad]);
  std::vector<int32_t> count(static_cast<size_t>(kKeys) + 1, 0);
  // lanes and subg are powers of two: shifts, not divisions, in the loops.
  const int lanes_log2 = __builtin_ctzll(static_cast<uint64_t>(lanes));
  const int subg_log2 = __builtin_ctzll(static_cast<uint64_t>(subg));

  int64_t n = 0;
  for (int64_t t = 0; t < ntracks; ++t) {
    const int32_t* m = reinterpret_cast<const int32_t*>(meta_base[t]);
    for (int64_t i = 0; i < counts[t]; ++i, ++n) {
      const int32_t* row = m + i * meta_stride[t];
      const int64_t b = row[field[F_BVP]];
      const int64_t p23 = row[field[F_P23]];
      const int64_t p0 = row[field[F_P0]];
      int64_t qd = floor_div(576 - 2 * b, 4);
      if (qd > p23) qd = p23;
      if (qd < 0) qd = 0;
      int64_t est = b + qd;
      if (est > kMaxSteps) est = kMaxSteps;
      if (est < 0) est = 0;
      int64_t w = p0 + p23;
      rows[n] = Row{static_cast<int32_t>(b), static_cast<int32_t>(qd), w};
      if (w < 0) w = 0;
      if (w >= kBitsRange) w = kBitsRange - 1;
      key[n] = static_cast<int32_t>(est * kBitsRange + w);
      ++count[static_cast<size_t>(key[n]) + 1];
      uint16_t* mo = meta5 + n * 5;
      mo[0] = static_cast<uint16_t>((p23 & 0xFFF) | ((p0 & 7) << 12) |
                                    ((row[field[F_GCNT]] & 1) << 15));
      mo[1] = static_cast<uint16_t>((b & 511) | ((row[field[F_G0]] & 15) << 9));
      mo[2] = static_cast<uint16_t>((row[field[F_R0P]] & 511) | ((row[field[F_G1]] & 15) << 9));
      mo[3] = static_cast<uint16_t>((row[field[F_R1P]] & 511) | ((row[field[F_G2]] & 15) << 9));
      mo[4] = static_cast<uint16_t>((row[field[F_L0]] & 15) | ((row[field[F_L1]] & 15) << 4) |
                                    ((row[field[F_L2]] & 15) << 8));
    }
  }
  for (int64_t i = n; i < npad; ++i) {
    rows[i] = Row{0, 0, 0};
    key[i] = 0;
  }
  count[1] += npad - n;  // the padding rows' key 0
  for (size_t k = 1; k <= static_cast<size_t>(kKeys); ++k) count[k] += count[k - 1];

  // The scatter of the stable counting sort; each lane's row also raises
  // its block's and its subgroup's maxima.
  std::vector<int64_t> max_bvp(static_cast<size_t>(nb), INT64_MIN);
  std::vector<int64_t> max_q(static_cast<size_t>(nb), INT64_MIN);
  std::vector<int64_t> max_bits(static_cast<size_t>(nb * nsg), INT64_MIN);
  std::vector<uint8_t> real(static_cast<size_t>(nb * nsg), 0);
  for (int64_t i = 0; i < npad; ++i) {
    const int32_t pos = count[static_cast<size_t>(key[i])]++;
    order[pos] = static_cast<int32_t>(i);
    inv[i] = pos;
    const Row& r = rows[i];
    const int64_t blk = pos >> lanes_log2;
    const int64_t sg = pos >> subg_log2;
    max_bvp[blk] = max_of<int64_t>(max_bvp[blk], r.bvp);
    max_q[blk] = max_of<int64_t>(max_q[blk], r.quads);
    max_bits[sg] = max_of(max_bits[sg], r.bits);
    real[sg] |= i < n;
  }

  std::vector<int64_t> w8_sg(static_cast<size_t>(nb * nsg));
  int64_t g_real = 0;
  for (int64_t blk = 0; blk < nb; ++blk) {
    int32_t* sc = scalars + blk * cols;
    int64_t w8_b = 0;
    for (int64_t s = 0; s < nsg; ++s) {
      const int64_t sg = blk * nsg + s;
      const int64_t w8 = real[sg] ? max_of<int64_t>(floor_div(max_bits[sg] + 64 + 255, 256), 1) : 0;
      w8_sg[sg] = w8;
      sc[3 + s] = static_cast<int32_t>(g_real);
      g_real += w8;
      w8_b = max_of(w8_b, w8);
    }
    sc[0] = static_cast<int32_t>(floor_div(max_bvp[blk] + 3, 4) * 4);
    sc[1] = static_cast<int32_t>(floor_div(max_q[blk] + 1, 2) * 2);
    sc[2] = static_cast<int32_t>(w8_b);
  }
  *g_real_out = g_real;

  int64_t total = 0;
  for (int64_t r = 0; r < n; ++r) {
    word_off[r] = static_cast<int32_t>(total);
    int64_t nw = (rows[r].bits + 95) >> 5;
    const int64_t cap = w8_sg[inv[r] >> subg_log2] * 8;
    if (nw > cap) nw = cap;
    if (nw > md_words) nw = md_words;
    if (nw > 0) total += nw;
  }
  word_off[n] = static_cast<int32_t>(total);
  return total;
}

// md_base[t] / md_off[t] (int64) / md_count[t] (uint16) / counts[t]: track
// t's Huffman windows, row i's md_count[t][i] bytes at md_base[t] +
// md_off[t][i], zeros after them (frontend.unpack_data_light_stream's
// MdWindows; the 528-byte row form is off = i * 528, count = 528). Copies
// row r's word_off[r + 1] - word_off[r] words to words + word_off[r],
// zero past the row's bytes.
void mg_lane_copy(const uint64_t* md_base, const uint64_t* md_off,
                  const uint64_t* md_count, const int64_t* counts,
                  int64_t ntracks, const int32_t* word_off, uint32_t* words) {
  int64_t r = 0;
  for (int64_t t = 0; t < ntracks; ++t) {
    const uint8_t* md = reinterpret_cast<const uint8_t*>(md_base[t]);
    const int64_t* off = reinterpret_cast<const int64_t*>(md_off[t]);
    const uint16_t* count = reinterpret_cast<const uint16_t*>(md_count[t]);
    for (int64_t i = 0; i < counts[t]; ++i, ++r) {
      const int64_t nb = static_cast<int64_t>(word_off[r + 1] - word_off[r]) * 4;
      const int64_t c = count[i] < nb ? count[i] : nb;
      uint8_t* dst = reinterpret_cast<uint8_t*>(words + word_off[r]);
      memcpy(dst, md + off[i], static_cast<size_t>(c));
      memset(dst + c, 0, static_cast<size_t>(nb - c));
    }
  }
}

}  // extern "C"
