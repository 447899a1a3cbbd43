// MP3 Layer III Huffman decode on Hopper: one thread per granule-channel,
// each spectrum written straight into the row its consumer reads.
//
// Replaces the Pallas kernel mp3rgain_tpu/decode/entropy_kernel.py::_kernel
// (built by _decode_call, driven by decode_blocks) together with the
// unsort and row-map gathers that followed it (entropy_kernel.unsort_blocks,
// then spec[rowmap]). Inputs are that kernel's, unchanged: prepare_batch's
// sorted blocks of LANES lanes, the ragged (g_pad, 8, 128) big-endian word
// buffer with one word-group offset per 128-lane subgroup, and the 5 packed
// uint16 meta rows per lane; plus dest (nb * LANES,) int32, the output row
// of each sorted lane (-1: none). Outputs: spec_rows (n_rows, 576) int16,
// big_end and count1_end (n_rows,) int32, equal to the lockstep kernel's
// outputs after unsort_blocks' bad-lane mask, scattered through dest; rows
// no lane writes read as zero.
//
// What bounds it on this card: the decode is a serial chain per lane (each
// codeword's length decides where the next one starts), so its limit is
// the latency of that chain and the instructions per step as much as
// bytes: a 64 x 60 s batch reads ~0.15 GB of words and writes ~0.7 GB of
// rows (~0.26 ms of HBM time at 3.35 TB/s) while each lane runs up to 288
// dependent steps. The TPU kernel's lane-major layout (lockstep vector
// lanes) cost the GPU five more full passes over the spectra afterwards;
// here one thread decodes one granule-channel and stores its values where
// they belong. The design:
//   - one thread per lane; a 256-thread block covers two 128-lane ragged
//     subgroups, stages the Huffman tables (ab | field << 8, 24 KB of
//     uint16) in shared memory once and decodes; with the lanes' write
//     buffers below a block takes 44 KB, and registers (~48) let five
//     blocks share an SM, so the table copy no longer sets the residency;
//     blocks run longest-first (prepare_batch sorts lanes by estimated
//     steps, ascending) so the slowest lanes do not form a tail;
//   - each lane keeps the three words its current step can touch in
//     registers and fetches one new word as its bit position advances;
//   - values are collected as 32-bit pairs (big-value pairs and count1
//     half-quads are both even-aligned: the count1 region starts at
//     2 * big_values) in a 64-byte buffer of the lane's own in shared
//     memory, and every full buffer goes to the lane's row (1152 bytes =
//     18 such lines) as four 16-byte stores: two whole 32-byte sectors.
//     A lane's row is its own, so no two lanes' stores share a sector, and
//     a sector written in two halves at different times costs the memory
//     system far more than its bytes (a draft that stored each 16-byte
//     chunk as it filled ran 2.5 times slower, see PERF.md); zero runs
//     (between the last big pair and the count1 region, and the tail up
//     to 576) go out as whole zero lines where they cover one;
//   - a lane that goes bad (an invalid codeword) rewrites its whole row
//     with zeros and reports big_end = count1_end = 0: unsort_blocks'
//     mask (values at or past count1_end read as zero) exactly, since a
//     good lane's values past count1_end are zero already;
//   - rows that no lane writes (the row map's padding slots) are zeroed by
//     a small pass over an n_rows byte map of the rows dest covers, which
//     costs their own bytes instead of a memset of the whole output.
//
// Exactness against the lockstep kernel: a lane's state changes only on
// steps where it is active, and once inactive it never becomes active
// again, so stopping a lane's loop at its first inactive step reproduces
// the lockstep run. Each loop is bounded both by the lane's own state and
// by the block's nbig/ncnt from scalars, as the lockstep loops are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSubg = 128;  // lanes per ragged subgroup
constexpr int kThreads = 256;  // lanes per CUDA block: two subgroups
constexpr int kRows = 576;
constexpr int kWords = kRows / 2;   // 32-bit value pairs per row
constexpr int kChunks = kRows / 8;  // 16-byte chunks per row
constexpr int kMetaRows = 5;
constexpr int kW8Max = 17;
constexpr int kL1Win = 256;  // LUT_A: 8-bit window
constexpr int kL2Win = 32;   // LUT_B: 5-bit window
constexpr int kL3Win = 64;   // LUT_C: 6-bit window
constexpr int kCtWin = 64;   // LUT_CT: 6-bit window
constexpr int kGroupsA = 16;
constexpr int kF2L3 = 6;

// Top `nbits` bits at bit `rel` of the 96-bit window u0:u1:u2, with the
// lockstep kernel's word selection (entropy_kernel.make_extract.extract).
__device__ __forceinline__ int extract(uint32_t u0, uint32_t u1, uint32_t u2,
                                       int rel, int nbits) {
  const int j = rel >> 5;
  const int r = rel & 31;
  const uint32_t wa = j == 0 ? u0 : (j == 1 ? u1 : u2);
  const uint32_t wb = j == 0 ? u1 : (j == 1 ? u2 : 0u);
  const uint64_t v = (static_cast<uint64_t>(wa) << 32) | wb;
  const uint32_t cat = static_cast<uint32_t>((v << r) >> 32);
  return static_cast<int>(cat >> (32 - nbits));
}

struct Words {
  const int32_t* lane;  // word w of this lane: lane[(w >> 3) * 1024 + (w & 7) * 128]
  int nw8;              // block's word-group bound; groups past it read 0
  int wi;               // index of u0
  uint32_t u0, u1, u2;

  __device__ __forceinline__ uint32_t load(int w) const {
    const int g = w >> 3;
    if (w < 0 || g >= nw8 || g >= kW8Max) return 0u;
    return static_cast<uint32_t>(__ldg(lane + g * (8 * kSubg) + (w & 7) * kSubg));
  }

  // Make u0..u2 hold words wi..wi+2 for the step at bit position p.
  __device__ __forceinline__ void seek(int p) {
    const int w = p >> 5;
    if (w == wi) return;
    if (w == wi + 1) {
      u0 = u1;
      u1 = u2;
      u2 = load(w + 2);
    } else {
      u0 = load(w);
      u1 = load(w + 1);
      u2 = load(w + 2);
    }
    wi = w;
  }
};

constexpr int kLine = 16;  // value pairs per buffered line: 64 bytes
// Words per lane buffer: padded so that lanes' buffers start on different
// banks (a 16-byte multiple, for the vector reads of a flush).
constexpr int kLineStride = kLine + 4;

// A lane's output row, written in order as 32-bit value pairs through the
// lane's line buffer in shared memory; each full line is stored once.
struct RowWriter {
  uint4* row;
  uint32_t* buf;
  int pos;  // pairs written so far

  __device__ __forceinline__ void flush(int line) {
    const uint4* b = reinterpret_cast<const uint4*>(buf);
#pragma unroll
    for (int j = 0; j < kLine / 4; ++j) row[line * (kLine / 4) + j] = b[j];
  }

  __device__ __forceinline__ void push(uint32_t w) {
    buf[pos & (kLine - 1)] = w;
    ++pos;
    // The bound only matters for meta no front-end produces (nbig below
    // big_values); it keeps every store inside the row.
    if ((pos & (kLine - 1)) == 0 && pos <= kWords) flush(pos / kLine - 1);
  }

  // `count` zero pairs: single pairs up to a line boundary, then whole
  // zero lines straight to the row, then single pairs.
  __device__ __forceinline__ void zeros(int count) {
    for (; count > 0 && (pos & (kLine - 1)); --count) push(0u);
    for (; count >= kLine; count -= kLine) {
#pragma unroll
      for (int j = 0; j < kLine / 4; ++j) row[(pos >> 2) + j] = make_uint4(0u, 0u, 0u, 0u);
      pos += kLine;
    }
    for (; count > 0; --count) push(0u);
  }

  __device__ __forceinline__ void clear() {
    for (int c = 0; c < kChunks; ++c) row[c] = make_uint4(0u, 0u, 0u, 0u);
  }
};

// Dynamic shared memory: the tables (uint16 entries, padded to 16 bytes),
// then one line buffer per lane.
__host__ __device__ __forceinline__ int lut_entries(int n_l2, int n_l3) {
  return kGroupsA * kL1Win + n_l2 * kL2Win + n_l3 * kL3Win + 2 * kCtWin;
}
__host__ __device__ __forceinline__ int lut_padded(int n_l2, int n_l3) {
  return (lut_entries(n_l2, n_l3) + 7) / 8 * 8;
}

__device__ __forceinline__ uint32_t pair(int lo, int hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}

__global__ void __launch_bounds__(kThreads, 4)
entropy_decode_rows_kernel(const int32_t* __restrict__ scalars, int scal_cols,
                           const int32_t* __restrict__ buf,
                           const uint16_t* __restrict__ meta,
                           const int32_t* __restrict__ luts, int n_l2, int n_l3,
                           const int32_t* __restrict__ dest, int n_rows,
                           int16_t* __restrict__ spec_rows,
                           int32_t* __restrict__ big_end,
                           int32_t* __restrict__ count1_end, int lanes) {
  extern __shared__ __align__(16) uint16_t s_lut[];
  const int n_lut = lut_entries(n_l2, n_l3);
  for (int i = threadIdx.x; i < n_lut; i += blockDim.x) {
    s_lut[i] = static_cast<uint16_t>(luts[i]);
  }
  __syncthreads();
  const uint16_t* lut_a = s_lut;
  const uint16_t* lut_b = lut_a + kGroupsA * kL1Win;
  const uint16_t* lut_c = lut_b + n_l2 * kL2Win;
  const uint16_t* lut_ct = lut_c + n_l3 * kL3Win;

  // Longest lanes first: the sort is ascending, so walk blocks backwards.
  const int per_blk = lanes / kThreads;
  const int unit = gridDim.x - 1 - blockIdx.x;
  const int blk = unit / per_blk;
  const int l = (unit % per_blk) * kThreads + threadIdx.x;
  const int sg = l / kSubg;
  const int d = dest[static_cast<int64_t>(blk) * lanes + l];
  if (d < 0 || d >= n_rows) return;

  const int32_t* sc = scalars + static_cast<int64_t>(blk) * scal_cols;
  const int nbig = sc[0];
  const int ncnt = sc[1];

  Words words;
  words.lane = buf + static_cast<int64_t>(sc[3 + sg]) * (8 * kSubg) + (l % kSubg);
  words.nw8 = sc[2];
  words.wi = -2;
  words.u0 = words.u1 = words.u2 = 0u;

  // Packed meta (layout: entropy_kernel.META_ROWS).
  const uint16_t* m = meta + static_cast<int64_t>(blk) * kMetaRows * lanes + l;
  const int w0 = m[0];
  const int w1 = m[lanes];
  const int w2 = m[2 * lanes];
  const int w3 = m[3 * lanes];
  const int w4 = m[4 * lanes];
  const int p0 = (w0 >> 12) & 7;
  const int pend = p0 + (w0 & 0xFFF);
  const int gct = (w0 >> 15) & 1;  // count1 table: gcnt - 16
  const int bvp = w1 & 511;        // <= 288: the front-end clamps big_values
  const int g0 = (w1 >> 9) & 15;
  const int r0p = w2 & 511;
  const int g1 = (w2 >> 9) & 15;
  const int r1p = w3 & 511;
  const int g2 = (w3 >> 9) & 15;
  const int l0 = w4 & 15;
  const int l1 = (w4 >> 4) & 15;
  const int l2 = (w4 >> 8) & 15;

  RowWriter out;
  out.row = reinterpret_cast<uint4*>(spec_rows + static_cast<int64_t>(d) * kRows);
  out.buf = reinterpret_cast<uint32_t*>(s_lut + lut_padded(n_l2, n_l3)) +
            threadIdx.x * kLineStride;
  out.pos = 0;
  int p = p0;
  int n = 0;
  int q = 0;
  bool bad = false;

  // --- phase 1: big-value pairs, pair k at rows (2k, 2k+1) ---------------
  for (int k = 0; k < nbig; ++k) {
    if (!(k < bvp && p < pend)) break;
    words.seek(p);
    const int rel = p - (words.wi << 5);
    const int gbig = n < r0p ? g0 : (n < r1p ? g1 : g2);
    const int linb = n < r0p ? l0 : (n < r1p ? l1 : l2);

    const int ea = lut_a[gbig * kL1Win + extract(words.u0, words.u1, words.u2, rel, 8)];
    const int ab1 = ea & 255;
    const int adv1 = (ea >> 8) & 15;
    const int flag1 = ea >> 12;
    const bool cont = flag1 == 1;
    bad = flag1 == 3;
    int abf = ab1;
    int clen = adv1;
    if (cont) {
      const int eb = lut_b[ab1 * kL2Win + extract(words.u0, words.u1, words.u2, rel + 8, 5)];
      const int ab2 = eb & 255;
      const int f2 = eb >> 8;
      bad = bad || f2 == 0;
      abf = ab2;
      clen = 8 + f2;
      if (f2 == kF2L3) {
        const int ec = lut_c[ab2 * kL3Win + extract(words.u0, words.u1, words.u2, rel + 13, 6)];
        const int rem3 = ec >> 8;
        bad = bad || rem3 == 0;
        abf = ec & 255;
        clen = 13 + rem3;
      }
    }
    if (bad) break;
    const int x = abf & 15;
    const int y = abf >> 4;
    const int qq = p + clen;
    // One 28-bit window: linbits_x + sign_x + linbits_y + sign_y.
    const int e = extract(words.u0, words.u1, words.u2, qq - (words.wi << 5), 28);
    const bool ex = x == 15 && linb > 0;
    int xv = x + (ex ? (e >> (28 - linb)) : 0);
    const int lx = ex ? linb : 0;
    const int sx = xv != 0;
    if (sx && ((e >> (27 - lx)) & 1)) xv = -xv;
    const int o = lx + sx;
    const bool ey = y == 15 && linb > 0;
    int yv = y + (ey ? ((e >> (28 - o - linb)) & ((1 << linb) - 1)) : 0);
    const int ly = ey ? linb : 0;
    const int sy = yv != 0;
    if (sy && ((e >> (27 - o - ly)) & 1)) yv = -yv;
    out.push(pair(xv, yv));
    p = qq + o + ly + sy;
    n += 1;
  }

  if (!bad) {
    out.zeros(bvp - n);
    // --- phase 2: count1 quads, quad j at rows 2*bvp + 4j .. +3 ----------
    // (a lane reaches here with n == bvp or p >= pend, so the quads follow
    // the pairs and zeros above without a gap)
    for (int j = 0; j < ncnt; ++j) {
      if (!(p < pend && 2 * n + 4 * q + 4 <= kRows)) break;
      words.seek(p);
      const int rel = p - (words.wi << 5);
      const int ect = lut_ct[gct * kCtWin + extract(words.u0, words.u1, words.u2, rel, 6)];
      const int adv1 = (ect >> 8) & 15;
      if ((ect >> 12) == 3) {
        bad = true;
        break;
      }
      const int v = ect & 15;
      const int qq = p + adv1;
      const int sb = extract(words.u0, words.u1, words.u2, rel + adv1, 14) >> 10;  // 4 sign bits
      const int v3 = (v >> 3) & 1;
      const int v2 = (v >> 2) & 1;
      const int v1 = (v >> 1) & 1;
      const int v0 = v & 1;
      const int o1 = v3;
      const int o2 = v3 + v2;
      const int o3 = o2 + v1;
      const int p_cnt = qq + o3 + v0;
      if (p_cnt > pend) break;  // overshoot: the quad is dropped, decode stops
      out.push(pair(v3 ? 1 - 2 * ((sb >> 3) & 1) : 0, v2 ? 1 - 2 * ((sb >> (3 - o1)) & 1) : 0));
      out.push(pair(v1 ? 1 - 2 * ((sb >> (3 - o2)) & 1) : 0, v0 ? 1 - 2 * ((sb >> (3 - o3)) & 1) : 0));
      p = p_cnt;
      q += 1;
    }
  }
  if (bad) {
    out.clear();
  } else {
    out.zeros(kWords - out.pos);
  }
  big_end[d] = bad ? 0 : 2 * n;
  count1_end[d] = bad ? 0 : 2 * n + 4 * q;
}

// covered[dest[i]] = 1 for every lane with a row.
__global__ void mark_rows_kernel(const int32_t* __restrict__ dest, int npad, int n_rows,
                                 uint8_t* __restrict__ covered) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const int d = dest[i];
  if (d >= 0 && d < n_rows) covered[d] = 1;
}

// Zero the rows (and their ends) that no lane writes.
__global__ void zero_rows_kernel(const uint8_t* __restrict__ covered, int n_rows,
                                 int16_t* __restrict__ spec_rows, int32_t* __restrict__ big_end,
                                 int32_t* __restrict__ count1_end) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows || covered[r]) return;
  uint4* row = reinterpret_cast<uint4*>(spec_rows + static_cast<int64_t>(r) * kRows);
  for (int c = 0; c < kChunks; ++c) row[c] = make_uint4(0u, 0u, 0u, 0u);
  big_end[r] = 0;
  count1_end[r] = 0;
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). `luts`
// holds the four tables back to back (A: 16x256, B: n_l2x32, C: n_l3x64,
// CT: 2x64), each entry ab | field << 8. `covered` is n_rows bytes of
// scratch. lanes is a multiple of 256; spec_rows is 16-byte aligned.
extern "C" int mg_cuda_entropy_decode_rows(const void* scalars, int scal_cols,
                                           const void* buf, const void* meta,
                                           const void* luts, int n_l2, int n_l3,
                                           const void* dest, int nb, int lanes,
                                           void* spec_rows, void* big_end,
                                           void* count1_end, void* covered,
                                           int n_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npad = nb * lanes;
  if (n_rows > 0) {
    cudaError_t err = cudaMemsetAsync(covered, 0, static_cast<size_t>(n_rows), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (npad > 0) {
      mark_rows_kernel<<<(npad + 255) / 256, 256, 0, s>>>(
          static_cast<const int32_t*>(dest), npad, n_rows, static_cast<uint8_t*>(covered));
    }
    zero_rows_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(
        static_cast<const uint8_t*>(covered), n_rows, static_cast<int16_t*>(spec_rows),
        static_cast<int32_t*>(big_end), static_cast<int32_t*>(count1_end));
    if (cudaPeekAtLastError() != cudaSuccess) return static_cast<int>(cudaGetLastError());
  }
  if (npad == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(lut_padded(n_l2, n_l3)) * sizeof(uint16_t) +
                      static_cast<size_t>(kThreads) * kLineStride * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        entropy_decode_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = nb * (lanes / kThreads);
  entropy_decode_rows_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int32_t*>(scalars), scal_cols,
      static_cast<const int32_t*>(buf), static_cast<const uint16_t*>(meta),
      static_cast<const int32_t*>(luts), n_l2, n_l3, static_cast<const int32_t*>(dest), n_rows,
      static_cast<int16_t*>(spec_rows), static_cast<int32_t*>(big_end),
      static_cast<int32_t*>(count1_end), lanes);
  return static_cast<int>(cudaGetLastError());
}
