// MP3 Layer III Huffman decode on Hopper: one thread per granule-channel.
//
// Replaces the Pallas kernel mp3rgain_tpu/decode/entropy_kernel.py::_kernel
// (built by _decode_call, driven by decode_blocks). Inputs are that
// kernel's, unchanged: prepare_batch's sorted blocks of LANES lanes, the
// ragged (g_pad, 8, 128) big-endian word buffer with one word-group offset
// per 128-lane subgroup, and the 5 packed uint16 meta rows per lane.
// Outputs are its outputs: spec_b (nb, 576, LANES) int16 and mout
// (nb, 8, LANES) int32, exactly.
//
// What bounds it on this card: the decode is a serial chain per lane (each
// codeword's length decides where the next one starts), so its limit is
// the latency of that chain and warp divergence as much as bytes: a
// 64x60 s batch reads ~0.15 GB of words and writes ~0.9 GB of spectra
// (~0.3 ms of HBM time at 3.35 TB/s) while each lane runs up to 288
// dependent steps. The design keeps each step short and hides latency with
// many lanes:
//   - one thread per lane and one 128-thread block per ragged subgroup,
//     the lane the minor index of every array, so a warp's word loads and
//     its spectrum stores fall on adjacent addresses;
//   - prepare_batch's sort by estimated step count keeps a warp's lanes at
//     similar lengths, so divergence stays small;
//   - the Huffman tables live in shared memory as plain per-window tables
//     (ab | field << 8, 24 KB), one lookup per level, instead of the TPU's
//     one-hot MXU matmuls;
//   - each lane keeps the three words its current step can touch in
//     registers and fetches one new word as its bit position advances,
//     instead of the TPU's select-sum over word-groups;
//   - every value is stored once, where it belongs (big pairs at rows 2k,
//     count1 quads at 2*bvp + 4j), instead of the TPU's 8-row pending
//     flush and barrel-shift placement.
//
// Exactness against the lockstep kernel: a lane's state changes only on
// steps where it is active, and once inactive it never becomes active
// again, so stopping a lane's loop at its first inactive step reproduces
// the lockstep run. Each loop is bounded both by the lane's own state and
// by the block's nbig/ncnt from scalars, as the lockstep loops are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSubg = 128;  // lanes per subgroup = threads per block
constexpr int kRows = 576;
constexpr int kMetaRows = 5;
constexpr int kMoutRows = 8;
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

__global__ void __launch_bounds__(kSubg)
entropy_decode_kernel(const int32_t* __restrict__ scalars, int scal_cols,
                      const int32_t* __restrict__ buf,
                      const uint16_t* __restrict__ meta,
                      const int32_t* __restrict__ luts, int n_l2, int n_l3,
                      int16_t* __restrict__ spec, int32_t* __restrict__ mout,
                      int lanes) {
  extern __shared__ uint16_t s_lut[];
  const int n_lut = kGroupsA * kL1Win + n_l2 * kL2Win + n_l3 * kL3Win + 2 * kCtWin;
  for (int i = threadIdx.x; i < n_lut; i += blockDim.x) {
    s_lut[i] = static_cast<uint16_t>(luts[i]);
  }
  __syncthreads();
  const uint16_t* lut_a = s_lut;
  const uint16_t* lut_b = lut_a + kGroupsA * kL1Win;
  const uint16_t* lut_c = lut_b + n_l2 * kL2Win;
  const uint16_t* lut_ct = lut_c + n_l3 * kL3Win;

  const int n_sg = lanes / kSubg;
  const int blk = blockIdx.x / n_sg;
  const int sg = blockIdx.x % n_sg;
  const int l = sg * kSubg + threadIdx.x;
  const int32_t* sc = scalars + static_cast<int64_t>(blk) * scal_cols;
  const int nbig = sc[0];
  const int ncnt = sc[1];

  Words words;
  words.lane = buf + static_cast<int64_t>(sc[3 + sg]) * (8 * kSubg) + threadIdx.x;
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
  const int bvp = w1 & 511;
  const int g0 = (w1 >> 9) & 15;
  const int r0p = w2 & 511;
  const int g1 = (w2 >> 9) & 15;
  const int r1p = w3 & 511;
  const int g2 = (w3 >> 9) & 15;
  const int l0 = w4 & 15;
  const int l1 = (w4 >> 4) & 15;
  const int l2 = (w4 >> 8) & 15;

  int16_t* out = spec + static_cast<int64_t>(blk) * kRows * lanes + l;
  int p = p0;
  int n = 0;
  int q = 0;
  int alive = 1;
  int bad_ever = 0;

  // --- phase 1: big-value pairs, pair k at rows (2k, 2k+1) ---------------
  for (int k = 0; k < nbig; ++k) {
    if (!(k < bvp && p < pend && alive)) break;
    words.seek(p);
    const int rel = p - (words.wi << 5);
    const int gbig = n < r0p ? g0 : (n < r1p ? g1 : g2);
    const int linb = n < r0p ? l0 : (n < r1p ? l1 : l2);

    const int ea = lut_a[gbig * kL1Win + extract(words.u0, words.u1, words.u2, rel, 8)];
    const int ab1 = ea & 255;
    const int adv1 = (ea >> 8) & 15;
    const int flag1 = ea >> 12;
    const bool cont = flag1 == 1;
    bool bad = flag1 == 3;
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
    if (bad) {
      alive = 0;
      bad_ever = 1;
      break;
    }
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
    out[(2 * k) * lanes] = static_cast<int16_t>(xv);
    out[(2 * k + 1) * lanes] = static_cast<int16_t>(yv);
    p = qq + o + ly + sy;
    n += 1;
  }
  for (int r = 2 * n; r < 2 * bvp; ++r) out[r * lanes] = 0;

  // --- phase 2: count1 quads, quad j at rows 2*bvp + 4j .. +3 ------------
  for (int j = 0; j < ncnt; ++j) {
    if (!(p < pend && alive && 2 * n + 4 * q + 4 <= kRows)) break;
    words.seek(p);
    const int rel = p - (words.wi << 5);
    const int ect = lut_ct[gct * kCtWin + extract(words.u0, words.u1, words.u2, rel, 6)];
    const int adv1 = (ect >> 8) & 15;
    if ((ect >> 12) == 3) {
      alive = 0;
      bad_ever = 1;
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
    if (p_cnt > pend) {  // overshoot: the quad is dropped, decode stops
      alive = 0;
      break;
    }
    const int row = 2 * bvp + 4 * j;
    out[row * lanes] = static_cast<int16_t>(v3 ? 1 - 2 * ((sb >> 3) & 1) : 0);
    out[(row + 1) * lanes] = static_cast<int16_t>(v2 ? 1 - 2 * ((sb >> (3 - o1)) & 1) : 0);
    out[(row + 2) * lanes] = static_cast<int16_t>(v1 ? 1 - 2 * ((sb >> (3 - o2)) & 1) : 0);
    out[(row + 3) * lanes] = static_cast<int16_t>(v0 ? 1 - 2 * ((sb >> (3 - o3)) & 1) : 0);
    p = p_cnt;
    q += 1;
  }
  for (int r = 2 * bvp + 4 * q; r < kRows; ++r) out[r * lanes] = 0;

  int32_t* mo = mout + static_cast<int64_t>(blk) * kMoutRows * lanes + l;
  mo[0] = bad_ever ? 0 : 2 * n;          // big_end
  mo[lanes] = bad_ever ? 0 : 2 * n + 4 * q;  // count1_end
  mo[2 * lanes] = bad_ever;
  mo[3 * lanes] = p;
  mo[4 * lanes] = n;
  mo[5 * lanes] = q;
  mo[6 * lanes] = alive;
  mo[7 * lanes] = 0;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). `luts`
// holds the four tables back to back (A: 16x256, B: n_l2x32, C: n_l3x64,
// CT: 2x64), each entry ab | field << 8.
extern "C" int mg_cuda_entropy_decode(const void* scalars, int scal_cols,
                                      const void* buf, const void* meta,
                                      const void* luts, int n_l2, int n_l3,
                                      void* spec, void* mout, int nb,
                                      int lanes, void* stream) {
  const int n_lut = kGroupsA * kL1Win + n_l2 * kL2Win + n_l3 * kL3Win + 2 * kCtWin;
  const size_t smem = static_cast<size_t>(n_lut) * sizeof(uint16_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        entropy_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = nb * (lanes / kSubg);
  entropy_decode_kernel<<<grid, kSubg, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(scalars), scal_cols,
      static_cast<const int32_t*>(buf), static_cast<const uint16_t*>(meta),
      static_cast<const int32_t*>(luts), n_l2, n_l3,
      static_cast<int16_t*>(spec), static_cast<int32_t*>(mout), lanes);
  return static_cast<int>(cudaGetLastError());
}
