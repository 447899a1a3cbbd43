// MP3 Layer III requantize + M/S and intensity stereo on Hopper.
//
// Replaces the Pallas kernel mp3rgain_tpu/decode/hybrid_kernel.py::
// _kernel_body (built by _fused_call, driven by fused_requant_stereo).
// Inputs are that kernel's: (C, R, 576) int16 Huffman values, (C, R, 64)
// int8 scalefactor slots and (C, R, 16) int32 per-row fields (GM_*), rows
// channel-major; the output is its output, (C, R, 576) f32 in natural
// spectral order. Per sample i of a row of layout class c:
//   x = sign(s)·2^(log2|s|·4/3)·2^(0.25(gg−210) − ½(1+sfs)(scf[slot_c(i)]
//       + preflag·pretab_c(i)) − 2·short_c(i)·sbg[win_c(i)])
// then M/S and intensity stereo across the two channels' rows, as
// hybrid_kernel.fused_requant_stereo_reference computes it (same
// exp2/log2 form; the exponent is a small dyadic rational, exact in f32
// in any order; the intensity ratios come from the plain version's own
// formula, tabulated at each integer is_pos).
//
// What bounds it on this card: bytes. Per row pair it reads 2 × (1152 +
// 64 + 64) bytes and writes 2 × 2304 (~7 KB; 2.1 GB for a 64 × 60 s
// batch, 0.63 ms at 3.35 TB/s) against ~20 flops and two SFU operations
// per sample. The design spends as few instructions per byte as it can:
//   - one thread owns 8 consecutive samples of a row PAIR (channel 0 and
//     channel 1 at the same row), so M/S and intensity stereo stay in
//     registers: one 16-byte load of int16 per channel, two 16-byte f32
//     stores per channel (576 = 72 chunks of 8, so no masks in a row);
//   - the per-(class, sample) tables (scalefactor slot, subblock window,
//     pretab, short flag, intensity band start) are packed into one
//     32-bit word (hybrid_kernel.pack_class_words) and staged once per
//     block in shared memory with the 2 KB intensity-ratio table: a
//     sample reads one shared word instead of five global gathers;
//   - a row's 16 gmeta words are four 16-byte loads, the same address
//     for every thread of the row (one broadcast transaction per warp);
//     the scalefactor byte a sample needs is an L1 hit in its 64-byte row;
//   - grid-stride blocks, as many as fit on the card at once, so the
//     table staging is paid once per resident block, not once per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 576;
constexpr int kChunk = 8;                 // samples per thread
constexpr int kChunks = kRow / kChunk;    // 72 threads' worth per row
constexpr int kGm = 16;                   // gmeta words per row
constexpr int kScf = 64;                  // scalefactor slots per row
constexpr int kIsPosN = 64;               // is_pos values the ratio table covers
constexpr int kRatioN = 2 * 2 * kIsPosN * 2;  // (lsf, intensity_scale, is_pos, [kl, kr])
constexpr int kThreads = 256;
constexpr float kSqrt2Inv = 0.70710677f;  // float32(1/sqrt(2)), as the plain version

// One row's scalars (hybrid_kernel.GM_* layout).
struct Row {
  const int8_t* scf;
  float base;      // 0.25 * (global_gain - 210)
  float scf_mult;  // 0.5 * (1 + scalefac_scale)
  float preflag;
  float sbg0, sbg1, sbg2;
  int cls;         // layout class: 0 long, 1 short, 2 mixed
};

__device__ __forceinline__ Row load_row(const int32_t* gm, const int8_t* scf,
                                        int4* g2, int4* g3) {
  const int4* v = reinterpret_cast<const int4*>(gm);
  const int4 a = __ldg(v);      // gg, sfs, preflag, sbg0
  const int4 b = __ldg(v + 1);  // sbg1, sbg2, block_type, cls
  *g2 = __ldg(v + 2);           // ms, is, lsf, intensity_scale
  *g3 = __ldg(v + 3);           // rzero of the partner channel, ...
  Row r;
  r.scf = scf;
  r.base = 0.25f * (static_cast<float>(a.x) - 210.0f);
  r.scf_mult = 0.5f * (1.0f + static_cast<float>(a.y));
  r.preflag = static_cast<float>(a.z);
  r.sbg0 = static_cast<float>(a.w);
  r.sbg1 = static_cast<float>(b.x);
  r.sbg2 = static_cast<float>(b.y);
  r.cls = b.w;
  return r;
}

// Class word fields (hybrid_kernel.pack_class_words).
__device__ __forceinline__ int cw_slot(uint32_t w) { return static_cast<int>(w & 127u) - 1; }
__device__ __forceinline__ int cw_win(uint32_t w) { return static_cast<int>((w >> 7) & 3u) - 1; }
__device__ __forceinline__ float cw_pretab(uint32_t w) { return static_cast<float>((w >> 9) & 3u); }
__device__ __forceinline__ float cw_short(uint32_t w) { return static_cast<float>((w >> 11) & 1u); }
__device__ __forceinline__ int cw_band_start(uint32_t w) { return static_cast<int>((w >> 12) & 1023u); }

// Requantize one sample; *scf_s gets the sample's scalefactor (0 without
// a slot), which is channel 1's intensity position.
__device__ __forceinline__ float requant(int s, uint32_t w, const Row& r, int* scf_s) {
  const int slot = cw_slot(w);
  const int sc = slot >= 0 ? static_cast<int>(__ldg(r.scf + slot)) : 0;
  *scf_s = sc;
  const int win = cw_win(w);
  const float sbg = win == 0 ? r.sbg0 : (win == 1 ? r.sbg1 : (win == 2 ? r.sbg2 : 0.0f));
  const float e = r.base - r.scf_mult * (static_cast<float>(sc) + r.preflag * cw_pretab(w)) -
                  2.0f * cw_short(w) * sbg;
  const float xm = exp2f(log2f(fabsf(static_cast<float>(s))) * (4.0f / 3.0f));
  return (s < 0 ? -xm : xm) * exp2f(e);
}

__device__ __forceinline__ int16_t half_of(uint32_t v, int hi) {
  return static_cast<int16_t>(hi ? (v >> 16) : (v & 0xFFFFu));
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(x[0], x[1], x[2], x[3]);
  d[1] = make_float4(x[4], x[5], x[6], x[7]);
}

template <int NCH>
__global__ void __launch_bounds__(kThreads)
requant_stereo_kernel(const int16_t* __restrict__ spec, const int8_t* __restrict__ scf,
                      const int32_t* __restrict__ gmeta, const uint32_t* __restrict__ class_words,
                      const float* __restrict__ is_ratio, float* __restrict__ out, int rows) {
  __shared__ __align__(16) uint32_t s_cw[3 * kRow];
  __shared__ __align__(16) float s_ratio[kRatioN];
  for (int i = threadIdx.x; i < 3 * kRow; i += blockDim.x) s_cw[i] = class_words[i];
  if (NCH == 2) {
    for (int i = threadIdx.x; i < kRatioN; i += blockDim.x) s_ratio[i] = is_ratio[i];
  }
  __syncthreads();

  const int items = rows * kChunks;
  for (int it = blockIdx.x * blockDim.x + threadIdx.x; it < items; it += gridDim.x * blockDim.x) {
    const int row = it / kChunks;
    const int col = (it - row * kChunks) * kChunk;
    const int64_t r0 = row;
    int4 g2a, g3a;
    const Row a = load_row(gmeta + r0 * kGm, scf + r0 * kScf, &g2a, &g3a);
    const uint4 sa = __ldg(reinterpret_cast<const uint4*>(spec + r0 * kRow + col));
    const uint32_t* cwa = s_cw + a.cls * kRow + col;
    const uint4 wa0 = *reinterpret_cast<const uint4*>(cwa);
    const uint4 wa1 = *reinterpret_cast<const uint4*>(cwa + 4);
    const uint32_t sva[4] = {sa.x, sa.y, sa.z, sa.w};
    const uint32_t wva[8] = {wa0.x, wa0.y, wa0.z, wa0.w, wa1.x, wa1.y, wa1.z, wa1.w};
    float x0[kChunk];
    int unused;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) x0[k] = requant(half_of(sva[k >> 1], k & 1), wva[k], a, &unused);

    if (NCH == 1) {
      store8(out + r0 * kRow + col, x0);
      continue;
    }

    const int64_t r1 = r0 + rows;
    int4 g2b, g3b;
    const Row b = load_row(gmeta + r1 * kGm, scf + r1 * kScf, &g2b, &g3b);
    const uint4 sb = __ldg(reinterpret_cast<const uint4*>(spec + r1 * kRow + col));
    const uint32_t* cwb = s_cw + b.cls * kRow + col;
    const uint4 wb0 = *reinterpret_cast<const uint4*>(cwb);
    const uint4 wb1 = *reinterpret_cast<const uint4*>(cwb + 4);
    const uint32_t svb[4] = {sb.x, sb.y, sb.z, sb.w};
    const uint32_t wvb[8] = {wb0.x, wb0.y, wb0.z, wb0.w, wb1.x, wb1.y, wb1.z, wb1.w};

    const bool ms = g2a.x == 1;
    const bool isf = g2a.y == 1;
    const bool lsf = g2a.z == 1;
    const bool isc = g2b.w == 1;  // intensity_scale is read from channel 1's row
    const int rzero = g3a.x;
    const float* ratio = s_ratio + (static_cast<int>(lsf) * 2 + static_cast<int>(isc)) * kIsPosN * 2;
    float left[kChunk], right[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      int is_pos;
      const float x1 = requant(half_of(svb[k >> 1], k & 1), wvb[k], b, &is_pos);
      float l = x0[k];
      float r = x1;
      if (ms) {
        l = (x0[k] + x1) * kSqrt2Inv;
        r = (x0[k] - x1) * kSqrt2Inv;
      }
      // Intensity: channel 0's band start at or past the partner's zero
      // bound; is_pos 7 is illegal (no intensity) in MPEG-1 streams.
      if (isf && cw_band_start(wva[k]) >= rzero && (lsf || is_pos != 7)) {
        const float2 kr = *reinterpret_cast<const float2*>(ratio + 2 * min(is_pos, kIsPosN - 1));
        l = kr.x * x0[k];
        r = kr.y * x0[k];
      }
      left[k] = l;
      right[k] = r;
    }
    store8(out + r0 * kRow + col, left);
    store8(out + r1 * kRow + col, right);
  }
}

template <int NCH>
int launch(const void* spec, const void* scf, const void* gmeta, const void* class_words,
           const void* is_ratio, void* out, int rows, cudaStream_t stream) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, requant_stereo_kernel<NCH>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (static_cast<int64_t>(rows) * kChunks + kThreads - 1) / kThreads;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  requant_stereo_kernel<NCH><<<static_cast<int>(grid), kThreads, 0, stream>>>(
      static_cast<const int16_t*>(spec), static_cast<const int8_t*>(scf),
      static_cast<const int32_t*>(gmeta), static_cast<const uint32_t*>(class_words),
      static_cast<const float*>(is_ratio), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). nch is 1
// or 2, rows >= 1 and rows * 72 < 2^31 (the wrapper checks both).
// class_words: (3, 576) uint32; is_ratio: (2, 2, 64, 2) f32.
extern "C" int mg_cuda_requant_stereo(const void* spec, const void* scf, const void* gmeta,
                                      const void* class_words, const void* is_ratio, void* out,
                                      int nch, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nch == 1) return launch<1>(spec, scf, gmeta, class_words, is_ratio, out, rows, s);
  return launch<2>(spec, scf, gmeta, class_words, is_ratio, out, rows, s);
}
