// MP3 Layer III hybrid synthesis on Hopper: alias reduction, the 36-point
// IMDCT of each subband and the long windows (K4).
//
// Replaces no Pallas kernel. The JAX package ran this stage as XLA dots
// (mp3rgain_tpu/decode/hybrid_kernel.py hybrid_xla), and the port first
// ran it the same way on cuBLAS (hybrid_kernel.hybrid_gemm, now the plain
// version): three dense (R, 576) @ (576, 1152) f32 products over masked
// copies of the spectra, about 1.37 M multiply-adds a row. The map they
// apply is block-diagonal: alias butterflies, then one 36 x 18 matrix per
// subband, about 21 k multiply-adds a row. Written because the dense
// products were the largest share of the library rescan's device time
// (on an H100: cuBLAS f32 GEMMs, 13.7 of 30.3 busy seconds of a traced
// window).
//
// Input: xr (rows, 576) f32 in natural spectral order (K2's output) and the
// rows' (rows, 16) int32 fields (hybrid_kernel.GM_*; GM_CLS, GM_BT read).
// Output: (rows, 1152) f32, head (columns 18·sb + w, w < 18) | tail
// (576 + 18·sb + w − 18), exactly the map hybrid_gemm applies:
//   - gather the row into its class's layout order, layout line j reading
//     natural line perms[cls][j] (identity for long rows);
//   - alias butterflies between lines 18·sb + 17 − i and 18·sb + 18 + i at
//     every subband boundary (long rows) or boundary 0 (mixed rows);
//   - per subband, 36 outputs of one 36 x 18 map: the unwindowed long
//     IMDCT then the block type's window (long rows), the windowed short
//     composite (short rows, mixed rows at sb >= 2) or the windowed long
//     map (mixed rows at sb < 2). A row of no class writes zeros, as the
//     plain version's masked products do.
// The constants are hybrid_kernel.synthesis_consts, built on the host in
// float64 and stored as f32; nothing is evaluated here but multiply-adds,
// all f32 (no TF32, no fast-math).
//
// What bounds it on this card: bytes. A row reads 2,304 + 64 bytes and
// writes 4,608 (about 6.9 KB; 4.4 GB for a 640,000-row batch, 1.3 ms at
// 3.35 TB/s) against about 21 k multiply-adds, 3 per byte, under the
// card's f32 ridge of about 10. The design keeps the multiply-adds cheap
// enough to stay under the bytes:
//   - one warp per row, one lane per subband: the lane holds its 18 lines
//     in registers, the butterflies are two register shuffles per line
//     pair, and every lane of a warp reads the same map row from shared
//     memory (a broadcast; mixed rows read two), four coefficients a load;
//   - the row comes in and the outputs go out through a per-warp shared
//     buffer with 16-byte loads and stores, so global traffic is
//     coalesced whatever the class's permutation;
//   - the maps, windows, butterflies and permutations are staged once per
//     resident block (grid-stride blocks, as many as fit on the card).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 576;
constexpr int kOut = 1152;
constexpr int kLines = 18;     // lines per subband
constexpr int kW = 36;         // IMDCT outputs per subband
constexpr int kMaps = 3;
constexpr int kMapPitch = 20;  // a map row padded to 20 floats (16-byte rows)
constexpr int kGm = 16;        // gmeta words per row
constexpr int kGmBt = 6;       // hybrid_kernel.GM_BT
constexpr int kGmCls = 7;      // hybrid_kernel.GM_CLS
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
hybrid_synthesis_kernel(const float* __restrict__ xr, const int32_t* __restrict__ gmeta,
                        const float* __restrict__ maps, const float* __restrict__ wins,
                        const float* __restrict__ alias, const int32_t* __restrict__ perms,
                        float* __restrict__ out, int rows) {
  __shared__ __align__(16) float s_map[kMaps * kW * kMapPitch];
  __shared__ float s_win[4 * kW];
  __shared__ float s_cs[8];
  __shared__ float s_ca[8];
  __shared__ int16_t s_perm[kMaps * kRow];
  __shared__ __align__(16) float s_buf[kWarps][kOut];

  for (int i = threadIdx.x; i < kMaps * kW * kMapPitch; i += blockDim.x) {
    const int m = i / kMapPitch;
    const int k = i - m * kMapPitch;
    s_map[i] = k < kLines ? maps[m * kLines + k] : 0.0f;
  }
  for (int i = threadIdx.x; i < 4 * kW; i += blockDim.x) s_win[i] = wins[i];
  if (threadIdx.x < 8) {
    s_cs[threadIdx.x] = alias[threadIdx.x];
    s_ca[threadIdx.x] = alias[8 + threadIdx.x];
  }
  for (int i = threadIdx.x; i < kMaps * kRow; i += blockDim.x)
    s_perm[i] = static_cast<int16_t>(perms[i]);
  __syncthreads();

  const int lane = threadIdx.x & 31;  // the subband this lane computes
  const int warp = threadIdx.x >> 5;
  float* buf = s_buf[warp];
  float4* buf4 = reinterpret_cast<float4*>(buf);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + warp; r < rows; r += stride) {
    const int cls = __ldg(gmeta + r * kGm + kGmCls);
    const int bt = __ldg(gmeta + r * kGm + kGmBt);
    float4* dst = reinterpret_cast<float4*>(out + r * kOut);
    if (cls < 0 || cls > 2) {
      for (int i = lane; i < kOut / 4; i += 32) dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float4* src = reinterpret_cast<const float4*>(xr + r * kRow);
    for (int i = lane; i < kRow / 4; i += 32) buf4[i] = __ldg(src + i);
    __syncwarp();

    // This subband's 18 lines in the class's layout order.
    float x[kLines];
    const int16_t* perm = s_perm + cls * kRow + kLines * lane;
#pragma unroll
    for (int m = 0; m < kLines; ++m) x[m] = buf[perm[m]];
    __syncwarp();  // every lane holds its lines before buf takes outputs

    // Alias butterflies: boundary lane|lane+1 moves lines 17-i of this
    // lane, boundary lane-1|lane lines i (ISO 11172-3 2.4.3.4.10.1).
    if (cls != 1) {
      const bool up = cls == 0 ? lane < 31 : lane == 0;
      const bool dn = cls == 0 ? lane > 0 : lane == 1;
      float nxt[8], prv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        nxt[i] = __shfl_down_sync(kFull, x[i], 1);       // lane + 1's line i
        prv[i] = __shfl_up_sync(kFull, x[17 - i], 1);    // lane - 1's line 17 - i
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (up) x[17 - i] = x[17 - i] * s_cs[i] - nxt[i] * s_ca[i];
        if (dn) x[i] = x[i] * s_cs[i] + prv[i] * s_ca[i];
      }
    }

    const int mi = cls == 0 ? 0 : ((cls == 2 && lane < 2) ? 2 : 1);
    const float* mrow = s_map + mi * kW * kMapPitch;
    const float* win = s_win + (bt == 1 ? 1 : (bt == 3 ? 3 : 0)) * kW;
    float* head = buf + kLines * lane;
#pragma unroll 2
    for (int w = 0; w < kW; ++w) {
      const float4* c4 = reinterpret_cast<const float4*>(mrow + w * kMapPitch);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 c = c4[q];
        acc += c.x * x[4 * q];
        acc += c.y * x[4 * q + 1];
        acc += c.z * x[4 * q + 2];
        acc += c.w * x[4 * q + 3];
      }
      const float2 c2 = *reinterpret_cast<const float2*>(mrow + w * kMapPitch + 16);
      acc += c2.x * x[16];
      acc += c2.y * x[17];
      if (cls == 0) acc *= win[w];
      head[w < kLines ? w : kRow + w - kLines] = acc;
    }
    __syncwarp();
    for (int i = lane; i < kOut / 4; i += 32) dst[i] = buf4[i];
    __syncwarp();  // the stores have read buf before the next row lands
  }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). rows >= 1
// (the wrapper returns early on none). maps (3, 36, 18), wins (4, 36),
// alias (2, 8) f32; perms (3, 576) int32, values below 576.
extern "C" int mg_cuda_hybrid_synthesis(const void* xr, const void* gmeta, const void* maps,
                                        const void* wins, const void* alias, const void* perms,
                                        void* out, int rows, void* stream) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hybrid_synthesis_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (static_cast<int64_t>(rows) + kWarps - 1) / kWarps;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  hybrid_synthesis_kernel<<<static_cast<int>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const int32_t*>(gmeta),
      static_cast<const float*>(maps), static_cast<const float*>(wins),
      static_cast<const float*>(alias), static_cast<const int32_t*>(perms),
      static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
