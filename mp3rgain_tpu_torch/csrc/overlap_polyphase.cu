// MP3 Layer III overlap-add and polyphase synthesis on Hopper (K5).
//
// Replaces no Pallas kernel. The JAX package ran this stage as XLA dots
// (the polyphase products of mp3rgain_tpu/decode/hybrid_kernel.py's light
// tail), and the port first ran it the same way on cuBLAS
// (synthesis.overlap_polyphase_reference, now the plain version): two
// shifted copies of the hybrid outputs, then two dense (576, 576) f32
// products a granule-time, about 663 k multiply-adds. The map they apply
// is, for each of a granule's 18 slots, the 64 x 32 matrixing and the
// 16-tap dewindow: about 46 k multiply-adds. Written because those
// products were the rescan's second-largest device stage (on an H100:
// 6.25 of 30.3 busy seconds of a traced window).
//
// Input: z (S, T, 1152) f32, S = channels x tracks sequences of T
// granule-times, each row head | tail as hybrid_synthesis.cu writes it.
// Output: pcm (S, T·576) f32, what the plain version computes:
//   out18[t] = head[t] + tail[t − 1] (zeros before t = 0);
//   s[sb] of slot i = out18[t][18·sb + i], negated for odd sb and odd i
//   (frequency inversion); V[u] = Σ_sb N[u][sb]·s[sb] (N: 64 x 32);
//   pcm[32·slot + j] = Σ_k D[k][j]·V_{slot−k}[j + 32·(k odd)], k < 16,
//   V of slots before the track's first zero.
// N and D are decode.tables' matrixing and dewindow taps, built on the
// host in float64 and stored as f32; all arithmetic is f32 multiply-add
// (no TF32, no fast-math).
//
// What bounds it on this card: bytes, narrowly. A granule-time reads its
// 4,608 bytes of z once and writes 2,304 of PCM (about 6.9 KB; 4.4 GB for a
// 640,000-row batch, 1.3 ms at 3.35 TB/s) against about 46 k multiply-adds,
// 7 per byte, near the card's f32 ridge of about 10. The design:
//   - a block walks a run of 64 consecutive granule-times of one
//     sequence, 4 at a time (72 slots), so each z row is read once and V's
//     last 15 slots stay in shared memory from one step to the next; a run
//     that starts mid-track first recomputes them from its halo (the head
//     of the granule before it and the tail of the one before that);
//   - the matrixing is a 72 x 64 x 32 product out of shared memory with a
//     4 x 4 register tile a thread (two 16-byte loads per 16 multiply-adds);
//   - the dewindow gives each thread one output column j and 8
//     consecutive slots: its 16 taps D[·][j] live in registers and each V
//     value it loads serves up to 8 outputs;
//   - z is read and PCM written with coalesced loads and stores; the
//     matrixing taps are staged once per resident block (grid-stride
//     blocks over the runs, as many as fit on the card).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kZ = 1152;     // floats of a z row (head | tail)
constexpr int kHalf = 576;   // PCM samples of a granule-time
constexpr int kRun = 64;     // granule-times a block walks
constexpr int kStep = 4;     // granule-times a step
constexpr int kSlots = 18 * kStep;
constexpr int kHist = 15;    // V slots a step carries into the next
constexpr int kThreads = 288;  // 18 x 16 matrixing tiles; 9 warps of dewindow
static_assert(kRun % kStep == 0, "runs are whole steps");
static_assert(kThreads == (kSlots / 4) * 16, "one 4 x 4 tile a thread");
static_assert(kThreads == 32 * (kSlots / 8), "8 output slots a thread");

__global__ void __launch_bounds__(kThreads)
overlap_polyphase_kernel(const float* __restrict__ z, const float* __restrict__ nmat,
                         const float* __restrict__ dwin, float* __restrict__ pcm, int seqs,
                         int T) {
  __shared__ __align__(16) float s_nt[32 * 64];               // N transposed: [sb][u]
  __shared__ __align__(16) float s_in[32 * kSlots];           // [sb][slot], signs applied
  __shared__ __align__(16) float s_v[(kHist + kSlots) * 64];  // [carried | this step][u]

  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * 32; i += kThreads) {
    const int u = i >> 5;
    const int sb = i & 31;
    s_nt[sb * 64 + u] = nmat[i];
  }
  const int lane = tid & 31;  // dewindow: output column j
  const int warp = tid >> 5;  // dewindow: slots 8·warp .. 8·warp + 7
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = __ldg(dwin + 32 * k + lane);
  const int sg = tid >> 4;  // matrixing: slots 4·sg .. 4·sg + 3
  const int ug = tid & 15;  // matrixing: u 4·ug .. 4·ug + 3

  const int runs_per_seq = (T + kRun - 1) / kRun;
  const int64_t runs = static_cast<int64_t>(seqs) * runs_per_seq;
  for (int64_t run = blockIdx.x; run < runs; run += gridDim.x) {
    const int64_t q = run / runs_per_seq;
    const int t0 = static_cast<int>(run - q * runs_per_seq) * kRun;
    const int t_end = min(t0 + kRun, T);
    const float* zq = z + q * T * kZ;
    float* pq = pcm + q * T * kHalf;
    __syncthreads();  // the previous run is done with s_v (and the taps are staged)
    for (int i = tid; i < kHist * 64; i += kThreads) s_v[i] = 0.0f;

    // A run that starts mid-track begins one step early: that step loads
    // only granule t0 - 1 and writes nothing, so the carry holds its V.
    for (int ts = t0 > 0 ? t0 - kStep : t0; ts < t_end; ts += kStep) {
      const bool halo = ts < t0;
      // 1. out18 = head[t] + tail[t - 1] into s_in, frequency inversion applied.
      for (int it = tid; it < kStep * (kHalf / 4); it += kThreads) {
        const int g = it / (kHalf / 4);
        const int c = (it - g * (kHalf / 4)) * 4;
        const int t = ts + g;
        float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 p = h;
        if (halo ? g == kStep - 1 : t < t_end) {
          h = __ldg(reinterpret_cast<const float4*>(zq + static_cast<int64_t>(t) * kZ + c));
          if (t > 0)
            p = __ldg(reinterpret_cast<const float4*>(
                zq + static_cast<int64_t>(t - 1) * kZ + kHalf + c));
        }
        const float v[4] = {h.x + p.x, h.y + p.y, h.z + p.z, h.w + p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sb = (c + e) / 18;
          const int i = c + e - 18 * sb;
          s_in[sb * kSlots + 18 * g + i] = (sb & i & 1) ? -v[e] : v[e];
        }
      }
      __syncthreads();

      // 2. matrixing: V rows kHist .. kHist + 71 of this step.
      {
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 8
        for (int sb = 0; sb < 32; ++sb) {
          const float4 s = *reinterpret_cast<const float4*>(s_in + sb * kSlots + 4 * sg);
          const float4 n = *reinterpret_cast<const float4*>(s_nt + sb * 64 + 4 * ug);
          const float sv[4] = {s.x, s.y, s.z, s.w};
          const float nv[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] += sv[a] * nv[b];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(s_v + (kHist + 4 * sg + a) * 64 + 4 * ug) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
      __syncthreads();

      // 3. dewindow: slot q of this step reads V rows q .. q + 15.
      if (!halo) {
        const int q0 = 8 * warp;
        float o[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) o[a] = 0.0f;
#pragma unroll
        for (int rr = 0; rr < 8 + kHist; ++rr) {
          const float* vrow = s_v + (q0 + rr) * 64;
          const float lo = vrow[lane];
          const float hi = vrow[32 + lane];
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const int k = kHist + a - rr;
            if (k >= 0 && k < 16) o[a] += d[k] * ((k & 1) ? hi : lo);
          }
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int slot = q0 + a;
          if (ts + slot / 18 < t_end)
            pq[static_cast<int64_t>(ts) * kHalf + 32 * slot + lane] = o[a];
        }
      }
      __syncthreads();

      // 4. carry V's last 15 slots to rows 0..14 (the next step's input
      // stage writes only s_in; its matrixing follows a barrier).
      for (int i = tid; i < kHist * 64; i += kThreads) s_v[i] = s_v[kSlots * 64 + i];
    }
  }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). seqs >= 1
// and T >= 1 (the wrapper returns early on an empty batch). nmat (64, 32)
// and dwin (16, 32) f32.
extern "C" int mg_cuda_overlap_polyphase(const void* z, const void* nmat, const void* dwin,
                                         void* pcm, int seqs, int T, void* stream) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, overlap_polyphase_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = static_cast<int64_t>(seqs) * ((T + kRun - 1) / kRun);
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  overlap_polyphase_kernel<<<static_cast<int>(grid), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(nmat),
      static_cast<const float*>(dwin), static_cast<float*>(pcm), seqs, T);
  return static_cast<int>(cudaGetLastError());
}
