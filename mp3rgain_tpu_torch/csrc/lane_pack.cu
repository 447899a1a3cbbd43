// K0, the lane pack: the entropy decode's lane-major input, built on the
// card from rows the host copied in walk order.
//
// It replaces no TPU kernel. It replaces a host transpose: the JAX package
// and the port's old path build the (g_pad, 8, 128) big-endian word buffer
// and the (nb, 5, LANES) meta block of decode/entropy_kernel.prepare_batch
// on the host (_native/mp3dec.cpp mg_entropy_pack4), gathering word k of 128
// sorted, randomly placed md rows into one line, which is bound by host
// memory and was most of a batch's host prep. The host now only plans (the
// lane sort, the subgroup extents and offsets) and copies each row's used
// words back to back (_host/lane_plan.cpp); this kernel writes exactly what
// mg_entropy_pack4 wrote, which K1 (entropy_decode.cu) reads unchanged:
//   - subgroup (b, s)'s words at word-group offset scalars[b, 3 + s], its
//     extent w8 groups (the next subgroup's offset minus its own, g_real
//     after the last); line k of the subgroup holds word k of its 128
//     lanes, byte-swapped from the stream's big-endian order, and 0 past a
//     lane's used words (padding lanes have none);
//   - meta rows j of block b: the packed uint16 meta word j of each sorted
//     lane, 0 for padding lanes;
//   - groups [g_real, g_pad), which no subgroup owns, are zeroed.
//
// What bounds it: bytes. A 640,000-row batch reads about 90 MB of words and
// writes about 96 MB of buffer, some 0.06 ms at 3.35 TB/s; there is no
// arithmetic to speak of. The design:
//   - one block per 128-lane subgroup; each warp reads whole rows of its
//     lanes, a row's words by consecutive threads (coalesced), four rows at
//     a time with every load issued before any is stored, so enough reads
//     are in flight to cover the latency;
//   - the block transposes through shared memory, a 136-word x 128-lane
//     tile with a pitch of 129 words, so both the column writes of the
//     loads and the row reads of the stores are free of bank conflicts
//     (69 KB of dynamic shared memory, three blocks an SM);
//   - each line of the buffer (128 int32) is stored by consecutive threads,
//     coalesced; the meta rows likewise, by the first 128 threads;
//   - blocks past the subgroups zero the tail groups with 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSubg = 128;    // lanes per ragged subgroup
constexpr int kLanes = 2048;  // lanes per sorted block
constexpr int kSgPerBlock = kLanes / kSubg;
constexpr int kScalCols = 3 + kSgPerBlock;
constexpr int kMetaRows = 5;
constexpr int kMaxWords = 136;  // W8_MAX word-groups of 8 words
constexpr int kPitch = kSubg + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsAtOnce = 4;
constexpr int kLoadsPerRow = (kMaxWords + 31) / 32;
constexpr int kSmemBytes = kMaxWords * kPitch * 4;
constexpr int kTailBlocksMax = 1024;

__global__ void __launch_bounds__(kThreads)
lane_pack_kernel(const int32_t* __restrict__ scalars, const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ word_off, const uint16_t* __restrict__ meta5,
                 const int32_t* __restrict__ order, int n, int nsg, int g_real, int g_pad,
                 int32_t* __restrict__ buf, uint16_t* __restrict__ metab) {
  extern __shared__ uint32_t s_tile[];  // [kMaxWords][kPitch]
  __shared__ int s_start[kSubg];
  __shared__ int s_cnt[kSubg];
  const int tid = threadIdx.x;
  const int sg = blockIdx.x;

  if (sg >= nsg) {  // the tail groups no subgroup owns
    int4* tail = reinterpret_cast<int4*>(buf + static_cast<int64_t>(g_real) * 8 * kSubg);
    const int64_t count = static_cast<int64_t>(g_pad - g_real) * 8 * kSubg / 4;
    const int64_t stride = static_cast<int64_t>(gridDim.x - nsg) * kThreads;
    for (int64_t i = static_cast<int64_t>(sg - nsg) * kThreads + tid; i < count; i += stride)
      tail[i] = make_int4(0, 0, 0, 0);
    return;
  }

  const int b = sg / kSgPerBlock;
  const int s = sg % kSgPerBlock;
  const int off = scalars[b * kScalCols + 3 + s];
  const int next = sg + 1 < nsg
      ? scalars[((sg + 1) / kSgPerBlock) * kScalCols + 3 + (sg + 1) % kSgPerBlock]
      : g_real;
  const int nwords = (next - off) * 8;

  if (tid < kSubg) {
    const int src = order[static_cast<int64_t>(sg) * kSubg + tid];
    int start = 0;
    int cnt = 0;
    uint16_t m[kMetaRows] = {0, 0, 0, 0, 0};
    if (src < n) {
      start = word_off[src];
      cnt = word_off[src + 1] - start;
#pragma unroll
      for (int j = 0; j < kMetaRows; ++j) m[j] = meta5[static_cast<int64_t>(src) * kMetaRows + j];
    }
    s_start[tid] = start;
    s_cnt[tid] = cnt;
    uint16_t* mb = metab + static_cast<int64_t>(b) * kMetaRows * kLanes + s * kSubg + tid;
#pragma unroll
    for (int j = 0; j < kMetaRows; ++j) mb[j * kLanes] = m[j];
  }
  __syncthreads();
  if (nwords == 0) return;  // an all-padding subgroup owns no groups

  // Loads: warp w takes lanes w*4 .. w*4+3, then 32 further on, and so on.
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int li0 = warp * kRowsAtOnce; li0 < kSubg; li0 += kWarps * kRowsAtOnce) {
    uint32_t v[kRowsAtOnce][kLoadsPerRow];
#pragma unroll
    for (int r = 0; r < kRowsAtOnce; ++r) {
      const uint32_t* row = words + s_start[li0 + r];
      const int cnt = s_cnt[li0 + r];
#pragma unroll
      for (int j = 0; j < kLoadsPerRow; ++j) {
        const int k = lane + 32 * j;
        v[r][j] = k < cnt ? row[k] : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsAtOnce; ++r) {
      const int cnt = s_cnt[li0 + r];
#pragma unroll
      for (int j = 0; j < kLoadsPerRow; ++j) {
        const int k = lane + 32 * j;
        if (k < cnt) s_tile[k * kPitch + li0 + r] = v[r][j];
      }
    }
  }
  __syncthreads();

  // Stores: line k of the subgroup is 128 consecutive int32.
  int32_t* out = buf + static_cast<int64_t>(off) * 8 * kSubg;
  for (int i = tid; i < nwords * kSubg; i += kThreads) {
    const int k = i / kSubg;
    const int li = i % kSubg;
    const uint32_t w = k < s_cnt[li] ? __byte_perm(s_tile[k * kPitch + li], 0u, 0x0123) : 0u;
    out[i] = static_cast<int32_t>(w);
  }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). scalars
// (nb, scal_cols) int32, words (word_off[n],) uint32, word_off (n + 1,)
// int32, meta5 (n, 5) uint16, order (nb * 2048,) int32; buf (g_pad, 8, 128)
// int32 and metab (nb, 5, 2048) uint16 are written whole. Every row's
// word count is at most 136 and every subgroup's extent at most 17 groups
// (the planner's caps).
extern "C" int mg_cuda_lane_pack(const void* scalars, int scal_cols, const void* words,
                                 const void* word_off, const void* meta5, const void* order,
                                 int n, int nb, int g_real, int g_pad, void* buf, void* metab,
                                 void* stream) {
  if (scal_cols != kScalCols || nb < 1 || g_real < 0 || g_pad < g_real)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lane_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nsg = nb * kSgPerBlock;
  const int64_t tail_vec = static_cast<int64_t>(g_pad - g_real) * 8 * kSubg / 4;
  int64_t tail_blocks = (tail_vec + kThreads - 1) / kThreads;
  if (tail_blocks > kTailBlocksMax) tail_blocks = kTailBlocksMax;
  lane_pack_kernel<<<nsg + static_cast<int>(tail_blocks), kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(scalars), static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(word_off), static_cast<const uint16_t*>(meta5),
      static_cast<const int32_t*>(order), n, nsg, g_real, g_pad, static_cast<int32_t*>(buf),
      static_cast<uint16_t*>(metab));
  return static_cast<int>(cudaGetLastError());
}
