// Class-core GEMM in split bf16 ("bf16x3") on Hopper tensor cores.
//
// Replaces the Pallas kernel tools/hk_dotprobe.py::make(tile) (its body,
// :25-37): x is split into xh = bf16_rn(x) and xl = bf16_rn(x - xh), and
// each (576, 1152) core C_k arrives pre-split into chi/clo the same way;
//
//   z[c, r] = sum_k [row_core is NULL or row_core[c, r] == k] *
//             (xh @ chi_k + [npass >= 2] xh @ clo_k + [npass >= 3] xl @ chi_k)
//
// with bf16 operands and f32 accumulation (the lo x lo term is left out,
// as in the probe). With row_core NULL it is the probe's sum over cores;
// with row_core = the layout class it is the host-decoded decode path's
// three class-core GEMMs plus the per-row class select
// (mp3rgain_tpu/decode/synthesis.py::_imdct_overlap_fused), in one pass
// and one output.
//
// What bounds it on this card: tensor-core operations. At the heavy
// route's shape (589,824 rows, 3 passes, one class per row) it is 2.35
// TFLOP of bf16 MMA against ~4 GB of f32 in and out (~1.2 ms of HBM time
// at 3.35 TB/s); the probe's sum over 3 cores is 7.0 TFLOP. The design is
// the simple tensor-core kernel, right first:
//   - one block per (128 rows x 128 output columns) tile of one channel,
//     8 warps each owning 32 x 64 of it as 2 x 4 wmma 16x16x16 bf16
//     fragments with f32 accumulators; 1152 = 9 x 128 needs no column mask;
//   - the K loop of 576 = 18 x 32 staged through shared memory: the x
//     chunk is loaded as f32, split into hi/lo bf16 in the load prologue,
//     and the chi/clo chunks are copied in as 16-byte words;
//   - the core loop is outermost: a block skips core k when no row of its
//     tile has row_core == k (most tiles hold one class), and zeroes the
//     A rows of other classes, so each row sums only its own core;
//   - the ragged last row tile is masked on load (zeros) and on store
//     (through a per-warp staging tile).
// No wgmma, TMA or software pipelining yet: those are for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kK = 576;
constexpr int kN = 1152;
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;            // 8 warps: 4 along M x 2 along N
constexpr int kFragM = 2;                // 32 rows per warp
constexpr int kFragN = 4;                // 64 columns per warp
constexpr int kLdA = kBK + 8;            // padded shared-memory leading dims
constexpr int kLdB = kBN + 8;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

__global__ void __launch_bounds__(kThreads, 2)
class_core_gemm_kernel(const float* __restrict__ x,
                       const __nv_bfloat16* __restrict__ chi,
                       const __nv_bfloat16* __restrict__ clo,
                       const int32_t* __restrict__ row_core,
                       float* __restrict__ z, int rows, int ncore, int npass) {
  __shared__ __align__(32) __nv_bfloat16 a_hi[kBM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 a_lo[kBM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 b_hi[kBK * kLdB];
  __shared__ __align__(32) __nv_bfloat16 b_lo[kBK * kLdB];
  __shared__ __align__(32) float stage[kThreads / 32][16 * 16];
  __shared__ int tile_core[kBM];  // the row's core; -1 past the last row

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int c = blockIdx.z;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const float* xc = x + static_cast<int64_t>(c) * rows * kK;
  float* zc = z + static_cast<int64_t>(c) * rows * kN;

  if (tid < kBM) {
    const int64_t r = r0 + tid;
    int k = -1;
    if (r < rows) k = row_core ? row_core[static_cast<int64_t>(c) * rows + r] : 0;
    tile_core[tid] = k;
  }
  __syncthreads();

  FragC acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int core = 0; core < ncore; ++core) {
    bool mine = false;
    if (tid < kBM) mine = row_core ? tile_core[tid] == core : tile_core[tid] >= 0;
    if (!__syncthreads_or(mine)) continue;
    const __nv_bfloat16* chi_k = chi + static_cast<int64_t>(core) * kK * kN;
    const __nv_bfloat16* clo_k = clo + static_cast<int64_t>(core) * kK * kN;

    for (int k0 = 0; k0 < kK; k0 += kBK) {
      // A chunk: 128 x 32 f32 = 1024 float4, 4 per thread, split into hi/lo.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 3;
        const int col = (idx & 7) * 4;
        const int k = tile_core[row];
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row_core ? k == core : k >= 0)
          v = *reinterpret_cast<const float4*>(xc + (r0 + row) * kK + k0 + col);
        const __nv_bfloat16 h0 = __float2bfloat16_rn(v.x);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(v.y);
        const __nv_bfloat16 h2 = __float2bfloat16_rn(v.z);
        const __nv_bfloat16 h3 = __float2bfloat16_rn(v.w);
        *reinterpret_cast<uint2*>(a_hi + row * kLdA + col) =
            make_uint2(pack2(h0, h1), pack2(h2, h3));
        if (npass >= 3) {
          *reinterpret_cast<uint2*>(a_lo + row * kLdA + col) = make_uint2(
              pack2(__float2bfloat16_rn(v.x - __bfloat162float(h0)),
                    __float2bfloat16_rn(v.y - __bfloat162float(h1))),
              pack2(__float2bfloat16_rn(v.z - __bfloat162float(h2)),
                    __float2bfloat16_rn(v.w - __bfloat162float(h3))));
        }
      }
      // B chunks: 32 x 128 bf16 = 512 16-byte words each, 2 per thread.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 4;
        const int col = (idx & 15) * 8;
        const int64_t g = static_cast<int64_t>(k0 + row) * kN + n0 + col;
        *reinterpret_cast<uint4*>(b_hi + row * kLdB + col) =
            *reinterpret_cast<const uint4*>(chi_k + g);
        if (npass >= 2)
          *reinterpret_cast<uint4*>(b_lo + row * kLdB + col) =
              *reinterpret_cast<const uint4*>(clo_k + g);
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        FragA ah[kFragM], al[kFragM];
#pragma unroll
        for (int i = 0; i < kFragM; ++i) {
          const int ar = (wm * 32 + i * 16) * kLdA + kk;
          wmma::load_matrix_sync(ah[i], a_hi + ar, kLdA);
          if (npass >= 3) wmma::load_matrix_sync(al[i], a_lo + ar, kLdA);
        }
#pragma unroll
        for (int j = 0; j < kFragN; ++j) {
          const int bc = kk * kLdB + wn * 64 + j * 16;
          FragB bh, bl;
          wmma::load_matrix_sync(bh, b_hi + bc, kLdB);
          if (npass >= 2) wmma::load_matrix_sync(bl, b_lo + bc, kLdB);
#pragma unroll
          for (int i = 0; i < kFragM; ++i) {
            wmma::mma_sync(acc[i][j], ah[i], bh, acc[i][j]);
            if (npass >= 2) wmma::mma_sync(acc[i][j], ah[i], bl, acc[i][j]);
            if (npass >= 3) wmma::mma_sync(acc[i][j], al[i], bh, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      const int64_t row = r0 + wm * 32 + i * 16;
      const int col = n0 + wn * 64 + j * 16;
      if (row + 16 <= rows) {
        wmma::store_matrix_sync(zc + row * kN + col, acc[i][j], kN, wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(stage[warp], acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int64_t r = row + (e >> 4);
          if (r < rows) zc[r * kN + col + (e & 15)] = stage[warp][e];
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x (channels, rows, 576) f32; chi, clo (ncore, 576, 1152) bf16; row_core
// (channels, rows) int32 or NULL; z (channels, rows, 1152) f32. All
// contiguous.
extern "C" int mg_cuda_class_core_gemm(const void* x, const void* chi,
                                       const void* clo, const void* row_core,
                                       void* z, int channels, int rows,
                                       int ncore, int npass, void* stream) {
  if (channels <= 0 || rows <= 0) return 0;
  const dim3 grid((rows + kBM - 1) / kBM, kN / kBN, channels);
  class_core_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(chi),
      static_cast<const __nv_bfloat16*>(clo), static_cast<const int32_t*>(row_core),
      static_cast<float*>(z), rows, ncore, npass);
  return static_cast<int>(cudaGetLastError());
}
