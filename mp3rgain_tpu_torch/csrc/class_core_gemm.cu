// Class-core GEMM in split bf16 ("bf16x3") on Hopper: wgmma, TMA, a
// warp-specialised mbarrier ring and a persistent tile loop.
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
// TFLOP of bf16 MMA (2.37 ms at 989 TFLOP/s) against 4.1 GB of f32 in and
// out (1.22 ms at 3.35 TB/s); the probe's sum over 3 cores is 7.0 TFLOP.
// The design keeps the tensor cores fed:
//   - the three passes are one K loop: per 16-deep K slice, the wgmmas
//     xh.chi, xh.clo and xl.chi accumulate into one register tile, i.e.
//     A' = [xh | xh | xl] against B' = [chi; clo; chi];
//   - A comes from registers: each consumer thread reads its f32 fragment
//     of the x tile from shared memory and rounds it to hi and lo there,
//     so x is split once per loaded tile and never stored as bf16;
//     B (chi, clo) is read by wgmma from shared memory;
//   - one block per SM walks output tiles of 128 rows x 192 columns,
//     column tile fastest, so the six column tiles of a row strip run on
//     neighbouring SMs at the same time and x comes from HBM about once;
//   - warpgroup 0 is the producer: one thread keeps TMA loads of the x
//     tile (128 x 32 f32) and the chi/clo tiles (32 x 192 bf16 each) in
//     flight in a 5-stage ring of 40 KB stages (128-byte swizzle, full and
//     empty mbarriers); warpgroups 1 and 2 each own 64 rows of the tile
//     and issue m64n192k16 wgmmas (96 f32 accumulators a thread), keeping
//     one group in flight while they split the next stage;
//   - the ring runs on across tiles, so the producer loads the next tile
//     while the consumers store this one's accumulators;
//   - a tile skips a core that none of its rows selects, and zeroes the A
//     fragments of rows of another class, so each row sums only its own
//     core; no split-K and no atomics, so each row's sum has one fixed
//     order and repeated calls give identical bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 576;
constexpr int kN = 1152;
constexpr int kBM = 128;                      // rows per tile, 64 per consumer warpgroup
constexpr int kBN = 192;                      // columns per tile: one m64n192k16 wgmma
constexpr int kBK = 32;                       // K per stage: 32 f32, one 128-byte row of x
constexpr int kKB = kK / kBK;                 // 18 stages per core
constexpr int kNT = kN / kBN;                 // 6 column tiles
constexpr int kBBox = 64;                     // bf16 columns in one 128-byte swizzle row
constexpr int kStages = 5;
constexpr int kThreads = 384;                 // warpgroup 0 loads, 1 and 2 compute
constexpr int kXBytes = kBM * kBK * 4;        // 16 KB
constexpr int kBBytes = kBK * kBN * 2;        // 12 KB: 3 boxes of 32 rows x 64 columns
constexpr int kBoxBytes = kBK * kBBox * 2;    // 4 KB
constexpr int kStageBytes = kXBytes + 2 * kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + slack to align to 1024

static_assert(kK % kBK == 0 && kN % kBN == 0 && kKB % 2 == 0, "tile shape");
static_assert(kStageBytes % 1024 == 0 && kXBytes % 1024 == 0 && kBoxBytes % 1024 == 0,
              "128-byte swizzle atoms need 1024-byte aligned tiles");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete. A wait of more than
// ~2^34 cycles (seconds) can only be a broken pipeline: trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// Shared-memory descriptor of a B tile: MN-major (columns contiguous),
// 128-byte swizzle; 1024 bytes between 8-row groups along K (SBO) and
// kBoxBytes between the 64-column boxes along N (LBO).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBoxBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[96]) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 192 f32, this warpgroup's tile) += A (64 x 16 bf16, registers in
// the wgmma fragment layout) . B (16 x 192 bf16, MN-major in shared memory).
__device__ __forceinline__ void wgmma_192(float (&d)[96], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The cores that some row of the tile selects, as a bit mask, computed by
// every warp that needs it (the producer and each consumer warp), so the
// roles agree on the stage sequence without talking to each other.
__device__ __forceinline__ uint32_t tile_cores(const int32_t* row_core, int64_t rc0, int r0,
                                               int rows, int ncore, int lane) {
  if (!row_core) return (1u << ncore) - 1;
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < kBM / 32; ++i) {
    const int r = r0 + lane + 32 * i;
    if (r < rows) {
      const int k = row_core[rc0 + r];
      if (k >= 0 && k < ncore) m |= 1u << k;
    }
  }
  return __reduce_or_sync(0xffffffffu, m);
}

struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One stage of the consumer mainloop: wait for the stage, split this
// thread's x fragment into hi (and lo) bf16 registers, issue the stage's
// 2 x NPASS wgmmas as one group, then wait for the previous group and hand
// its stage back to the producer.
template <int NPASS>
__device__ __forceinline__ void consume_stage(float (&acc)[96], uint32_t (&ah)[2][4],
                                              uint32_t (&al)[2][4], Ring& ring, int& held,
                                              uint32_t base, uint32_t full0, uint32_t empty0,
                                              const uint32_t (&off)[2][2], bool sel_a,
                                              bool sel_b, int lane) {
  const uint32_t st = base + ring.stage * kStageBytes;
  mbar_wait(full0 + 8 * ring.stage, ring.phase);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Register pairs of the m64nNk16 A fragment: (row g, cols 2t..2t+1)
      // and (row g + 8, same cols), then the same 8 columns further on.
      float2 va = lds_f2(st + off[s][h]);
      float2 vb = lds_f2(st + off[s][h] + 8 * 128);
      if (!sel_a) va = make_float2(0.f, 0.f);
      if (!sel_b) vb = make_float2(0.f, 0.f);
      const __nv_bfloat162 ha = __floats2bfloat162_rn(va.x, va.y);
      const __nv_bfloat162 hb = __floats2bfloat162_rn(vb.x, vb.y);
      ah[s][2 * h] = bf16x2_bits(ha);
      ah[s][2 * h + 1] = bf16x2_bits(hb);
      if (NPASS >= 3) {
        const float2 fa = __bfloat1622float2(ha);
        const float2 fb = __bfloat1622float2(hb);
        al[s][2 * h] = bf16x2_bits(__floats2bfloat162_rn(va.x - fa.x, va.y - fa.y));
        al[s][2 * h + 1] = bf16x2_bits(__floats2bfloat162_rn(vb.x - fb.x, vb.y - fb.y));
      }
    }
  }
  const uint32_t chi = st + kXBytes;
  const uint32_t clo = chi + kBBytes;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    // 16 K rows of 128 bytes per slice.
    wgmma_192(acc, ah[s], b_desc(chi + s * 16 * 128));
    if (NPASS >= 2) wgmma_192(acc, ah[s], b_desc(clo + s * 16 * 128));
    if (NPASS >= 3) wgmma_192(acc, al[s], b_desc(chi + s * 16 * 128));
  }
  wgmma_commit();
  wgmma_wait<1>();
  if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);
  held = ring.stage;
  ring.advance();
}

template <int NPASS>
__global__ void __launch_bounds__(kThreads, 1)
class_core_gemm_wgmma(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap chi_map,
                      const __grid_constant__ CUtensorMap clo_map,
                      const int32_t* __restrict__ row_core, float* __restrict__ z, int rows,
                      int ncore, int strips, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = smem_addr(&full_bar[0]);
  const uint32_t empty0 = smem_addr(&empty_bar[0]);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: warp 0 walks the same (tile, core, K block)
    // sequence as the consumers; its lane 0 issues the loads.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 0) {
      constexpr uint32_t kTx = kXBytes + (NPASS >= 2 ? 2 : 1) * kBBytes;
      Ring ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int nt = t % kNT;
        const int strip = t / kNT;
        const int c = strip / strips;
        const int r0 = (strip % strips) * kBM;
        const uint32_t mask =
            tile_cores(row_core, static_cast<int64_t>(c) * rows, r0, rows, ncore, lane);
        for (int core = 0; core < ncore; ++core) {
          if (!((mask >> core) & 1)) continue;
          for (int kb = 0; kb < kKB; ++kb) {
            mbar_wait(empty0 + 8 * ring.stage, ring.phase ^ 1);
            if (lane == 0) {
              const uint32_t st = base + ring.stage * kStageBytes;
              const uint32_t bar = full0 + 8 * ring.stage;
              mbar_expect_tx(bar, kTx);
              tma_load_3d(st, &x_map, bar, kb * kBK, r0, c);
#pragma unroll
              for (int b = 0; b < kBN / kBBox; ++b) {
                const int n = nt * kBN + b * kBBox;
                tma_load_3d(st + kXBytes + b * kBoxBytes, &chi_map, bar, n, kb * kBK, core);
                if (NPASS >= 2)
                  tma_load_3d(st + kXBytes + kBBytes + b * kBoxBytes, &clo_map, bar, n,
                              kb * kBK, core);
              }
            }
            __syncwarp();
            ring.advance();
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = lane / 4;
    const int q = lane % 4;
    // This thread's first row in the tile (its second is 8 below).
    const int ra = (warp / 4 - 1) * 64 + (warp % 4) * 16 + g;
    // Byte offsets in the swizzled x tile of its fragment pairs: slice s,
    // columns 16s + 8h + 2q (+1); the 16-byte chunk index is XORed with
    // the row mod 8, which is g.
    uint32_t off[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        off[s][h] = ra * 128 + (((4 * s + 2 * h + q / 2) ^ g) * 16) + (q % 2) * 8;

    float acc[96];
    uint32_t ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
    Ring ring;
    int held = -1;  // the stage read by the wgmma group still in flight
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int nt = t % kNT;
      const int strip = t / kNT;
      const int c = strip / strips;
      const int r0 = (strip % strips) * kBM;
      const int64_t rc0 = static_cast<int64_t>(c) * rows;
      const uint32_t mask = tile_cores(row_core, rc0, r0, rows, ncore, lane);
      int cls_a = -1, cls_b = -1;
      if (row_core) {
        if (r0 + ra < rows) cls_a = row_core[rc0 + r0 + ra];
        if (r0 + ra + 8 < rows) cls_b = row_core[rc0 + r0 + ra + 8];
      }
#pragma unroll
      for (int i = 0; i < 96; ++i) acc[i] = 0.f;
      fence_acc(acc);
      for (int core = 0; core < ncore; ++core) {
        if (!((mask >> core) & 1)) continue;
        const bool sel_a = !row_core || cls_a == core;
        const bool sel_b = !row_core || cls_b == core;
        for (int kb = 0; kb < kKB; kb += 2) {
          consume_stage<NPASS>(acc, ah0, al0, ring, held, base, full0, empty0, off, sel_a,
                               sel_b, lane);
          consume_stage<NPASS>(acc, ah1, al1, ring, held, base, full0, empty0, off, sel_a,
                               sel_b, lane);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);
      held = -1;

      // Epilogue: accumulator element 4j + 2i + e is (row g + 8i, column
      // 8j + 2q + e) of this warp's 16 rows; each row pair of columns is one
      // 8-byte store, and a warp's store fills whole 32-byte sectors.
      const int64_t row = static_cast<int64_t>(r0) + ra;
      float* zr = z + (rc0 + row) * kN + nt * kBN + 2 * q;
      const bool ok_a = row < rows;
      const bool ok_b = row + 8 < rows;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        if (ok_a) *reinterpret_cast<float2*>(zr + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (ok_b)
          *reinterpret_cast<float2*>(zr + 8 * kN + 8 * j) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no link against libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess && p)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D tiled map with 128-byte swizzle: dims innermost first, byte
// strides of dims 1 and 2, box of (b0, b1, 1). Returns 0 or a CUresult.
int encode_3d(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              uint64_t d0, uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b0,
              uint32_t b1) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return static_cast<int>(fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int NPASS>
int launch(const CUtensorMap& xm, const CUtensorMap& hm, const CUtensorMap& lm,
           const int32_t* row_core, float* z, int rows, int ncore, int strips, int tiles,
           int grid, cudaStream_t stream) {
  auto kernel = class_core_gemm_wgmma<NPASS>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(xm, hm, lm, row_core, z, rows, ncore, strips,
                                                  tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns 0 on success, a cudaError_t, or 10000 + a
// CUresult when a TMA descriptor cannot be made (20000: no driver entry
// point). x (channels, rows, 576) f32; chi, clo (ncore, 576, 1152) bf16;
// row_core (channels, rows) int32 or NULL; z (channels, rows, 1152) f32.
// All contiguous, x/chi/clo 16-byte aligned, ncore 1..31, npass 1..3.
extern "C" int mg_cuda_class_core_gemm(const void* x, const void* chi, const void* clo,
                                       const void* row_core, void* z, int channels, int rows,
                                       int ncore, int npass, void* stream) {
  if (channels <= 0 || rows <= 0) return 0;
  const EncodeTiled fn = encode_fn();
  if (!fn) return 20000;
  CUtensorMap xm, hm, lm;
  int rc = encode_3d(fn, &xm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, kK, rows, channels,
                     uint64_t(kK) * 4, uint64_t(rows) * kK * 4, kBK, kBM);
  if (!rc)
    rc = encode_3d(fn, &hm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, chi, kN, kK, ncore,
                   uint64_t(kN) * 2, uint64_t(kK) * kN * 2, kBBox, kBK);
  if (!rc)
    rc = encode_3d(fn, &lm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, clo, kN, kK, ncore,
                   uint64_t(kN) * 2, uint64_t(kK) * kN * 2, kBBox, kBK);
  if (rc) return 10000 + rc;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int strips = (rows + kBM - 1) / kBM;
  const int tiles = channels * strips * kNT;
  const int grid = tiles < sms ? tiles : sms;
  const auto rcp = static_cast<const int32_t*>(row_core);
  const auto zp = static_cast<float*>(z);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (npass) {
    case 1: return launch<1>(xm, hm, lm, rcp, zp, rows, ncore, strips, tiles, grid, s);
    case 2: return launch<2>(xm, hm, lm, rcp, zp, rows, ncore, strips, tiles, grid, s);
    default: return launch<3>(xm, hm, lm, rcp, zp, rows, ncore, strips, tiles, grid, s);
  }
}

// Dynamic shared memory of one block (the stage ring plus alignment slack),
// for reports beside ptxas's static figure.
extern "C" int mg_cuda_class_core_gemm_smem_bytes() { return kSmemBytes; }
