// K7: grouped (per-expert) matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/grouped_matmul.py::grouped_matmul_pallas: x (T, K) rows
// grouped by expert, expert weights B[g] (K, N), sizes (E,) int32 on the
// card -> out (T, N) in x's dtype.  Products are summed in float32 and
// rounded once.  Two layouts of the groups:
//   contiguous (the Pallas kernel's): group g owns rows [cum[g] - sizes[g],
//     cum[g]) with cum the running sum of sizes; rows at or past sum(sizes)
//     are zero.  Sizes may be any values >= 0 with sum <= T: the Pallas
//     rule that they are multiples of its row tile is not needed here.
//   counts (the MoE block's capacity-padded buffer): group g owns rows
//     [g cap, g cap + min(sizes[g], cap)); the rest of its cap rows, and
//     the rows past E cap, are zero.
// Two orders of the weights' storage: (E, K, N), N contiguous (the
// forward's W; MN-major for the product), or (E, N, K), K contiguous (the
// same W read as W^T by the backward's dx = dy W^T; K-major).  Neither is
// copied.  Its plain version is kernels/ref.py::grouped_matmul_ref.
//
// Bound.  The work is under the tensor cores' rate at the MoE block's
// shapes (DeepSeek-V2's prefill w1: 2 x 12,266 kept rows x 5,120 x 1,536
// is 0.20 ms at 989 TFLOP/s), so the bytes a launch must move bound it:
// each non-empty expert's weights once (2.52 GB there, 0.75 ms at 3.35
// TB/s), the kept rows of x and the output.  In a decode step of 4 tokens
// at most 8 experts hold a kept row, and only their weights need reading.
//
// bf16 route (TMA + wgmma).  One CTA of three warpgroups per (row tile of
// one group, 128 output columns); the column tile runs on blockIdx.x, so
// the CTAs of one row tile run side by side and read its x from L2.  The
// wrapper picks the row tile BM (64, 128, 192 or 256) from the group
// stride cap (counts layout) or the mean group size (contiguous), so that
// one tile covers a group of up to 256 rows and its expert's weights cross
// HBM once per launch; only a group of more than 256 rows takes more
// tiles.  Counts layout: group g's ceil(cap / BM) tiles are
// g ceil(cap / BM) + j, then the tiles past E cap; contiguous layout: the
// tiles of the groups in order, then those of the rows past the last group
// (an upper bound of ceil(T / BM) + E + 1 of them), a CTA finding its own
// group with one warp's prefix scan over the sizes, so the host never
// reads the sizes.  A CTA writes zeros to its rows past the kept count and
// exits before it reads a weight byte when none of its rows is kept, so a
// launch reads only the experts that hold rows.  Warpgroup 0 is the
// producer: it gives its registers up (setmaxnreg.dec) and one thread
// issues TMA loads of 64-deep stages into a ring in shared memory, x as
// 64-row boxes of the (T, K) rows (only the boxes that hold kept rows) and
// the weights as two 64 x 64 boxes of a 3-d map over the storage, each in
// 128-byte swizzle atoms; TMA zero-fills past K, N and T, so ragged edges
// need no masking of loads.  Warpgroups 1 and 2 (setmaxnreg.inc) each own
// 64 of the 128 columns and every row of the tile: BM / 64 wgmma
// m64n64k16 per 16 of depth, B read MN-major (transpose bit) or K-major
// as the storage lies.  Rows of the tile past the group's kept count
// (x's next group, or TMA's zeros) are computed and never stored.  64-row
// tiles (caps up to 64, a decode step's among them) run two CTAs an SM,
// so a decode step's thousands of empty CTAs retire two at a time on
// every SM.
//
// float32 route (CUDA cores; the gates' dtype, not a speed path).  One CTA
// of 256 threads per (row tile of 16, 32 or 64 rows, 128 columns); x
// (BM x 32) and weight (32 x 128) tiles stream through a 4-stage cp.async
// ring (rows padded by 16 bytes; K-major weights land as a [n][k] tile),
// and each thread sums its outputs with float32 FMAs in k order (no TF32).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Tile {
  int group;  // -1: rows past the last group
  int row0;
  int rows;   // rows computed from row0 on
  int zeros;  // rows written as zeros after them
};

// Row tile `tile` of the launch: the groups in order, each cut into
// ceil(size / BM) tiles, then the rows past the last group.  One warp scans
// the sizes 32 groups at a time; the result is shared with the CTA.
__device__ Tile find_tile(const int* __restrict__ sizes, int E, int T, int BM,
                          int tile) {
  __shared__ Tile found;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int tiles_before = 0, rows_before = 0;
    bool done = false;
    for (int base = 0; base < E && !done; base += 32) {
      const int g = base + lane;
      const int s = g < E ? max(sizes[g], 0) : 0;
      const int nt = (s + BM - 1) / BM;
      int nt_inc = nt, s_inc = s;
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(kFull, nt_inc, o);
        const int b = __shfl_up_sync(kFull, s_inc, o);
        if (lane >= o) {
          nt_inc += a;
          s_inc += b;
        }
      }
      const int first = tiles_before + nt_inc - nt;
      const bool mine = tile >= first && tile < first + nt;
      if (mine) {  // at most one lane
        const int j = tile - first;
        const int r0 = rows_before + s_inc - s + j * BM;
        found = Tile{g, r0, max(0, min(min(BM, s - j * BM), T - r0)), 0};
      }
      done = __ballot_sync(kFull, mine) != 0;
      tiles_before += __shfl_sync(kFull, nt_inc, 31);
      rows_before += __shfl_sync(kFull, s_inc, 31);
    }
    if (!done && lane == 0) {
      const int r0 = rows_before + (tile - tiles_before) * BM;
      found = Tile{-1, r0, 0, max(0, min(BM, T - r0))};
    }
  }
  __syncthreads();
  return found;
}

// Row tile `tile` of a counts-layout launch: group g's tiles g * tpg + j
// (tpg = ceil(cap / BM)) cover its cap rows, then the tiles past E * cap.
__device__ Tile counts_tile(const int* __restrict__ counts, int E, int T,
                            int cap, int BM, int tile) {
  const int tpg = (cap + BM - 1) / BM;
  if (tile < E * tpg) {
    const int g = tile / tpg, j = tile % tpg;
    const int r0 = g * cap + j * BM;
    const int span = max(0, min(min(BM, cap - j * BM), T - r0));
    const int kept = min(max(counts[g], 0), cap) - j * BM;
    const int rows = max(0, min(kept, span));
    return Tile{g, r0, rows, span - rows};
  }
  const int r0 = E * cap + (tile - E * tpg) * BM;
  return Tile{-1, r0, 0, max(0, min(BM, T - r0))};
}

// This CTA's row tile, its zero rows written over columns [n0, n0 + 128).
template <typename T>
__device__ __forceinline__ Tile start_tile(const int* __restrict__ sizes,
                                           T* __restrict__ out, int T_rows,
                                           int N, int E, int cap, int BM,
                                           int n0, int threads, T zero) {
  const Tile t = cap > 0 ? counts_tile(sizes, E, T_rows, cap, BM, blockIdx.y)
                         : find_tile(sizes, E, T_rows, BM, blockIdx.y);
  for (int i = threadIdx.x; i < t.zeros * 128; i += threads) {
    const int r = t.rows + i / 128, c = n0 + i % 128;
    if (c < N) out[(long long)(t.row0 + r) * N + c] = zero;
  }
  return t;
}

// ---------------------------------------------------------------------------
// bf16 route: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------
namespace wgmma_route {

using hopper::desc_sw128;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::smem_u32;
using hopper::tma_load;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kBN = 128;       // output columns per CTA, 64 per consumer
constexpr int kBK = 64;        // depth of a stage: one 128-byte swizzle row
constexpr int kAtom = 64 * 128;  // bytes of one 64-row box

// Shared memory of one CTA from a 1024-byte-aligned base: ST stages of
// [x: BM / 64 boxes][w: 2 boxes, one per consumer], then the full and
// empty mbarriers.  64-row tiles run two CTAs an SM (80 registers a
// thread: ptxas holds the whole function to the launch's count, so the
// 64 accumulators of a 128-row tile would not fit beside the rest);
// larger tiles one, at 168 registers, of which the producer gives 128 up
// to the consumers (setmaxnreg 40 / 232, as K6), with a deeper ring.
template <int BM>
struct Config {
  static constexpr int kRB = BM / 64;  // 64-row blocks of the tile
  static constexpr int kCtas = BM == 64 ? 2 : 1;
  static constexpr int kStages = BM == 128 ? 6 : BM == 192 ? 5 : 4;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr int kXBytes = kRB * kAtom;
  static constexpr int kStageBytes = kXBytes + 2 * kAtom;
  static constexpr int kBar = kStages * kStageBytes;
  static constexpr int kBytes = kBar + 16 * kStages + 1024;
};

// until the phase of parity `parity` has completed; traps after 10 s, so
// a load that never lands faults the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (int n = 0;; ++n) {
    if (hopper::mbar_try_wait(bar, parity)) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (n == 0) t0 = now;
    if (now - t0 > 10000000000ull) __trap();
  }
}

// D (64 x 64) += A (64 x 16, shared, K-major) * B (16 x 64, shared):
// B MN-major (kTransB 1) or K-major (0)
template <int kTransB>
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int BM, bool kKMajor>
__global__ void __launch_bounds__(kThreads, Config<BM>::kCtas)
grouped_matmul_wgmma(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const int* __restrict__ sizes,
                     __nv_bfloat16* __restrict__ out, int T_rows, int K,
                     int N, int E, int cap) {
  using C = Config<BM>;
  constexpr int RB = C::kRB, ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const int n0 = blockIdx.x * kBN;
  const Tile t = start_tile(sizes, out, T_rows, N, E, cap, BM, n0, kThreads,
                            __float2bfloat16(0.0f));
  // made warp-uniform for the compiler (shfl): wgmma must sit on a path it
  // can tell is uniform, or ptxas serialises it
  const int rows = __shfl_sync(kFull, t.rows, 0);
  if (rows == 0) return;  // before a weight byte is read
  const int group = __shfl_sync(kFull, t.group, 0);
  const int row0 = __shfl_sync(kFull, t.row0, 0);

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + C::kBar, empty0 = full0 + 8 * ST;
  const int KT = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(kFull, threadIdx.x / 128, 0);
  if (wg == 0) {  // producer warpgroup: one thread issues TMA
    if (C::kCtas == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          C::kProducerRegs));
    if (threadIdx.x == 0) {
      const int xboxes = (rows + 63) / 64;           // boxes with kept rows
      const int wboxes = n0 + 64 < N ? 2 : 1;        // boxes with columns
      const int bytes = (xboxes + wboxes) * kAtom;
      for (int i = 0; i < KT; ++i) {
        const int s = i % ST;
        mbar_wait(empty0 + 8 * s, ((i / ST) & 1) ^ 1);
        const uint32_t st = base + s * C::kStageBytes, full = full0 + 8 * s;
        mbar_expect_tx(full, bytes);
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
          if (rb < xboxes)
            tma_load(st + rb * kAtom, &xmap, full, i * kBK, row0 + 64 * rb, 0,
                     0);
        for (int h = 0; h < wboxes; ++h) {
          const uint32_t dst = st + C::kXBytes + h * kAtom;
          if (kKMajor)  // storage (E, N, K): box (64 k, 64 n)
            tma_load(dst, &wmap, full, i * kBK, n0 + 64 * h, group, 0);
          else  // storage (E, K, N): box (64 n, 64 k)
            tma_load(dst, &wmap, full, n0 + 64 * h, i * kBK, group, 0);
        }
      }
    }
  } else {  // consumer warpgroups 1, 2: columns [n0 + 64 c, + 64)
    if (C::kCtas == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          C::kConsumerRegs));
    const int c = wg - 1;
    float acc[RB][32];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[rb][j] = 0.0f;
    for (int i = 0; i < KT; ++i) {
      const int s = i % ST;
      mbar_wait(full0 + 8 * s, (i / ST) & 1);
      const uint32_t xs = base + s * C::kStageBytes;
      const uint32_t ws = xs + C::kXBytes + c * kAtom;
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) fence_regs(acc[rb]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // 16 of depth: 32 bytes along a K-major row, 16 rows of an
        // MN-major box
        const uint64_t db =
            desc_sw128(ws + (kKMajor ? kk * 32 : kk * 16 * 128));
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
          wgmma_64x64<kKMajor ? 0 : 1>(
              acc[rb], desc_sw128(xs + rb * kAtom + kk * 32), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // stage i - 1's products are done
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) fence_regs(acc[rb]);
      if (i > 0) mbar_arrive(empty0 + 8 * ((i - 1) % ST));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) fence_regs(acc[rb]);

    // fragment registers 4 j + {0, 1} hold row r, 4 j + {2, 3} row r + 8,
    // at columns 8 j + 2 (lane % 4) + {0, 1}
    const int tw = threadIdx.x % 128, lane = tw % 32;
    const int r = 16 * (tw / 32) + lane / 4;
    const int col0 = n0 + 64 * c + 2 * (lane % 4);
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * rb + r + 8 * h;
        if (row >= rows) continue;
        __nv_bfloat16* dst = out + (long long)(row0 + row) * N;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + 8 * j;
          if (col < N)  // N % 8 == 0: col + 1 < N too
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(acc[rb][4 * j + 2 * h],
                                      acc[rb][4 * j + 2 * h + 1]);
        }
      }
  }
}

template <int BM, bool kKMajor>
int launch(const void* x, const void* w, const int* sizes, void* out, int T,
           int K, int N, int E, int cap, int grid_rows, cudaStream_t stream) {
  using C = Config<BM>;
  auto kernel = grouped_matmul_wgmma<BM, kKMajor>;
  if (C::kCtas == 1) {
    // setmaxnreg only moves registers between the CTA's warps: the
    // launch's count must cover what the consumers take, or they would
    // wait forever
    static int regs = -1;
    if (regs < 0) {
      cudaFuncAttributes attr;
      const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e != cudaSuccess) return (int)e;
      regs = attr.numRegs;
    }
    if (regs * kThreads <
        C::kProducerRegs * 128 + C::kConsumerRegs * kConsumers)
      return (int)cudaErrorInvalidConfiguration;
  }
  // zeroed maps stay unread: no tile holds a kept row when E == 0, and no
  // stage is loaded when K == 0
  CUtensorMap xmap = {}, wmap = {};
  if (K > 0 && E > 0) {
    const cuuint64_t xdims[4] = {(cuuint64_t)K, (cuuint64_t)T, 1, 1};
    const cuuint64_t xstr[3] = {(cuuint64_t)K * 2, (cuuint64_t)K * T * 2,
                                (cuuint64_t)K * T * 2};
    const cuuint64_t inner = kKMajor ? K : N, outer = kKMajor ? N : K;
    const cuuint64_t wdims[4] = {inner, outer, (cuuint64_t)E, 1};
    const cuuint64_t wstr[3] = {inner * 2, inner * outer * 2,
                                inner * outer * E * 2};
    const cuuint32_t box[4] = {64, 64, 1, 1};
    if (!hopper::make_map_bf16(&xmap, x, xdims, xstr, box) ||
        !hopper::make_map_bf16(&wmap, w, wdims, wstr, box))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kBN - 1) / kBN, grid_rows);
  kernel<<<grid, kThreads, C::kBytes, stream>>>(
      xmap, wmap, sizes, (__nv_bfloat16*)out, T, K, N, E, cap);
  return (int)cudaGetLastError();
}

template <bool kKMajor>
int dispatch(const void* x, const void* w, const int* sizes, void* out, int T,
             int K, int N, int E, int cap, int bm, int grid_rows,
             cudaStream_t st) {
  if (bm <= 64)
    return launch<64, kKMajor>(x, w, sizes, out, T, K, N, E, cap, grid_rows,
                               st);
  if (bm <= 128)
    return launch<128, kKMajor>(x, w, sizes, out, T, K, N, E, cap, grid_rows,
                                st);
  if (bm <= 192)
    return launch<192, kKMajor>(x, w, sizes, out, T, K, N, E, cap, grid_rows,
                                st);
  return launch<256, kKMajor>(x, w, sizes, out, T, K, N, E, cap, grid_rows,
                              st);
}

}  // namespace wgmma_route

// ---------------------------------------------------------------------------
// float32 route: cp.async ring, FMAs on the CUDA cores
// ---------------------------------------------------------------------------
namespace fma_route {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // output columns per CTA, 16 per warp
constexpr int kBK = 32;        // depth of one pipeline stage
constexpr int kStages = 4;
constexpr int kV = 4;          // floats per 16-byte copy
// shared-memory row strides (floats), 16 bytes of padding: the x tile
// [BM][k], the weight tile [k][n] (MN-major storage) or [n][k] (K-major)
constexpr int kXS = kBK + kV;
constexpr int kWS = kBN + kV;
constexpr int kWT = kBK + kV;
constexpr int kWElems = kBN * kWT > kBK * kWS ? kBN * kWT : kBK * kWS;
template <int BM>
__host__ __device__ constexpr int stage_elems() {
  return BM * kXS + kWElems;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage: x rows [row0, row0 + rows) x depth [k0, k0 + 32) and the
// weights' depth [k0, k0 + 32) x columns [n0, n0 + 128) of expert wg; the
// rest zero.
template <int BM, bool kKMajor>
__device__ __forceinline__ void load_stage(float* xs, float* ws,
                                           const float* __restrict__ x,
                                           const float* __restrict__ wg,
                                           int row0, int rows, int k0, int n0,
                                           int K, int N) {
  for (int c = threadIdx.x; c < BM * (kBK / kV); c += kThreads) {
    const int r = c / (kBK / kV), kc = (c % (kBK / kV)) * kV;
    const bool ok = r < rows && k0 + kc < K;
    const float* src = ok ? x + (long long)(row0 + r) * K + k0 + kc : x;
    cp_async16(xs + r * kXS + kc, src, ok);
  }
  if (kKMajor) {  // storage (N, K): rows of the tile along n
    for (int c = threadIdx.x; c < kBN * (kBK / kV); c += kThreads) {
      const int n = c / (kBK / kV), kc = (c % (kBK / kV)) * kV;
      const bool ok = n0 + n < N && k0 + kc < K;
      const float* src = ok ? wg + (long long)(n0 + n) * K + k0 + kc : wg;
      cp_async16(ws + n * kWT + kc, src, ok);
    }
  } else {  // storage (K, N)
    for (int c = threadIdx.x; c < kBK * (kBN / kV); c += kThreads) {
      const int kr = c / (kBN / kV), nc = (c % (kBN / kV)) * kV;
      const bool ok = k0 + kr < K && n0 + nc < N;
      const float* src = ok ? wg + (long long)(k0 + kr) * N + n0 + nc : wg;
      cp_async16(ws + kr * kWS + nc, src, ok);
    }
  }
}

// Warp w owns columns [16 w, 16 w + 16); lane l takes column 16 w + l % 16
// and rows l / 16 + 2 i; one FMA per (row, k) in k order.
template <int BM, bool kKMajor>
struct Product {
  float acc[BM / 2] = {};

  __device__ __forceinline__ void step(const float* xs, const float* ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = warp * 16 + (lane & 15), r0 = lane >> 4;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float wv = kKMajor ? ws[col * kWT + kk] : ws[kk * kWS + col];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i)
        acc[i] = fmaf(xs[(r0 + 2 * i) * kXS + kk], wv, acc[i]);
    }
  }

  __device__ __forceinline__ void store(float* out, int row0, int rows,
                                        int n0, int N) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = n0 + warp * 16 + (lane & 15);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int row = (lane >> 4) + 2 * i;
      if (row < rows && col < N) out[(long long)(row0 + row) * N + col] = acc[i];
    }
  }
};

// two CTAs an SM: at most 128 registers a thread
template <int BM, bool kKMajor>
__global__ void __launch_bounds__(kThreads, 2)
grouped_matmul_fma(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ sizes, float* __restrict__ out,
                   int T_rows, int K, int N, int E, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const Tile t = start_tile(sizes, out, T_rows, N, E, cap, BM, n0, kThreads,
                            0.0f);
  if (t.rows == 0) return;  // before a weight byte is read
  const float* wg = w + (long long)t.group * K * N;
  constexpr int kStage = stage_elems<BM>();
  const int KT = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT)
      load_stage<BM, kKMajor>(smem + s * kStage, smem + s * kStage + BM * kXS,
                              x, wg, t.row0, t.rows, s * kBK, n0, K, N);
    cp_async_commit();
  }
  Product<BM, kKMajor> prod;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    const int nk = kt + kStages - 1;
    if (nk < KT) {
      float* st = smem + (nk % kStages) * kStage;
      load_stage<BM, kKMajor>(st, st + BM * kXS, x, wg, t.row0, t.rows,
                              nk * kBK, n0, K, N);
    }
    cp_async_commit();
    const float* st = smem + (kt % kStages) * kStage;
    prod.step(st, st + BM * kXS);
  }
  cp_async_wait<0>();
  prod.store(out, t.row0, t.rows, n0, N);
}

template <int BM, bool kKMajor>
int launch(const void* x, const void* w, const int* sizes, void* out, int T,
           int K, int N, int E, int cap, int grid_rows, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * stage_elems<BM>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      grouped_matmul_fma<BM, kKMajor>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kBN - 1) / kBN, grid_rows);
  grouped_matmul_fma<BM, kKMajor><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)w, sizes, (float*)out, T, K, N, E, cap);
  return (int)cudaGetLastError();
}

template <bool kKMajor>
int dispatch(const void* x, const void* w, const int* sizes, void* out, int T,
             int K, int N, int E, int cap, int bm, int grid_rows,
             cudaStream_t st) {
  if (bm <= 16)
    return launch<16, kKMajor>(x, w, sizes, out, T, K, N, E, cap, grid_rows,
                               st);
  if (bm <= 32)
    return launch<32, kKMajor>(x, w, sizes, out, T, K, N, E, cap, grid_rows,
                               st);
  return launch<64, kKMajor>(x, w, sizes, out, T, K, N, E, cap, grid_rows,
                             st);
}

}  // namespace fma_route
}  // namespace

// x (T, K) and out (T, N) contiguous; w the weights' storage, contiguous:
// (E, K, N) (k_major == 0) or (E, N, K) (k_major != 0); all bf16
// (bf16 != 0: the wgmma route; x and w 16-byte aligned) or all float32
// (the fma route); sizes (E,) int32 on the card.  cap > 0: the counts
// layout with group stride cap, else the contiguous layout.  bm: the row
// tile, 64, 128, 192 or 256 (bf16) or 16, 32 or 64 (float32); grid_rows:
// the row tiles of the launch, ceil(T / bm) + E + 1 (contiguous) or
// E ceil(cap / bm) + ceil(max(T - E cap, 0) / bm) (counts), below 65,536.
// K and N multiples of 8 (checked by the wrapper).
extern "C" int zipper_grouped_matmul(const void* x, const void* w,
                                     const int* sizes, void* out, int bf16,
                                     int k_major, int T, int K, int N, int E,
                                     int cap, int bm, int grid_rows,
                                     void* stream) {
  if (T == 0 || N == 0 || grid_rows == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return k_major ? wgmma_route::dispatch<true>(x, w, sizes, out, T, K, N, E,
                                                 cap, bm, grid_rows, st)
                   : wgmma_route::dispatch<false>(x, w, sizes, out, T, K, N,
                                                  E, cap, bm, grid_rows, st);
  return k_major ? fma_route::dispatch<true>(x, w, sizes, out, T, K, N, E,
                                             cap, bm, grid_rows, st)
                 : fma_route::dispatch<false>(x, w, sizes, out, T, K, N, E,
                                              cap, bm, grid_rows, st);
}

extern "C" const char* zipper_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
