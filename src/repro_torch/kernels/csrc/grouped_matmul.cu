// K7: grouped (per-expert) matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/grouped_matmul.py::grouped_matmul_pallas: x (T, D) rows
// grouped by expert, w (E, D, F), sizes (E,) int32 on the card -> out
// (T, F) in x's dtype.  Products are summed in float32 and rounded once.
// Two layouts of the groups:
//   contiguous (the Pallas kernel's): group g owns rows [cum[g] - sizes[g],
//     cum[g]) with cum the running sum of sizes; rows at or past sum(sizes)
//     are zero.  Sizes may be any values >= 0 with sum <= T: the Pallas
//     rule that they are multiples of its row tile is not needed here.
//   counts (the MoE block's capacity-padded buffer): group g owns rows
//     [g cap, g cap + min(sizes[g], cap)); the rest of its cap rows, and
//     the rows past E cap, are zero.
// Its plain version is kernels/ref.py::grouped_matmul_ref.
//
// Bound.  The work is far under the tensor cores' rate at the MoE block's
// shapes (Arctic: E = 128, D = 7,168, F = 4,864, bf16; 2 T D F operations
// are 0.07-0.36 ms at 989 TFLOP/s), so the expert weights a launch must
// read bound it.  In a prefill of 4 x 512 tokens every expert holds rows:
// 8.9 GB, 2.7 ms at 3.35 TB/s.  In a decode step of 4 tokens at most 8
// experts hold a kept row, and only their weights need reading: 558 MB,
// 0.167 ms.  The design reads each non-empty expert's weights once per
// launch and no others.
//
// Design.  The wrapper picks the row tile BM (16, 32 or 64) from the mean
// group size (the group stride cap in the counts layout), so that one tile
// covers a whole group of up to 64 rows.  One CTA of 256 threads per (row
// tile inside one group, 128 output columns); blockIdx.y numbers the row
// tiles.  Contiguous layout: the tiles of the groups in order, then those
// of the rows past the last group (written as zeros); the launch has an
// upper bound of them (ceil(T / BM) + E + 1), and a CTA finds its own group
// with one warp's prefix scan over the sizes, so the host never reads the
// sizes.  Counts layout: group g's ceil(cap / BM) tiles are g ceil(cap / BM)
// + j, then the tiles past E cap; a CTA reads its group's count, writes
// zeros to its rows at or past the count, and exits before it reads a
// weight byte when none of its rows is kept, so a launch reads only the
// experts that hold rows.  CTAs without rows exit.  The x tile (BM x 32)
// and the weight tile (32 x 128) stream through a 4-stage cp.async ring in
// shared memory (rows padded by 16 bytes: no bank conflicts for ldmatrix);
// CTAs that share a row tile are launched next to each other, so x is read
// from L2.  bf16: each warp owns 16 columns and every row of the tile,
// loads its fragments with ldmatrix and multiplies with mma.sync m16n8k16
// (bf16 in, float32 accumulators).  float32: the same tiles, float32 FMAs
// on the CUDA cores in k order (no TF32).  The launch is bound by bytes, so
// wgmma and TMA would not move it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // output columns per CTA, 16 per warp
constexpr int kBK = 32;        // depth of one pipeline stage
constexpr int kStages = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Layout {  // shared-memory row strides (elements), 16 bytes of padding
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kXS = kBK + kVec;
  static constexpr int kWS = kBN + kVec;
  template <int BM>
  __host__ __device__ static constexpr int stage_elems() {
    return BM * kXS + kBK * kWS;
  }
};

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

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
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

// One stage: x rows [row0, row0 + rows) x depth [k0, k0 + 32) and w rows
// [k0, k0 + 32) x columns [n0, n0 + 128) of expert wg; the rest zero.
template <typename T, int BM>
__device__ __forceinline__ void load_stage(T* xs, T* ws,
                                           const T* __restrict__ x,
                                           const T* __restrict__ wg, int row0,
                                           int rows, int k0, int n0, int D,
                                           int F) {
  using L = Layout<T>;
  constexpr int V = L::kVec;
  for (int c = threadIdx.x; c < BM * (kBK / V); c += kThreads) {
    const int r = c / (kBK / V), kc = (c % (kBK / V)) * V;
    const bool ok = r < rows && k0 + kc < D;
    const T* src = ok ? x + (long long)(row0 + r) * D + k0 + kc : x;
    cp_async16(xs + r * L::kXS + kc, src, ok);
  }
  for (int c = threadIdx.x; c < kBK * (kBN / V); c += kThreads) {
    const int kr = c / (kBN / V), nc = (c % (kBN / V)) * V;
    const bool ok = k0 + kr < D && n0 + nc < F;
    const T* src = ok ? wg + (long long)(k0 + kr) * F + n0 + nc : wg;
    cp_async16(ws + kr * L::kWS + nc, src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per-thread accumulators and the product of one stage, by dtype.
template <typename T, int BM>
struct Product;

// bf16: warp w owns columns [16 w, 16 w + 16) of every row; per 16-deep
// step one ldmatrix.x4.trans gives the two n8 B fragments, one ldmatrix.x4
// per 16 rows the A fragment.  acc[m][n][i] follows mma's C layout: rows
// 16 m + lane / 4 (+ 8 for i >= 2), column 16 w + 8 n + 2 (lane % 4) + i % 2.
template <int BM>
struct Product<__nv_bfloat16, BM> {
  using L = Layout<__nv_bfloat16>;
  float acc[BM / 16][2][4] = {};

  __device__ __forceinline__ void step(const __nv_bfloat16* xs,
                                       const __nv_bfloat16* ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned b[4];
      ldmatrix_x4_trans(b, ws + (kk + r + (mi & 1) * 8) * L::kWS + warp * 16 +
                               (mi >> 1) * 8);
#pragma unroll
      for (int m = 0; m < BM / 16; ++m) {
        unsigned a[4];
        ldmatrix_x4(a, xs + (m * 16 + r + (mi & 1) * 8) * L::kXS + kk +
                           (mi >> 1) * 8);
        mma_bf16(acc[m][0], a, b[0], b[1]);
        mma_bf16(acc[m][1], a, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* out, int row0,
                                        int rows, int n0, int F) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int m = 0; m < BM / 16; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m * 16 + (lane >> 2) + h * 8;
          const int col = n0 + warp * 16 + n * 8 + (lane & 3) * 2;
          if (row < rows && col < F)  // F % 8 == 0: col + 1 < F too
            *reinterpret_cast<__nv_bfloat162*>(
                out + (long long)(row0 + row) * F + col) =
                __floats2bfloat162_rn(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
        }
  }
};

// float32: warp w owns columns [16 w, 16 w + 16); lane l takes column
// 16 w + l % 16 and rows l / 16 + 2 i; one FMA per (row, k) in k order.
template <int BM>
struct Product<float, BM> {
  using L = Layout<float>;
  float acc[BM / 2] = {};

  __device__ __forceinline__ void step(const float* xs, const float* ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = warp * 16 + (lane & 15), r0 = lane >> 4;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float wv = ws[kk * L::kWS + col];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i)
        acc[i] = fmaf(xs[(r0 + 2 * i) * L::kXS + kk], wv, acc[i]);
    }
  }

  __device__ __forceinline__ void store(float* out, int row0, int rows,
                                        int n0, int F) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = n0 + warp * 16 + (lane & 15);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int row = (lane >> 4) + 2 * i;
      if (row < rows && col < F) out[(long long)(row0 + row) * F + col] = acc[i];
    }
  }
};

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ sizes, T* __restrict__ out,
                      int T_rows, int D, int F, int E, int cap) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const Tile t = cap > 0 ? counts_tile(sizes, E, T_rows, cap, BM, blockIdx.y)
                         : find_tile(sizes, E, T_rows, BM, blockIdx.y);
  const int n0 = blockIdx.x * kBN;
  for (int i = threadIdx.x; i < t.zeros * kBN; i += kThreads) {
    const int r = t.rows + i / kBN, c = n0 + i % kBN;
    if (c < F) out[(long long)(t.row0 + r) * F + c] = zero<T>();
  }
  if (t.rows == 0) return;  // before a weight byte is read
  const T* wg = w + (long long)t.group * D * F;
  constexpr int kStage = L::template stage_elems<BM>();
  const int KT = (D + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT)
      load_stage<T, BM>(smem + s * kStage, smem + s * kStage + BM * L::kXS, x,
                        wg, t.row0, t.rows, s * kBK, n0, D, F);
    cp_async_commit();
  }
  Product<T, BM> prod;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    const int nk = kt + kStages - 1;
    if (nk < KT) {
      T* st = smem + (nk % kStages) * kStage;
      load_stage<T, BM>(st, st + BM * L::kXS, x, wg, t.row0, t.rows, nk * kBK,
                        n0, D, F);
    }
    cp_async_commit();
    const T* st = smem + (kt % kStages) * kStage;
    prod.step(st, st + BM * L::kXS);
  }
  cp_async_wait<0>();
  prod.store(out, t.row0, t.rows, n0, F);
}

template <typename T, int BM>
int launch(const void* x, const void* w, const int* sizes, void* out, int T_,
           int D, int F, int E, int cap, int grid_rows, cudaStream_t stream) {
  using L = Layout<T>;
  const size_t smem =
      (size_t)kStages * L::template stage_elems<BM>() * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      grouped_matmul_kernel<T, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((F + kBN - 1) / kBN, grid_rows);
  grouped_matmul_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w, sizes, (T*)out, T_, D, F, E, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bm(const void* x, const void* w, const int* sizes, void* out,
                int T_, int D, int F, int E, int cap, int bm, int grid_rows,
                cudaStream_t st) {
  if (bm <= 16)
    return launch<T, 16>(x, w, sizes, out, T_, D, F, E, cap, grid_rows, st);
  if (bm <= 32)
    return launch<T, 32>(x, w, sizes, out, T_, D, F, E, cap, grid_rows, st);
  return launch<T, 64>(x, w, sizes, out, T_, D, F, E, cap, grid_rows, st);
}

}  // namespace

// x (T, D), w (E, D, F), out (T, F): contiguous, all bf16 (bf16 != 0) or
// all float32; sizes (E,) int32 on the card.  cap > 0: the counts layout
// with group stride cap, else the contiguous layout.  bm: the row tile,
// 16, 32 or 64; grid_rows: the row tiles of the launch, ceil(T / bm) +
// E + 1 (contiguous) or E ceil(cap / bm) + ceil(max(T - E cap, 0) / bm)
// (counts), below 65,536.  D and F multiples of 8 (checked by the wrapper).
extern "C" int zipper_grouped_matmul(const void* x, const void* w,
                                     const int* sizes, void* out, int bf16,
                                     int T, int D, int F, int E, int cap,
                                     int bm, int grid_rows, void* stream) {
  if (T == 0 || F == 0 || grid_rows == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch_bm<__nv_bfloat16>(x, w, sizes, out, T, D, F, E, cap, bm,
                                      grid_rows, st);
  return dispatch_bm<float>(x, w, sizes, out, T, D, F, E, cap, bm, grid_rows,
                            st);
}

extern "C" const char* zipper_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
