// K6: flash-attention forward (causal / windowed / bidirectional GQA) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (_fa_kernel):
// q (B, Sq, H, hd), k/v (B, Skv, KVH, hd) -> o (B, Sq, H, hd).  Query head
// h reads KV head h / (H / KVH); query row i sits at position
// i + Skv - Sq; a key is valid when kpos < Skv, and kpos <= qpos when
// causal, and qpos - kpos < window when windowed.  Scores are scaled,
// masked scores are set to the finite -1e30, and the online softmax
// (running max m, running sum l, accumulator acc) is float32; o is
// rounded to q's dtype once.  Its plain version is
// kernels/ref.py::flash_attention_ref.  The mbarrier, TMA and wgmma
// helpers are csrc/hopper.cuh's, shared with K7.
//
// Bound.  At TinyLlama's prefill (B = 4, S = 512, H = 32, KVH = 4,
// hd = 64, bf16, causal) the inputs and output are ~19 MB (5.6 us at
// 3.35 TB/s) against ~4.3 GFLOP of causal products (4.4 us at the tensor
// cores' 989 TFLOP/s); at S = 4,096 the operations bound it (69 GFLOP,
// 69.5 us).  So the bf16 route must run its products on the tensor cores
// and keep them fed.
//
// bf16 route (wgmma), FlashAttention-3's forward shape.  One CTA of three
// warpgroups per (b * H + h, 128 query rows): heads on grid.x, query tiles
// on grid.y, so B * H may reach grid.x's 2^31 - 1.  Warpgroup 0 is the
// producer: it gives its registers up (setmaxnreg.dec) and one thread
// issues TMA loads, Q once and the K and V tiles into a ring of shared
// memory (3 stages; 4 of 32-key tiles at hd = 256, 192 KB with Q), each
// stage with a full and an empty mbarrier.  The
// tensor maps are 4-d (hd, S, heads, B) over the caller's strides, built
// on the host per call; TMA zero-fills what lies past Sq, Skv or hd, so
// ragged tails and hd < 64 need no masking of loads.  Rows are 128-byte
// swizzle atoms of 64 bf16 values; hd = 128 is two atoms side by side and
// hd = 256 four.  Warpgroups 1 and 2 (setmaxnreg.inc) each own 64 query
// rows:
//   S = Q K^T   wgmma m64nBKk16, Q and K both K-major in shared memory
//               (BK = 128 keys up to hd = 64, 64 up to 128, 32 up to
//               256, where O alone takes 128 floats a thread);
//   softmax     on the accumulator fragment, in base 2 (ex2): a row lives
//               in the 4 threads of a quad, so its max and sum are two
//               shfl_xor each; only tiles that cross the diagonal, the
//               window's edge or Skv take the masked path, which masks
//               through the fragment's (row, column) map;
//   O += P V    P split into three bf16 parts (P_hi = bf16(P), P_mid =
//               bf16(P - P_hi), P_lo = bf16(P - P_hi - P_mid)), re-packed
//               from the S fragment as the A operand in registers, three
//               wgmma m64n64k16 per 16 keys and 64 columns against V
//               (MN-major, B transposed) in shared memory.  Three parts
//               hold P to ~2^-24, float32's own precision, so the output
//               stays within one bf16 rounding (plus 1e-6) of the float32
//               plain version; two parts (~2^-17) miss that on rows that
//               see few keys (early causal rows), as the emulation in
//               tests/test_torch_attention.py shows.  The cost is 3x the
//               PV products of a single bf16 P, 2x the operations in all.
// Overlap.  Tile i's S is issued together with tile i - 1's PV, so the
// softmax of tile i runs while that PV does; the two consumer warpgroups
// take turns at the tensor cores (two named barriers), so one's softmax
// runs while the other's products do.  ptxas serialises every wgmma of a
// function (C7514, C7520) when a call (IEEE division's slow path), a
// wgmma on a path it cannot prove warp-uniform, or a wait it cannot match
// on every path stands between a wgmma and the reads of its registers:
// the output is scaled by an approximate reciprocal, the warpgroup index
// is broadcast with a shfl, and the first tile is peeled so that every
// wait sits on a straight path.
// Causal tiles past the block's last query and tiles wholly below a
// window are never loaded; the first valid tile of a row wipes what a
// fully masked one before it added (alpha = 2^(-1e30 - m) = 0); heavy
// causal blocks (the last query rows) are issued first.
//
// float32 route (fma, not on any serving path).  One CTA of 256 threads
// per (b * H + h, 64 query rows) loops over 64-key tiles (hd = 256: 214,016
// bytes of shared memory); q, k and v are
// read through their strides into padded shared-memory tiles, and both
// products are float32 FMAs on the CUDA cores in a 16 x 16 thread grid
// (row max and sum are xor-butterflies over the 16 lanes of a row).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // finite: a fully masked tile is wiped later

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// float32 route: FMAs on the CUDA cores
// ---------------------------------------------------------------------------
namespace fma_route {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid

// rows [row0, row0 + 64) of one head into a [64][D + 1] float tile; rows
// past `rows` and columns past `hd` are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          Strides st, int b, int head,
                                          int row0, int rows, int hd) {
  const float* base = src + b * st.b + head * st.h;
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float x = 0.0f;
    if (r < rows && c < hd) x = base[(long long)(row0 + r) * st.s + c];
    dst[r * (D + 1) + c] = x;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) +
                                  kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int G,
                 int Sq, int Skv, int hd, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, int causal, int window) {
  constexpr int LD = D + 1;    // padded row of a Q/K/V tile
  constexpr int LP = kBK + 1;  // padded row of the P tile
  constexpr int NJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int off = Skv - Sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<D>(Qs, q, qs, b, h, q0, min(kBQ, Sq - q0), hd);

  // the KV tiles any row of this block can see
  const int n_kt = (Skv + kBK - 1) / kBK;
  int kt_hi = n_kt, kt_lo = 0;
  if (causal) {
    const int q_last = min(q0 + kBQ, Sq) - 1 + off;
    kt_hi = q_last < 0 ? 0 : min(n_kt, q_last / kBK + 1);
  }
  if (window) kt_lo = max(0, q0 + off - window + 1) / kBK;

  float m_run[4], l_run[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D>(Ks, k, ks, b, kvh, k0, min(kBK, Skv - k0), hd);
    load_tile<D>(Vs, v, vs, b, kvh, k0, min(kBK, Skv - k0), hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
      alpha[i] = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha[i] + sum;
      m_run[i] = m_new;
    }
    __syncthreads();  // P complete

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha[i];
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], w[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    float* dst = o + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) dst[col] = acc[i][j] / l;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KVH, int Sq, int Skv, int hd, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H,
      H / KVH, Sq, Skv, hd, qs, ks, vs, os, scale, causal, window);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KVH, int Sq, int Skv, int hd, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal, int window,
             cudaStream_t st) {
  if (hd <= 32)
    return launch<32>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs, os,
                      scale, causal, window, st);
  if (hd <= 64)
    return launch<64>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs, os,
                      scale, causal, window, st);
  if (hd <= 128)
    return launch<128>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs, os,
                       scale, causal, window, st);
  return launch<256>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs, os,
                     scale, causal, window, st);
}

}  // namespace fma_route

// ---------------------------------------------------------------------------
// bf16 route: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------
namespace wgmma_route {

using hopper::desc_sw128;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int kBQ = 128;       // query rows per CTA, 64 per consumer
constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kAtom = 64;      // bf16 values in a 128-byte swizzled row
constexpr int kRowBytes = 128;

// Shared memory of one CTA, in bytes from a 1024-byte-aligned base: Q as
// [consumer][atom][64 rows][128 B], K and V as [stage][atom][BK rows][128 B]
// in a ring of ST stages, then the mbarriers.
template <int HD, int BK, int ST>
struct Smem {
  static constexpr int kStages = ST;
  static constexpr int kAtoms = HD / kAtom;
  static constexpr int kQAtom = 64 * kRowBytes;          // 64 rows, 8 KB
  static constexpr int kQBytes = 2 * kAtoms * kQAtom;
  static constexpr int kTileAtom = BK * kRowBytes;
  static constexpr int kTileBytes = kAtoms * kTileAtom;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // q_full, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// D (64 x 32) (+)= A (64 x 16, shared) * B (32 x 16, shared)^T, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) (+)= A (64 x 16, shared) * B (64 x 16, shared)^T, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128) (+)= A (64 x 16, shared) * B (128 x 16, shared)^T, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[3][N][M]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j)
        asm volatile("" : "+r"(r[k][i][j])::"memory");
}
// named barriers 1, 2 (0 is __syncthreads'): the consumers' turns
constexpr int kTurn = 1;
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers)
               : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The softmax state of one thread's two rows, in base 2: scores are
// scaled by scale * log2(e), so exp(s - m) is ex2 of their difference.
template <int BK>
struct Rows {
  int qpos[2];  // key positions of the two rows
  int q_first;  // of the warpgroup's first row
  int quad;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};

  // Scaled scores of the tile at key k0 and their row maxima; with kMask,
  // masked through the fragment's (row, column) map.
  template <bool kMask>
  __device__ __forceinline__ void scores(float (&sc)[BK / 2], int k0, int Skv,
                                         int causal, int window,
                                         float scale_log2, float (&mx)[2]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float x = sc[4 * j + e] * scale_log2;
        if (kMask) {
          const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && qpos[r] >= kpos;
          if (window) ok = ok && qpos[r] - kpos < window;
          x = ok ? x : kNegInf;
        }
        sc[4 * j + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
  }

  // S of the tile at key k0 -> P (in place), alpha: the factor of the
  // accumulator rows.  Only tiles crossing the diagonal, the window's edge
  // or Skv take the masked path (a branch, so the others pay nothing).
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], int k0,
                                          int Skv, int causal, int window,
                                          float scale_log2, float (&alpha)[2]) {
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q_first) ||
                      (window && q_first + 63 - k0 >= window);
    float mx[2] = {m_run[0], m_run[1]};
    if (edge)
      scores<true>(sc, k0, Skv, causal, window, scale_log2, mx);
    else
      scores<false>(sc, k0, Skv, causal, window, scale_log2, mx);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(sc[4 * j + e] - mx[e / 2]);
        sc[4 * j + e] = pe;
        sum[e / 2] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      alpha[r] = ex2(m_run[r] - mx[r]);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
      m_run[r] = mx[r];
    }
  }
};

// P as the A operand in three bf16 parts, each the rounding of what the
// parts before it leave (exact in float32): 16 keys a step, registers
// {8 kk + 2 r, + 1} of the fragment
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2],
                                        uint32_t (&p)[3][BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        const float2 hf = __bfloat1622float2(hi);
        p[part][kk][r] = bf16x2_bits(hi);
        x -= hf.x;
        y -= hf.y;
      }
    }
}

// acc += P V for one tile: three wgmma m64n64k16 per 16 keys and 64
// columns, V MN-major in shared memory at vs
template <int A, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[A][32],
                                         const uint32_t (&p)[3][BK / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const uint64_t dv =
          desc_sw128(vs + a * BK * kRowBytes + kk * 16 * kRowBytes);
#pragma unroll
      for (int part = 0; part < 3; ++part) wgmma_rs(acc[a], p[part][kk], dv);
    }
}

template <int HD, int BK, int ST>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, Strides os, int H, int G,
                int Sq, int Skv, int hd, float scale, int causal,
                int window) {
  using L = Smem<HD, BK, ST>;
  constexpr int A = L::kAtoms;
  constexpr int kStages = ST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int off = Skv - Sq;
  // the KV tiles any row of this block can see
  const int n_kt = (Skv + BK - 1) / BK;
  int kt_hi = n_kt, kt_lo = 0;
  if (causal) {
    const int q_last = min(q0 + kBQ, Sq) - 1 + off;
    kt_hi = q_last < 0 ? 0 : min(n_kt, q_last / BK + 1);
  }
  if (window) kt_lo = max(0, q0 + off - window + 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, made warp-uniform for the compiler (shfl): wgmma must
  // sit on a path it can tell is uniform, or ptxas serialises it
  const int wg = __shfl_sync(kFull, threadIdx.x / 128, 0);
  if (wg == 0) {  // producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int a = 0; a < A; ++a)
          tma_load(base + L::kQ + (c * A + a) * L::kQAtom, &qmap, q_full,
                   a * kAtom, q0 + 64 * c, h, b);
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const int at = s * L::kTileBytes + a * L::kTileAtom;
          tma_load(base + L::kK + at, &kmap, full0 + 8 * s, a * kAtom,
                   kt * BK, kvh, b);
          tma_load(base + L::kV + at, &vmap, full0 + 8 * s, a * kAtom,
                   kt * BK, kvh, b);
        }
      }
    }
  } else {  // consumer warpgroups 1, 2: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32, quad = lane % 4;
    // this thread's two rows: fragment registers 4 j + {0, 1} hold row r0,
    // 4 j + {2, 3} row r0 + 8, at columns 8 j + 2 quad + {0, 1}
    const int r0 = q0 + 64 * c + 16 * (t / 32) + lane / 4;
    Rows<BK> rows;
    rows.qpos[0] = r0 + off;
    rows.qpos[1] = r0 + 8 + off;
    rows.q_first = q0 + 64 * c + off;
    rows.quad = quad;

    float acc[A][32];
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
    float sc[BK / 2];       // S of the newest tile, then its P
    uint32_t p[3][BK / 16][4];  // P of the tile before, in three bf16 parts
    const uint32_t qs = base + L::kQ + c * A * L::kQAtom;
    const float scale_log2 = scale * 1.4426950408889634f;
    const int n = kt_hi - kt_lo;
    auto k_at = [&](int i) {
      return base + L::kK + (i % kStages) * L::kTileBytes;
    };
    auto v_at = [&](int i) {
      return base + L::kV + (i % kStages) * L::kTileBytes;
    };
    mbar_wait(q_full, 0);

    // Ping-pong: the two warpgroups take turns at the tensor cores (named
    // barrier kTurn + w is warpgroup w's turn), so one's softmax runs
    // while the other's products do.  Within a warpgroup, tile i's S is
    // issued with tile i - 1's PV, and its softmax runs while that PV
    // does.  The first tile is peeled and every wait is on a straight
    // path: ptxas serialises wgmma it cannot prove finished where its
    // registers are read.
    auto issue_s = [&](int i) {
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {  // 16 columns of hd a step
        const int a = kk / 4, kb = (kk % 4) * 32;
        wgmma_ss(sc, desc_sw128(qs + a * L::kQAtom + kb),
                 desc_sw128(k_at(i) + a * L::kTileAtom + kb), kk > 0);
      }
      wgmma_commit();
    };
    if (n > 0) {
      if (c == 1) named_arrive(kTurn);  // warpgroup 0 goes first
      mbar_wait(full0, 0);
      named_sync(kTurn + c);
      issue_s(0);
      if (c == 0 || n > 1) named_arrive(kTurn + 1 - c);
      wgmma_wait<0>();
      fence_regs(sc);
      float alpha[2];  // acc is zero: nothing to rescale
      rows.softmax(sc, kt_lo * BK, Skv, causal, window, scale_log2, alpha);
      split_p<BK>(sc, p);
      for (int i = 1; i < n; ++i) {
        mbar_wait(full0 + 8 * (i % kStages), (i / kStages) & 1);
        named_sync(kTurn + c);
        issue_s(i);
        issue_pv<A, BK>(acc, p, v_at(i - 1));
        wgmma_commit();
        if (c == 0 || i + 1 < n) named_arrive(kTurn + 1 - c);
        wgmma_wait<1>();  // S of tile i; tile i - 1's PV may still run
        fence_regs(sc);
        rows.softmax(sc, (kt_lo + i) * BK, Skv, causal, window, scale_log2,
                     alpha);
        wgmma_wait<0>();  // tile i - 1's PV: its V and P are free
#pragma unroll
        for (int a = 0; a < A; ++a) fence_regs(acc[a]);
        fence_regs(p);
        mbar_arrive(empty0 + 8 * ((i - 1) % kStages));
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int i2 = 0; i2 < 32; ++i2) acc[a][i2] *= alpha[(i2 / 2) % 2];
        split_p<BK>(sc, p);
      }
      // the last tile's PV
#pragma unroll
      for (int a = 0; a < A; ++a) fence_regs(acc[a]);
      wgmma_fence();
      issue_pv<A, BK>(acc, p, v_at(n - 1));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < A; ++a) fence_regs(acc[a]);
      mbar_arrive(empty0 + 8 * ((n - 1) % kStages));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= Sq) continue;
      // 1 / l without IEEE division: its slow path is a call, and ptxas
      // serialises every wgmma of a function that makes calls
      const float inv_l = __fdividef(1.0f, fmaxf(rows.l_run[r], 1e-30f));
      __nv_bfloat16* dst = o + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = a * kAtom + 8 * j + 2 * quad;
          if (col < hd)  // hd % 8 == 0: col + 1 < hd too
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(acc[a][4 * j + 2 * r] * inv_l,
                                      acc[a][4 * j + 2 * r + 1] * inv_l);
        }
    }
  }
}

// (hd, S, heads, B) bf16 at `ptr` with element strides st, boxes of
// (64, rows, 1, 1), 128-byte swizzle, zeros past every edge
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads,
              int B, Strides st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, (cuuint32_t)rows, 1, 1};
  return hopper::make_map_bf16(map, ptr, dims, strides, box);
}

template <int HD, int BK, int ST>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KVH, int Sq, int Skv, int hd, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  using L = Smem<HD, BK, ST>;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, hd, Sq, H, B, qs, 64) ||
      !make_map(&kmap, k, hd, Skv, KVH, B, ks, BK) ||
      !make_map(&vmap, v, hd, Skv, KVH, B, vs, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD, BK, ST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_wgmma<HD, BK, ST><<<grid, kThreads, L::kBytes, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, os, H, H / KVH, Sq, Skv, hd, scale,
      causal, window);
  return (int)cudaGetLastError();
}

// hd <= 64 takes one swizzle atom and 128-key tiles; up to 128, two atoms
// and 64-key tiles (registers: O is 64 floats a thread there); up to 256,
// four atoms and 32-key tiles in a 4-stage ring (O is 128 floats a thread,
// S 16 and the three parts of P 24, inside setmaxnreg's 232; shared memory
// 64 KB of Q + 4 x 32 KB of K and V)
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KVH, int Sq, int Skv, int hd, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal, int window,
             cudaStream_t st) {
  if (hd <= 64)
    return launch<64, 128, 3>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs,
                              os, scale, causal, window, st);
  if (hd <= 128)
    return launch<128, 64, 3>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs,
                              os, scale, causal, window, st);
  return launch<256, 32, 4>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs,
                            os, scale, causal, window, st);
}

}  // namespace wgmma_route
}  // namespace

// q (B, Sq, H, hd), k/v (B, Skv, KVH, hd), o (B, Sq, H, hd), each with
// unit stride on hd and the given element strides on (batch, seq, head);
// bf16 != 0: all four are bf16 (the wgmma route; q, k and v 16-byte
// aligned with strides that are multiples of 8), else float32 (the fma
// route).  hd a multiple of 8 up to 256 (the wrapper pads any other hd
// up to 256 with zero columns), H a multiple of KVH; B * H runs on
// grid.x and the query tiles on grid.y, so Sq / 64 < 65,536 (checked by
// the wrapper).
extern "C" int zipper_flash_attention(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int H, int KVH, int Sq, int Skv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss, long long osh,
    float scale, int causal, int window, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return wgmma_route::dispatch(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks,
                                 vs, os, scale, causal, window, st);
  return fma_route::dispatch(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs,
                             os, scale, causal, window, st);
}

extern "C" const char* zipper_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
