// K6: flash-attention forward (causal / windowed / bidirectional GQA) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (_fa_kernel):
// q (B, Sq, H, hd), k/v (B, Skv, KVH, hd) -> o (B, Sq, H, hd).  Query head
// h reads KV head h / (H / KVH); query row i sits at position
// i + Skv - Sq; a key is valid when kpos < Skv, and kpos <= qpos when
// causal, and qpos - kpos < window when windowed.  q, k and v are read as
// float32 (bf16 or float32 inputs), scores are scaled, masked scores are
// set to the finite -1e30, and the online softmax (running max m, running
// sum l, accumulator acc) and the PV product are float32; o is rounded to
// q's dtype once.  Its plain version is kernels/ref.py::flash_attention_ref.
//
// Bound.  At the serve shape (TinyLlama prefill: B = 4, S = 512, H = 32,
// KVH = 4, hd = 64, bf16, causal) the inputs and output are ~19 MB
// (5.6 us at 3.35 TB/s) and the causal products ~4.3 GFLOP (4.4 us at the
// tensor cores' 989 TFLOP/s): the two bounds are close, and at S = 4,096
// the operations bound it (69 GFLOP against 38 MB).  This first version
// multiplies with float32 FMAs on the CUDA cores (67 TFLOP/s), so its own
// ceiling is ~15x the tensor-core bound; wgmma, TMA and a bf16 PV product
// are later work.
//
// Design.  One CTA of 256 threads per (64 query rows, b * H + h); the
// loop over 64-key tiles inside the CTA takes the place of the TPU's
// sequential kv grid axis, so (m, l, acc) live in registers for the
// whole row block.  q, k and v are read in place through their strides
// (no transposed copies); each K/V tile is read from device memory once
// per query tile and reused by all 64 rows from shared memory (rows padded
// by one word: no bank conflicts).  Thread (ty, tx) of the 16 x 16 grid
// owns query rows ty + 16 i and key columns tx + 16 j (i, j < 4) of the
// score tile, and output columns tx + 16 j of the same rows; row max and
// row sum are xor-butterflies over the 16 lanes that share a row, so all
// of them hold bit-equal (m, l).  Causal tiles past the block's last
// query are skipped, as run_pred skips them, and so are tiles wholly
// below a window; the ragged tails (Sq, Skv not multiples of 64, hd < the
// template width) are zero-filled on load and masked, and rows >= Sq are
// not stored.  Heavy causal tiles (the last query blocks) are issued
// first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // finite: a fully masked tile is wiped later

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + 64) of one head into a [64][D + 1] float tile; rows
// past `rows` and columns past `hd` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int head,
                                          int row0, int rows, int hd) {
  const T* base = src + b * st.b + head * st.h;
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float x = 0.0f;
    if (r < rows && c < hd) x = to_f(base[(long long)(row0 + r) * st.s + c]);
    dst[r * (D + 1) + c] = x;
  }
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) +
                                  kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int G,
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

  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heavy tiles first
  const int off = Skv - Sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(Qs, q, qs, b, h, q0, min(kBQ, Sq - q0), hd);

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
    load_tile<T, D>(Ks, k, ks, b, kvh, k0, min(kBK, Skv - k0), hd);
    load_tile<T, D>(Vs, v, vs, b, kvh, k0, min(kBK, Skv - k0), hd);
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
    T* dst = o + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) store(dst + col, acc[i][j] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KVH, int Sq, int Skv, int hd, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / KVH, Sq, Skv, hd,
      qs, ks, vs, os, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_width(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Skv, int hd,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, int window, cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs, os,
                         scale, causal, window, st);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs, os,
                         scale, causal, window, st);
  return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs, os,
                        scale, causal, window, st);
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Skv, KVH, hd), o (B, Sq, H, hd), each with
// unit stride on hd and the given element strides on (batch, seq, head);
// bf16 != 0: all four are bf16, else float32.  hd a multiple of 8 up to
// 128, H a multiple of KVH, B * H < 65,536 (checked by the wrapper).
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
    return dispatch_width<__nv_bfloat16>(q, k, v, o, B, H, KVH, Sq, Skv, hd,
                                         qs, ks, vs, os, scale, causal,
                                         window, st);
  return dispatch_width<float>(q, k, v, o, B, H, KVH, Sq, Skv, hd, qs, ks, vs,
                               os, scale, causal, window, st);
}

extern "C" const char* zipper_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
