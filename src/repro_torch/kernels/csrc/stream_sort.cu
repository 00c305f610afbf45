// K4: stream sort (mssortk + mssortv) for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/stream_sort.py::stream_sort_pallas:
// one (S, R) chunk front per issue, one R-chunk per stream.  Mask entries
// past lens to EMPTY, stable sort on (key, source lane), sum each
// duplicate run, compress the run totals to the front.  Each run is
// summed from zero left to right (0 + v0 + v1 ...), so the result is bit
// for bit the plain-torch kernels/ref.py::stream_sort_ref (and the JAX
// reference's XLA tier), a stricter match than the Pallas kernel's tree
// scan.  Values are float32 or bfloat16 (summed in float32, rounded once).
//
// Bound: bytes, and at the host driver's shape (S = 512, R = 16: 8,192
// elements, ~135 KB) even those are 0.04 us at 3.35 TB/s, so one issue
// is bound by its launch.  The design does not try to fill 132 SMs: a
// block of 256 threads takes 256 elements (256 / R streams), so the
// front is 32 blocks, and runs sort_tile (zipper.cuh, shared with K1) on
// them in shared memory: a rank sort by (key, lane) comparisons against
// the stream's R keys, a sequential run sum by the thread holding each
// run's last element, a ballot/popc prefix for the compress.  Every
// element is read once and every output written once.
#include "zipper.cuh"

namespace {

constexpr int kTileElems = 256;

template <typename V>
__global__ void __launch_bounds__(zipper::kThreads)
stream_sort_kernel(const int* __restrict__ keys, const V* __restrict__ vals,
                   const int* __restrict__ lens, int S, int R, int spb,
                   int* __restrict__ ok, V* __restrict__ ov,
                   int* __restrict__ ol) {
  extern __shared__ unsigned char smem[];
  const int cap = spb * R;
  int* in_k = reinterpret_cast<int*>(smem);
  float* in_v = reinterpret_cast<float*>(in_k + cap);
  int* tmp_k = reinterpret_cast<int*>(in_v + cap);
  float* tmp_v = reinterpret_cast<float*>(tmp_k + cap);
  unsigned* bits = reinterpret_cast<unsigned*>(tmp_v + cap);
  const long long s0 = (long long)blockIdx.x * spb;
  const int ns = (int)min((long long)spb, S - s0);
  const int E = ns * R;
  const long long g0 = s0 * R;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int s = e / R, i = e - s * R;
    const bool valid = i < lens[s0 + s];
    in_k[e] = valid ? keys[g0 + e] : zipper::kEmpty;
    in_v[e] = valid ? zipper::load_val(vals + g0 + e) : 0.0f;
  }
  __syncthreads();
  zipper::sort_tile(E, R, in_k, in_v, tmp_k, tmp_v, bits, ok + g0, ov + g0,
                    ol + s0, /*zero_start=*/true);
}

template <typename V>
int launch(const int* keys, const V* vals, const int* lens, int S, int R,
           int* ok, V* ov, int* ol, void* stream) {
  if (S == 0) return 0;
  const int spb = std::max(1, kTileElems / R);
  const size_t cap = (size_t)spb * R;
  const size_t smem = cap * 16 + ((cap >> 5) + 1) * 4;
  cudaError_t err = zipper::allow_smem(stream_sort_kernel<V>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (S + spb - 1) / spb;
  stream_sort_kernel<V><<<grid, zipper::kThreads, smem,
                          (cudaStream_t)stream>>>(keys, vals, lens, S, R,
                                                  spb, ok, ov, ol);
  return (int)cudaGetLastError();
}

}  // namespace

// keys/ok: (S, R) int32; vals/ov: (S, R) float32 (bf16 = 0) or bfloat16
// (bf16 = 1); lens/ol: (S,) int32.  R a power of two.
extern "C" int zipper_stream_sort(const int* keys, const void* vals,
                                  const int* lens, int S, int R, int bf16,
                                  int* ok, void* ov, int* ol, void* stream) {
  if (bf16)
    return launch(keys, static_cast<const __nv_bfloat16*>(vals), lens, S, R,
                  ok, static_cast<__nv_bfloat16*>(ov), ol, stream);
  return launch(keys, static_cast<const float*>(vals), lens, S, R, ok,
                static_cast<float*>(ov), ol, stream);
}
