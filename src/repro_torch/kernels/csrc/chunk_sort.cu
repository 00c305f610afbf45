// K1: chunk sort for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/chunk_sort.py::chunk_sort_pallas
// (tile body sort_tile): for every (N, R) chunk, mask entries past lens to
// EMPTY, stable sort on (key, source lane), sum duplicate runs left to
// right, compress the run totals to the front.  Bit-identical to the
// plain-torch merge_tree.sort_chunks_linear.
//
// Bound: it moves bytes and does no arithmetic worth counting.  Each
// element is read once (key + value, 8 B), each output written once
// (8 B) plus 8 B of lengths per chunk, so the least time is those bytes
// at the card's 3.35 TB/s.  The design keeps every intermediate in
// shared memory: a block stages a tile of 2048 elements (2048 / R
// chunks) with coalesced loads, sorts, sums and compresses it there
// (sort_tile in zipper.cuh: rank sort by (key, lane) comparisons against
// the chunk's R keys, a sequential run sum by the thread holding each
// run's last element, a ballot/popc prefix for the compress), and writes
// each output element once.
#include "zipper.cuh"

namespace {

constexpr int kTileElems = 2048;

__global__ void __launch_bounds__(zipper::kThreads)
chunk_sort_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                  const int* __restrict__ lens, int N, int R, int cpb,
                  int* __restrict__ ok, float* __restrict__ ov,
                  int* __restrict__ ol) {
  extern __shared__ unsigned char smem[];
  const int cap = cpb * R;
  int* in_k = reinterpret_cast<int*>(smem);
  float* in_v = reinterpret_cast<float*>(in_k + cap);
  int* tmp_k = reinterpret_cast<int*>(in_v + cap);
  float* tmp_v = reinterpret_cast<float*>(tmp_k + cap);
  unsigned* bits = reinterpret_cast<unsigned*>(tmp_v + cap);
  const long long n0 = (long long)blockIdx.x * cpb;
  const int nc = (int)min((long long)cpb, N - n0);
  const int E = nc * R;
  const long long g0 = n0 * R;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int c = e / R, i = e - c * R;
    const bool valid = i < lens[n0 + c];
    in_k[e] = valid ? keys[g0 + e] : zipper::kEmpty;
    in_v[e] = valid ? vals[g0 + e] : 0.0f;
  }
  __syncthreads();
  zipper::sort_tile(E, R, in_k, in_v, tmp_k, tmp_v, bits, ok + g0, ov + g0,
                    ol + n0);
}

size_t smem_bytes(int cpb, int R) {
  const size_t cap = (size_t)cpb * R;
  return cap * 16 + ((cap >> 5) + 1) * 4;
}

}  // namespace

// keys/vals/ok/ov: (N, R); lens/ol: (N,).  R a power of two.
extern "C" int zipper_chunk_sort(const int* keys, const float* vals,
                                 const int* lens, int N, int R, int* ok,
                                 float* ov, int* ol, void* stream) {
  if (N == 0) return 0;
  const int cpb = std::max(1, kTileElems / R);
  const size_t smem = smem_bytes(cpb, R);
  cudaError_t err = zipper::allow_smem(chunk_sort_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + cpb - 1) / cpb;
  chunk_sort_kernel<<<grid, zipper::kThreads, smem, (cudaStream_t)stream>>>(
      keys, vals, lens, N, R, cpb, ok, ov, ol);
  return (int)cudaGetLastError();
}
