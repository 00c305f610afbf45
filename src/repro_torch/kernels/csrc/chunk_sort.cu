// K1: chunk sort for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/chunk_sort.py::chunk_sort_pallas
// (tile body sort_tile): for every (N, R) chunk, mask entries past lens to
// EMPTY, stable sort on (key, source lane), sum duplicate runs left to
// right from their first value, compress the run totals to the front.
// Bit-identical to the plain-torch merge_tree.sort_chunks_linear.
//
// Bound: bytes (each element read and written once, 8 B each way, plus
// 8 B of lengths per chunk), far below one launch at the large route's
// N = S * C chunks of R = 16.  The kernel is zipper.cuh's chunk sort,
// shared with K4 (which sums its runs from zero): a chunk of up to 256
// slots is sorted in registers by the lanes of one warp, behind
// __syncwarp only, on a grid that spreads the chunks over the card (the
// warp route); a wider one is staged in shared memory (the block route).
// The design and the choice of its launch shape are written down there.
#include "zipper.cuh"

// keys/vals/ok/ov: (N, R); lens/ol: (N,).  R a power of two; items,
// warps: the warp route's shape, items = 0 for the block route.
extern "C" int zipper_chunk_sort(const int* keys, const float* vals,
                                 const int* lens, int N, int R, int items,
                                 int warps, int* ok, float* ov, int* ol,
                                 void* stream) {
  return zipper::launch_sort(keys, vals, lens, N, R, items, warps,
                             /*zero_start=*/false, ok, ov, ol, stream);
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of a kernel that does nothing: the floor under any one-launch
// kernel's time (chip_smoke.py's launch_floor_ms).
extern "C" int zipper_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
