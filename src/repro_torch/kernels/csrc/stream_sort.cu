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
// is bound by its launch and its chain of latencies.  The kernel is
// zipper.cuh's chunk sort, shared with K1: the front's streams are
// sorted in registers by the lanes of one warp each, behind __syncwarp
// only, on 256 one-warp blocks (the warp route); a front wider than 256
// (sort_tokens_by_key's single front of up to 8,192) is staged in shared
// memory (the block route).  The design and the choice of its launch
// shape are written down there.
#include "zipper.cuh"

// keys/ok: (S, R) int32; vals/ov: (S, R) float32 (bf16 = 0) or bfloat16
// (bf16 = 1); lens/ol: (S,) int32.  R a power of two; items, warps: the
// warp route's shape, items = 0 for the block route.
extern "C" int zipper_stream_sort(const int* keys, const void* vals,
                                  const int* lens, int S, int R, int bf16,
                                  int items, int warps, int* ok, void* ov,
                                  int* ol, void* stream) {
  if (bf16)
    return zipper::launch_sort(keys, static_cast<const __nv_bfloat16*>(vals),
                               lens, S, R, items, warps, /*zero_start=*/true,
                               ok, static_cast<__nv_bfloat16*>(ov), ol,
                               stream);
  return zipper::launch_sort(keys, static_cast<const float*>(vals), lens, S,
                             R, items, warps, /*zero_start=*/true, ok,
                             static_cast<float*>(ov), ol, stream);
}
