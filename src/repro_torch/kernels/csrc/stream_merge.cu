// K5: stream merge (mszipk + mszipv) for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/stream_merge.py::stream_merge_pallas:
// per stream, two sorted, duplicate-free R-chunks with lengths.  The
// merge-bit cutoff is min(max_a, max_b) (-1 for an empty side); the keys
// at or below it on each side are consumed (their counts are returned)
// and union-merged, a key on both sides becoming the single add va + vb;
// the merged uniques are compressed and split into a low and a high
// R-half with the output length.  Each output value is its run summed
// from zero left to right ((0 + va) + vb, or 0 + v), so all seven outputs
// are bit for bit the plain-torch kernels/ref.py::stream_merge_ref.
//
// Bound: bytes, ~272 KB at the host driver's shape (S = 512, R = 16),
// 0.08 us at 3.35 TB/s: one issue is bound by its launch.  The design
// gives one warp to each stream (8 streams per block, 64 blocks at
// S = 512) and no shared memory.  The warp reduces the two fronts'
// maxima and consumed counts with warp reductions, then places the 2R
// candidates 32 at a time (at R = 16 one pass): each lane takes its
// element's rank in the other side's consumed prefix from a binary
// search (zipper::lower_bound, as K2's merge_tile does), and the count of
// earlier cross-side duplicates on its own side from a ballot and
// popc.  Every element is read once and every output slot written once.
#include "zipper.cuh"

namespace {

__device__ __forceinline__ void put(int* klo, float* vlo, int* khi,
                                    float* vhi, int R, int slot, int k,
                                    float v) {
  if (slot < R) {
    klo[slot] = k;
    vlo[slot] = v;
  } else {
    khi[slot - R] = k;
    vhi[slot - R] = v;
  }
}

__global__ void __launch_bounds__(zipper::kThreads)
stream_merge_kernel(const int* __restrict__ ka, const float* __restrict__ va,
                    const int* __restrict__ la, const int* __restrict__ kb,
                    const float* __restrict__ vb, const int* __restrict__ lb,
                    int S, int R, int* __restrict__ klo,
                    float* __restrict__ vlo, int* __restrict__ khi,
                    float* __restrict__ vhi, int* __restrict__ ca_out,
                    int* __restrict__ cb_out, int* __restrict__ ol_out) {
  const long long s = (long long)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (s >= S) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int* a = ka + s * R;
  const int* b = kb + s * R;
  const float* av = va + s * R;
  const float* bv = vb + s * R;
  const int na = max(0, min(la[s], R)), nb = max(0, min(lb[s], R));
  // merge-bit cutoff: the smaller of the two fronts' valid maxima
  int mxa = -1, mxb = -1;
  for (int r = lane; r < na; r += 32)
    if (a[r] != zipper::kEmpty) mxa = max(mxa, a[r]);
  for (int r = lane; r < nb; r += 32)
    if (b[r] != zipper::kEmpty) mxb = max(mxb, b[r]);
  const int cutoff = min(__reduce_max_sync(zipper::kFull, mxa),
                         __reduce_max_sync(zipper::kFull, mxb));
  int ca = 0, cb = 0;
  for (int r = lane; r < na; r += 32)
    ca += a[r] != zipper::kEmpty && a[r] <= cutoff;
  for (int r = lane; r < nb; r += 32)
    cb += b[r] != zipper::kEmpty && b[r] <= cutoff;
  ca = __reduce_add_sync(zipper::kFull, ca);
  cb = __reduce_add_sync(zipper::kFull, cb);
  // the consumed keys are each side's prefix [0, ca) / [0, cb): place
  // each at its rank among the merged uniques
  int* lo_k = klo + s * R;
  float* lo_v = vlo + s * R;
  int* hi_k = khi + s * R;
  float* hi_v = vhi + s * R;
  const unsigned lt = zipper::low_mask(lane);
  int dup_a = 0, dup_b = 0;  // cross-side duplicates placed so far per side
  for (int base = 0; base < 2 * R; base += 32) {
    const int x = base + lane;
    const bool side_a = x < R;
    const int i = side_a ? x : x - R;
    const bool sel = x < 2 * R && i < (side_a ? ca : cb);
    int key = 0, r = 0;
    bool match = false;
    if (sel) {
      const int* own = side_a ? a : b;
      const int* other = side_a ? b : a;
      const int n_other = side_a ? cb : ca;
      key = own[i];
      r = zipper::lower_bound(other, n_other, key);
      match = r < n_other && other[r] == key;
    }
    const unsigned mball = __ballot_sync(zipper::kFull, match);
    const unsigned amask = __ballot_sync(zipper::kFull, side_a);
    const unsigned own_mask = side_a ? amask : ~amask;
    const int before = (side_a ? dup_a : dup_b) + __popc(mball & lt & own_mask);
    if (sel && (side_a || !match)) {
      float v = 0.0f + (side_a ? av[i] : bv[i]);
      if (match) v = v + bv[r];
      put(lo_k, lo_v, hi_k, hi_v, R, i + r - before, key, v);
    }
    dup_a += __popc(mball & amask);
    dup_b += __popc(mball & ~amask);
  }
  const int ol = ca + cb - dup_a;
  for (int x = ol + lane; x < 2 * R; x += 32)
    put(lo_k, lo_v, hi_k, hi_v, R, x, zipper::kEmpty, 0.0f);
  if (lane == 0) {
    ca_out[s] = ca;
    cb_out[s] = cb;
    ol_out[s] = ol;
  }
}

}  // namespace

// ka/va/kb/vb and the outputs klo/vlo/khi/vhi: (S, R); la/lb and
// ca/cb/ol: (S,).  Keys int32, values float32.
extern "C" int zipper_stream_merge(const int* ka, const float* va,
                                   const int* la, const int* kb,
                                   const float* vb, const int* lb, int S,
                                   int R, int* klo, float* vlo, int* khi,
                                   float* vhi, int* ca, int* cb, int* ol,
                                   void* stream) {
  if (S == 0) return 0;
  const int warps = zipper::kThreads / 32;
  const int grid = (S + warps - 1) / warps;
  stream_merge_kernel<<<grid, zipper::kThreads, 0, (cudaStream_t)stream>>>(
      ka, va, la, kb, vb, lb, S, R, klo, vlo, khi, vhi, ca, cb, ol);
  return (int)cudaGetLastError();
}
