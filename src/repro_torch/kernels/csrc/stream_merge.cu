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
//
// Two entry points share that merge:
//   chunk    the reference kernel's contract: (S, R) fronts in, the seven
//            outputs out (the host driver gathers the fronts and
//            scatters the merged rows around it);
//   pointer  one whole issue of the host driver's merge round in one
//            launch: each stream's fronts are read at its pointers
//            (pa, pb) straight from the padded partitions, the merged
//            uniques appended at its output pointer, and the pointers,
//            the zip-element count, a per-issue flag and the count of
//            issues that did work advanced on the card, so the host
//            neither gathers, scatters nor waits.  A
//            stream not live on both sides before the issue is empty;
//            an issue with no live stream writes nothing.
#include "zipper.cuh"

namespace {

// Merge the fronts a[0, na) / b[0, nb) of one stream in one warp; emit(slot,
// key, value) stores each merged unique.  Returns (consumed a, consumed b,
// merged length) in ca / cb / ol.
template <typename Emit>
__device__ __forceinline__ void merge_fronts(const int* a, const float* av,
                                             int na, const int* b,
                                             const float* bv, int nb, int R,
                                             Emit emit, int* ca_out,
                                             int* cb_out, int* ol_out) {
  const int lane = threadIdx.x & 31;
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
      emit(i + r - before, key, v);
    }
    dup_a += __popc(mball & amask);
    dup_b += __popc(mball & ~amask);
  }
  *ca_out = ca;
  *cb_out = cb;
  *ol_out = ca + cb - dup_a;
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
  int* lo_k = klo + s * R;
  float* lo_v = vlo + s * R;
  int* hi_k = khi + s * R;
  float* hi_v = vhi + s * R;
  auto put = [&](int slot, int k, float v) {
    if (slot < R) {
      lo_k[slot] = k;
      lo_v[slot] = v;
    } else {
      hi_k[slot - R] = k;
      hi_v[slot - R] = v;
    }
  };
  int ca, cb, ol;
  merge_fronts(ka + s * R, va + s * R, max(0, min(la[s], R)), kb + s * R,
               vb + s * R, max(0, min(lb[s], R)), R, put, &ca, &cb, &ol);
  for (int x = ol + lane; x < 2 * R; x += 32) put(x, zipper::kEmpty, 0.0f);
  if (lane == 0) {
    ca_out[s] = ca;
    cb_out[s] = cb;
    ol_out[s] = ol;
  }
}

// One issue of the host driver's merge round.  Stream s is live when
// pa[s] < lens_a[s] and pb[s] < lens_b[s]; a live stream merges its fronts
// Ka[s, pa : pa + R) / Kb[s, pb : pb + R) (cut at the lengths), appends the
// merged uniques at Ko[s, optr], advances pa, pb and optr and adds the
// front sizes to zips[s].  flag gets bit 0 when a stream was live, bit 1
// when one is still live after the issue; the stream that sets bit 0
// first adds one to *worked (issues that did work).
__global__ void __launch_bounds__(zipper::kThreads)
stream_merge_ptr_kernel(const int* __restrict__ Ka,
                        const float* __restrict__ Va, long long a_stride,
                        const long long* __restrict__ lens_a,
                        const int* __restrict__ Kb,
                        const float* __restrict__ Vb, long long b_stride,
                        const long long* __restrict__ lens_b, int S, int R,
                        long long* __restrict__ pa, long long* __restrict__ pb,
                        long long* __restrict__ optr, int* __restrict__ Ko,
                        float* __restrict__ Vo, long long o_stride,
                        long long* __restrict__ zips,
                        unsigned* __restrict__ flag,
                        unsigned long long* __restrict__ worked) {
  const long long s = (long long)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (s >= S) return;  // warp-uniform
  const long long la = lens_a[s], lb = lens_b[s], a0 = pa[s], b0 = pb[s];
  if (!(a0 < la && b0 < lb)) return;  // not live: no write at all
  const int na = (int)min(la - a0, (long long)R);
  const int nb = (int)min(lb - b0, (long long)R);
  const long long o0 = optr[s];
  int* ko = Ko + s * o_stride + o0;
  float* vo = Vo + s * o_stride + o0;
  auto put = [&](int slot, int k, float v) {
    ko[slot] = k;
    vo[slot] = v;
  };
  int ca, cb, ol;
  merge_fronts(Ka + s * a_stride + a0, Va + s * a_stride + a0, na,
               Kb + s * b_stride + b0, Vb + s * b_stride + b0, nb, R, put, &ca,
               &cb, &ol);
  if ((threadIdx.x & 31) == 0) {
    pa[s] = a0 + ca;
    pb[s] = b0 + cb;
    optr[s] = o0 + ol;
    zips[s] += na + nb;
    if (!(atomicOr(flag, (a0 + ca < la && b0 + cb < lb) ? 3u : 1u) & 1u))
      atomicAdd(worked, 1ull);
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

// One issue of the pointer form.  Ka/Va: (S, *) rows a_stride apart
// (unit stride within a row), lens_a (S,) int64, the same for B; pa, pb,
// optr, zips: (S,) int64, updated in place; Ko/Vo: (S, *) rows o_stride
// apart; flag: one zeroed word; worked: one int64, counting the issues
// that did work.
extern "C" int zipper_stream_merge_ptr(
    const int* Ka, const float* Va, long long a_stride,
    const long long* lens_a, const int* Kb, const float* Vb,
    long long b_stride, const long long* lens_b, int S, int R, long long* pa,
    long long* pb, long long* optr, int* Ko, float* Vo, long long o_stride,
    long long* zips, unsigned* flag, unsigned long long* worked,
    void* stream) {
  if (S == 0) return 0;
  const int warps = zipper::kThreads / 32;
  const int grid = (S + warps - 1) / warps;
  stream_merge_ptr_kernel<<<grid, zipper::kThreads, 0,
                            (cudaStream_t)stream>>>(
      Ka, Va, a_stride, lens_a, Kb, Vb, b_stride, lens_b, S, R, pa, pb, optr,
      Ko, Vo, o_stride, zips, flag, worked);
  return (int)cudaGetLastError();
}
