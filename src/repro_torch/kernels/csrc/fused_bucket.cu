// K3: fused bucket (chunk sort + the whole zip-merge tree) for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/fused_bucket.py::
// fused_bucket_pallas: sort all S * C R-chunks of an (S, L = C * R) work
// bucket, then fold the C sorted partitions of every stream through
// log2(C) merge rounds, in one launch with the partitions on chip.  It
// emits the per-(stream, round-pair) counter planes laid out as the
// Pallas kernel lays them out: round r's pairs at columns
// [C - (C >> r), C - (C >> (r + 1))) of four (S, C - 1) int32 planes
// (steps, zip elements, tail chunks of side A, of side B).
//
// Bound: bytes.  The bucket is read once (8 B per element plus the
// stream lengths) and written once (8 B per element, the lengths and the
// counter planes); every intermediate partition stays in shared memory,
// which is what the fusion buys over K1 + one K2 per round.  The design:
// a block holds spb streams (spb * L elements, spb = max(1, 2048 / L))
// as keys and values double-buffered in dynamic shared memory, 16 B per
// element, plus ballot words and partition lengths.  It runs K1's
// sort_tile over all chunks, then per round K2's merge_tile from one
// buffer into the other and K2's advance loop, one warp per
// (stream, pair).  A block may use 232,448 B of shared memory, so a
// single stream fits up to L = 8192 (141,312 B at R = 8); a bucket with
// L >= 16,384 does not fit, and the Python wrapper runs it as K1 once
// and one K2 launch per round instead (the large-bucket route).
#include "zipper.cuh"

namespace {

constexpr int kTileElems = 2048;

struct Layout {
  int E, nwords, lens;
};

__host__ __device__ inline Layout layout(int spb, int L, int R) {
  Layout l;
  l.E = spb * L;
  l.nwords = (l.E >> 5) + 1;
  l.lens = spb * (L / R);
  return l;
}

__host__ __device__ inline size_t smem_bytes(int spb, int L, int R) {
  const Layout l = layout(spb, L, R);
  return (size_t)l.E * 16 + (size_t)l.nwords * 8 + (size_t)l.lens * 8;
}

__global__ void __launch_bounds__(zipper::kThreads)
fused_bucket_kernel(const int* __restrict__ keys,
                    const float* __restrict__ vals,
                    const int* __restrict__ plens, int S, int L, int R,
                    int spb, int* __restrict__ ok, float* __restrict__ ov,
                    int* __restrict__ ol, int* __restrict__ st,
                    int* __restrict__ zp, int* __restrict__ ta,
                    int* __restrict__ tb) {
  extern __shared__ unsigned char smem[];
  const Layout lay = layout(spb, L, R);
  const int E = lay.E, C = L / R, Cm1 = max(C - 1, 1);
  int* k0 = reinterpret_cast<int*>(smem);
  float* v0 = reinterpret_cast<float*>(k0 + E);
  int* k1 = reinterpret_cast<int*>(v0 + E);
  float* v1 = reinterpret_cast<float*>(k1 + E);
  unsigned* bits = reinterpret_cast<unsigned*>(v1 + E);
  int* pre = reinterpret_cast<int*>(bits + lay.nwords);
  int* lens0 = pre + lay.nwords;
  int* lens1 = lens0 + lay.lens;
  const int s0 = blockIdx.x * spb;
  const int tid = threadIdx.x;

  // masked load: chunk c of stream s holds clip(plen - c * R, 0, R)
  for (int e = tid; e < E; e += blockDim.x) {
    const int s = e / L, pos = e - s * L, g = s0 + s;
    const int plen = g < S ? plens[g] : 0;
    const bool valid = pos < plen;
    const long long gi = (long long)g * L + pos;
    k1[e] = valid ? keys[gi] : zipper::kEmpty;
    v1[e] = valid ? vals[gi] : 0.0f;
  }
  __syncthreads();
  // sort stage: K1's tile body over all spb * C chunks, in place in (k1, v1)
  zipper::sort_tile(E, R, k1, v1, k0, v0, bits, k1, v1, lens0);
  __syncthreads();

  // merge tree: round r reads (ck, cv, clens), writes (nk, nv, nlens)
  int *ck = k1, *nk = k0, *clens = lens0, *nlens = lens1;
  float *cv = v1, *nv = v0;
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  int W = R, cur_c = C, col = 0;
  while (cur_c > 1) {
    const int half = cur_c >> 1;
    zipper::PairTile t;
    t.ka = ck; t.va = cv; t.a_stride = 2 * W;
    t.kb = ck + W; t.vb = cv + W; t.b_stride = 2 * W;
    t.la = clens; t.lb = clens + 1; t.len_stride = 2;
    t.ok = nk; t.ov = nv; t.o_stride = 2 * W;
    t.ol = nlens;
    t.Wa = W; t.Wb = W; t.P = spb * half;
    zipper::merge_tile(t, bits, pre);
    // counters: one warp per (stream, pair) of this round
    for (int p = warp; p < t.P; p += nwarps) {
      const int s = p / half, q = p - s * half, g = s0 + s;
      if (g >= S) continue;
      const int* a = ck + (long long)p * 2 * W;
      const zipper::Advance adv = zipper::advance_warp(
          a, clens[2 * p], a + W, clens[2 * p + 1], R);
      if ((tid & 31) == 0) {
        const long long o = (long long)g * Cm1 + col + q;
        st[o] = adv.steps;
        zp[o] = adv.zips;
        ta[o] = adv.tail_a;
        tb[o] = adv.tail_b;
      }
    }
    __syncthreads();
    int* tk = ck; ck = nk; nk = tk;
    float* tv = cv; cv = nv; nv = tv;
    int* tl = clens; clens = nlens; nlens = tl;
    W *= 2;
    cur_c = half;
    col += half;
  }
  for (int e = tid; e < E; e += blockDim.x) {
    const int s = e / L, g = s0 + s;
    if (g < S) {
      const long long gi = (long long)g * L + (e - s * L);
      ok[gi] = ck[e];
      ov[gi] = cv[e];
    }
  }
  for (int s = tid; s < spb; s += blockDim.x)
    if (s0 + s < S) ol[s0 + s] = clens[s];
}

// Streams one block holds for a bucket of width L.
int streams_per_block(int S, int L) {
  return std::max(1, std::min(S, kTileElems / L));
}

}  // namespace

// Dynamic shared memory of one block; the wrapper takes the large-bucket
// route when this exceeds the card's per-block limit.
extern "C" long long zipper_fused_smem_bytes(int S, int L, int R) {
  return (long long)smem_bytes(streams_per_block(S, L), L, R);
}

// keys/vals/ok/ov: (S, L); plens/ol: (S,); st/zp/ta/tb: (S, max(C-1, 1))
// zero-filled by the caller.  L = C * R with R and C powers of two.
extern "C" int zipper_fused_bucket(const int* keys, const float* vals,
                                   const int* plens, int S, int L, int R,
                                   int* ok, float* ov, int* ol, int* st,
                                   int* zp, int* ta, int* tb, void* stream) {
  if (S == 0) return 0;
  const int spb = streams_per_block(S, L);
  const size_t smem = smem_bytes(spb, L, R);
  cudaError_t err = zipper::allow_smem(fused_bucket_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (S + spb - 1) / spb;
  fused_bucket_kernel<<<grid, zipper::kThreads, smem, (cudaStream_t)stream>>>(
      keys, vals, plens, S, L, R, spb, ok, ov, ol, st, zp, ta, tb);
  return (int)cudaGetLastError();
}
