// Device building blocks shared by the SparseZipper kernels
// (chunk_sort.cu and stream_sort.cu take their whole kernels from here;
// merge_partitions.cu, stream_merge.cu and fused_bucket.cu their pieces).
//
// Conventions, identical to the plain-torch oracle (kernels/merge_tree.py):
//   * keys are int32 compared as signed; EMPTY = INT32_MAX pads every row
//     past its valid length and sorts after every valid key;
//   * an empty chunk front has maximum -1;
//   * values are float32 and are only ever moved, except for two kinds of
//     add: a duplicate run inside a chunk is summed left to right starting
//     from the run's first value (acc = v[s]; acc += v[s+1]; ...), and a
//     key present on both sides of a merge becomes the single add va + vb.
//     No tree reduction and no atomics touch a value, so results are bit
//     for bit those of the oracle (and of the JAX reference).
//
// Every function here is called by all threads of a block (blockDim.x a
// multiple of 32) unless its name says warp; loops that issue a ballot run
// a block-uniform trip count so every lane of a warp takes part, and only
// the words that exist (nwords of them) are stored: a small tile's last
// warps ballot past the array's end.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace zipper {

constexpr int kEmpty = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned low_mask(int b) {
  return b >= 32 ? kFull : ((1u << b) - 1u);
}

// First index in sorted a[0, n) whose key is >= key.
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive prefix over the popcounts of bits[0, nwords) into pre[].
// Each thread owns a contiguous run of words; one warp scans the warp
// totals.  Ends with a barrier, so pre[] is visible to the whole block.
__device__ void word_prefix(const unsigned* bits, int* pre, int nwords) {
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (nwords + blockDim.x - 1) / blockDim.x;
  const int w0 = min(tid * per, nwords), w1 = min(w0 + per, nwords);
  int local = 0;
  for (int w = w0; w < w1; ++w) local += __popc(bits[w]);
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? warp_sums[lane] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane < nwarps) warp_sums[lane] = inc - v;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - local;
  for (int w = w0; w < w1; ++w) {
    pre[w] = run;
    run += __popc(bits[w]);
  }
  __syncthreads();
}

// Number of set bits before bit x.
__device__ __forceinline__ int count_before(const unsigned* bits,
                                            const int* pre, int x) {
  return pre[x >> 5] + __popc(bits[x >> 5] & low_mask(x & 31));
}

// Set bits in [x0, x) for x0 <= x with both in one R-aligned chunk.
__device__ __forceinline__ int count_span(const unsigned* bits, int x0,
                                          int x) {
  int n = 0;
  int w = x0 >> 5;
  unsigned lo = ~low_mask(x0 & 31);
  for (; w < (x >> 5); ++w, lo = kFull) n += __popc(bits[w] & lo);
  return n + __popc(bits[w] & lo & low_mask(x & 31));
}

// ---------------------------------------------------------------------------
// Chunk sort (the body of K1 and K4, and K3's first stage).
//
// A chunk of R slots (a power of two) is sorted stably on (key, source
// slot): ties keep their source order, as a stable argsort does.  Each
// duplicate run is summed left to right from its first value, and the run
// totals are compressed to the chunk's front, EMPTY / 0 past its unique
// count.  zero_start: sum each run from zero (0 + v0 + v1 ...), the order
// of the host tier's oracle (ref.stream_sort_ref); it differs from the
// default only in turning a lone -0.0 into +0.0.  VOut: float, or
// __nv_bfloat16 (the float32 total rounded once).
//
// Two routes.  A chunk that fits one warp (R <= 32 ITEMS) takes
// sort_chunks_warp, in registers; a wider one (K4's single front of up
// to 8,192 in sort_tokens_by_key) takes sort_tile, in shared memory.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float load_val(const float* p) { return *p; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The block route.  in_k/in_v hold E = n_chunks * R elements, chunk-major,
// already masked (EMPTY / 0 past each chunk's length).  Each element
// finds its rank by comparing (key, slot) pairs against its chunk's R
// keys; the element that ends a run sums the run; the run totals are
// compressed by a ballot/popc prefix count.  out_k/out_v may alias
// in_k/in_v and may lie in global memory; out_len[c] gets chunk c's
// unique count.  tmp_k/tmp_v: E elements of scratch; bits: E/32 + 1 words.
template <typename VOut>
__device__ void sort_tile(int E, int R, const int* in_k, const float* in_v,
                          int* tmp_k, float* tmp_v, unsigned* bits,
                          int* out_k, VOut* out_v, int* out_len,
                          bool zero_start = false) {
  const int tid = threadIdx.x;
  // stable rank sort inside each chunk
  for (int e = tid; e < E; e += blockDim.x) {
    const int c0 = e & ~(R - 1), i = e - c0;
    const int k = in_k[e];
    int rank = 0;
    for (int j = 0; j < R; ++j) {
      const int kj = in_k[c0 + j];
      rank += (kj < k) || (kj == k && j < i);
    }
    tmp_k[c0 + rank] = k;
    tmp_v[c0 + rank] = in_v[e];
  }
  __syncthreads();
  // run ends: sum the run sequentially from its first value, in place at
  // the run's last slot (no other thread reads this run)
  const int nwords = (E >> 5) + 1;
  for (int base = 0; base < nwords * 32; base += blockDim.x) {
    const int e = base + tid;
    bool last = false;
    if (e < E) {
      const int c0 = e & ~(R - 1), i = e - c0;
      const int k = tmp_k[e];
      const int nxt = i + 1 < R ? tmp_k[e + 1] : kEmpty;
      last = k != nxt && k != kEmpty;
      if (last) {
        int s = i;
        while (s > 0 && tmp_k[c0 + s - 1] == k) --s;
        float acc = zero_start ? 0.0f + tmp_v[c0 + s] : tmp_v[c0 + s];
        for (int t = s + 1; t <= i; ++t) acc += tmp_v[c0 + t];
        tmp_v[e] = acc;
      }
    }
    const unsigned b = __ballot_sync(kFull, last);
    if ((tid & 31) == 0 && (e >> 5) < nwords) bits[e >> 5] = b;
  }
  __syncthreads();
  // compress the run totals to the chunk front by selection
  for (int e = tid; e < E; e += blockDim.x) {
    const int c0 = e & ~(R - 1), i = e - c0;
    const int n = count_span(bits, c0, c0 + R);
    if ((bits[e >> 5] >> (e & 31)) & 1u) {
      const int pos = count_span(bits, c0, e);
      out_k[c0 + pos] = tmp_k[e];
      store_val(out_v + c0 + pos, tmp_v[e]);
    }
    if (i >= n) {
      out_k[e] = kEmpty;
      store_val(out_v + e, 0.0f);
    }
    if (i == 0) out_len[c0 / R] = n;
  }
}

// The warp route.  A warp holds 32 * ITEMS consecutive slots, lane l the
// ITEMS slots from l * ITEMS, so a chunk lies in lpc = R / ITEMS
// neighbouring lanes (ITEMS <= R <= 32 * ITEMS, both powers of two), and
// k/v arrive masked (EMPTY / 0 past the chunk's length).  Each element
// ranks itself against the chunk's keys taken by shuffles and is placed
// by rank in the warp's own scratch wk/wv (32 * ITEMS slots); the sorted
// slots come back into registers, each run is summed lane to lane in
// order (lane j carries lane j - 1's trailing run on), and each run's
// end is one bit of a mask whose popcounts, prefixed over the chunk's
// lanes by shuffles, give the output slots.  Only __syncwarp orders the
// scratch: no block barrier.  ok/ov/ol: the warp's 32 * ITEMS output
// slots and its chunks' unique counts (in global or shared memory, and
// ok/ov may be wk/wv); a lane whose chunk is not live stores nothing but
// still takes part in the shuffles.
template <int ITEMS, typename VOut>
__device__ __forceinline__ void sort_chunks_warp(
    int R, bool zero_start, int (&k)[ITEMS], float (&v)[ITEMS], int* wk,
    float* wv, int* ok, VOut* ov, int* ol, bool live) {
  const int lane = threadIdx.x & 31, x0 = lane * ITEMS;
  const int lpc = R / ITEMS, first = lane & ~(lpc - 1), j0 = lane - first;
  const int off = j0 * ITEMS, c0 = x0 - off;
  int rk[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) rk[i] = 0;
  for (int src = 0; src < lpc; ++src) {
#pragma unroll
    for (int e = 0; e < ITEMS; ++e) {
      const int kj = __shfl_sync(kFull, k[e], first + src);
      const int j = src * ITEMS + e;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        rk[i] += (kj < k[i]) || (kj == k[i] && j < off + i);
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    wk[c0 + rk[i]] = k[i];
    wv[c0 + rk[i]] = v[i];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    k[i] = wk[x0 + i];
    v[i] = wv[x0 + i];
  }
  int nk = __shfl_down_sync(kFull, k[0], 1);
  if (j0 == lpc - 1) nk = kEmpty;
  unsigned last = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int nx = i + 1 < ITEMS ? k[i + 1] : nk;
    if (k[i] != nx && k[i] != kEmpty) last |= 1u << i;
  }
  // running sums, lane by lane: lane j starts from lane j - 1's trailing
  // run where its first key continues it
  float carry = 0.0f;
  int ckey = kEmpty;
  for (int j = 0; j < lpc; ++j) {
    if (j0 == j) {
      float acc = (j > 0 && k[0] == ckey) ? carry + v[0]
                  : zero_start            ? 0.0f + v[0]
                                          : v[0];
      v[0] = acc;
#pragma unroll
      for (int i = 1; i < ITEMS; ++i) {
        acc = k[i] == k[i - 1] ? acc + v[i]
              : zero_start     ? 0.0f + v[i]
                               : v[i];
        v[i] = acc;
      }
    }
    const float c = __shfl_up_sync(kFull, v[ITEMS - 1], 1);
    const int ck = __shfl_up_sync(kFull, k[ITEMS - 1], 1);
    if (j0 == j + 1) {
      carry = c;
      ckey = ck;
    }
  }
  const int cnt = __popc(last);
  int incl = cnt;
  for (int o = 1; o < lpc; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (j0 >= o) incl += y;
  }
  const int before = incl - cnt;
  const int n = __shfl_sync(kFull, incl, first + lpc - 1);
  __syncwarp();  // every lane has its slots before ok (maybe wk) is written
  if (!live) return;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if ((last >> i) & 1u) {
      const int pos = before + __popc(last & ((1u << i) - 1u));
      ok[c0 + pos] = k[i];
      store_val(ov + c0 + pos, v[i]);
    }
    if (off + i >= n) {
      ok[x0 + i] = kEmpty;
      store_val(ov + x0 + i, 0.0f);
    }
  }
  if (j0 == 0) ol[c0 / R] = n;
}

// ---------------------------------------------------------------------------
// Partition merge payload (kernel K2's body).
//
// A tile of P pairs; pair p merges A (width Wa, length la) with B (width
// Wb, length lb), both ascending and duplicate-free, into Wa + Wb output
// slots: the union, a key on both sides as the single add va + vb in the
// A slot, EMPTY / 0 past the merged length.  Each element takes its rank
// from a binary search in the other side (the rank formulas of the
// oracle's union merge); the count of cross-side duplicates before it
// comes from a block prefix over ballot words.
// ---------------------------------------------------------------------------
struct PairTile {
  const int* ka; const float* va; long long a_stride;
  const int* kb; const float* vb; long long b_stride;
  const int* la; const int* lb; int len_stride;
  int* ok; float* ov; long long o_stride;
  int* ol;
  int Wa, Wb, P;
};

// bits, pre: (P * (Wa + Wb)) / 32 + 1 words each.
__device__ void merge_tile(const PairTile& t, unsigned* bits, int* pre) {
  const int tid = threadIdx.x;
  const int W = t.Wa + t.Wb;
  const int E = t.P * W;
  const int nwords = (E >> 5) + 1;
  // 1. cross-side duplicate flags, one ballot word per 32 elements
  for (int base = 0; base < nwords * 32; base += blockDim.x) {
    const int x = base + tid;
    bool match = false;
    if (x < E) {
      const int p = x / W, off = x - p * W;
      const int la = t.la[p * t.len_stride], lb = t.lb[p * t.len_stride];
      if (off < t.Wa) {
        if (off < la) {
          const int* kb = t.kb + p * t.b_stride;
          const int k = t.ka[p * t.a_stride + off];
          const int r = lower_bound(kb, lb, k);
          match = r < lb && kb[r] == k;
        }
      } else if (off - t.Wa < lb) {
        const int* ka = t.ka + p * t.a_stride;
        const int k = t.kb[p * t.b_stride + off - t.Wa];
        const int r = lower_bound(ka, la, k);
        match = r < la && ka[r] == k;
      }
    }
    const unsigned b = __ballot_sync(kFull, match);
    if ((tid & 31) == 0 && (x >> 5) < nwords) bits[x >> 5] = b;
  }
  __syncthreads();
  word_prefix(bits, pre, nwords);
  // 2. output slots: each element moves to its rank among the merged
  //    uniques; each slot past the merged length is filled
  for (int x = tid; x < E; x += blockDim.x) {
    const int p = x / W, off = x - p * W;
    const int la = t.la[p * t.len_stride], lb = t.lb[p * t.len_stride];
    const int a0 = p * W, b0 = a0 + t.Wa;
    const int a_dups = count_before(bits, pre, b0) - count_before(bits, pre, a0);
    const int n_out = la + lb - a_dups;
    int* ok = t.ok + p * t.o_stride;
    float* ov = t.ov + p * t.o_stride;
    const bool match = (bits[x >> 5] >> (x & 31)) & 1u;
    if (off < t.Wa) {
      if (off < la) {
        const int* kb = t.kb + p * t.b_stride;
        const int k = t.ka[p * t.a_stride + off];
        const int r = lower_bound(kb, lb, k);
        const int excl = count_before(bits, pre, x) - count_before(bits, pre, a0);
        const float v = t.va[p * t.a_stride + off];
        const int pos = off + r - excl;
        ok[pos] = k;
        ov[pos] = match ? v + t.vb[p * t.b_stride + r] : v;
      }
    } else if (off - t.Wa < lb && !match) {
      const int j = off - t.Wa;
      const int* ka = t.ka + p * t.a_stride;
      const int k = t.kb[p * t.b_stride + j];
      const int r = lower_bound(ka, la, k);
      const int excl = count_before(bits, pre, x) - count_before(bits, pre, b0);
      const int pos = j + r - excl;
      ok[pos] = k;
      ov[pos] = t.vb[p * t.b_stride + j];
    }
    if (off >= n_out) {
      ok[off] = kEmpty;
      ov[off] = 0.0f;
    }
    if (off == 0) t.ol[p] = n_out;
  }
}

// ---------------------------------------------------------------------------
// Chunk-advancement state machine for one stream, run by one warp.
//
// Each step loads the two R-wide fronts, takes the merge-bit cutoff
// min(max_a, max_b) (an empty front's max is -1) and advances each side
// by its count of keys <= cutoff, while both sides are live.  The trip
// count depends on the data; the loop condition is warp-uniform, and a
// warp serves exactly one stream per call.
// ---------------------------------------------------------------------------
struct Advance {
  int steps, zips, tail_a, tail_b;
};

__device__ Advance advance_warp(const int* ka, int la, const int* kb, int lb,
                                int R) {
  const int lane = threadIdx.x & 31;
  int pa = 0, pb = 0, steps = 0, zips = 0;
  while (pa < la && pb < lb) {
    const int na = min(la - pa, R), nb = min(lb - pb, R);
    int mxa = -1, mxb = -1;
    for (int r = lane; r < na; r += 32) {
      const int k = ka[pa + r];
      if (k != kEmpty) mxa = max(mxa, k);
    }
    for (int r = lane; r < nb; r += 32) {
      const int k = kb[pb + r];
      if (k != kEmpty) mxb = max(mxb, k);
    }
    const int cutoff = min(__reduce_max_sync(kFull, mxa),
                           __reduce_max_sync(kFull, mxb));
    int ca = 0, cb = 0;
    for (int r = lane; r < na; r += 32) {
      const int k = ka[pa + r];
      ca += k != kEmpty && k <= cutoff;
    }
    for (int r = lane; r < nb; r += 32) {
      const int k = kb[pb + r];
      cb += k != kEmpty && k <= cutoff;
    }
    ca = __reduce_add_sync(kFull, ca);
    cb = __reduce_add_sync(kFull, cb);
    steps += 1;
    zips += na + nb;
    pa += ca;
    pb += cb;
  }
  Advance a;
  a.steps = steps;
  a.zips = zips;
  a.tail_a = (max(la - pa, 0) + R - 1) / R;
  a.tail_b = (max(lb - pb, 0) + R - 1) / R;
  return a;
}

// Raise the dynamic shared-memory cap of `kernel` when a launch needs
// more than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// K1 and K4: the chunk sort of N chunks of R slots, from global memory to
// global memory (keys/vals/ok/ov (N, R), lens/ol (N,)).
//
// Bound: bytes, each element read once (key + value) and each output
// written once, plus the lengths: ~8,192 slots (K4's host-driver front)
// are 0.04 us at 3.35 TB/s, far below one launch, so a launch is a chain
// of latencies: a load, the rank's shuffles, the run carry, the stores.
// The warp route keeps that chain short and spreads it over the card:
// each warp loads its 32 * ITEMS slots straight into registers (a lane
// masks its own slots with one length load, no divide), sorts its chunks
// in registers (sort_chunks_warp) behind __syncwarp only, and stores
// keys, values and lengths straight to global memory.  The wrapper picks
// ITEMS and the warps a block (kernels/chunk_sort.py::sort_config):
//   ITEMS = min(R, max(ceil(R / 32), min(4, P))), P the largest power
//           of two <= E / 65,536 for E = N * R slots,
//   warps a block = min(4, max(1, warps / 256)),
// so K4's front (S = 512, R = 16) is 256 one-warp blocks of ITEMS = 1,
// and K1 at N = 8,192 chunks 512 blocks of four warps, ITEMS = 2.  A
// lane's rank costs R shuffles and ITEMS * R compares, its carry R /
// ITEMS steps: on the card the fastest ITEMS was 1 at 8,192 slots, 2 at
// 131,072 and 4 at 1,048,576, and 8 the slowest at each
// (tools/sort_probe.py's sweep), so only R = 256 takes 8.  A chunk
// wider than 256 slots takes the block route (sort_tile, tiles of up to
// 2,048 slots staged in shared memory).
// ---------------------------------------------------------------------------
constexpr int kSortMaxWarps = 4;
constexpr int kSortTileElems = 2048;

template <int ITEMS, typename V>
__global__ void __launch_bounds__(32 * kSortMaxWarps)
sort_warp_kernel(const int* __restrict__ keys, const V* __restrict__ vals,
                 const int* __restrict__ lens, long long E, int lgR,
                 bool zero_start, int* __restrict__ ok, V* __restrict__ ov,
                 int* __restrict__ ol) {
  __shared__ int wk[kSortMaxWarps][32 * ITEMS];
  __shared__ float wv[kSortMaxWarps][32 * ITEMS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * (32 * ITEMS);
  if (w0 >= E) return;  // the whole warp
  const int R = 1 << lgR;
  const long long x = w0 + lane * ITEMS;
  const bool live = x < E;
  const int len = live ? lens[x >> lgR] : 0;
  const int off = (lane * ITEMS) & (R - 1);
  int k[ITEMS];
  float v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool valid = off + i < len;
    k[i] = valid ? keys[x + i] : kEmpty;
    v[i] = valid ? load_val(vals + x + i) : 0.0f;
  }
  sort_chunks_warp<ITEMS>(R, zero_start, k, v, wk[warp], wv[warp], ok + w0,
                          ov + w0, ol + (w0 >> lgR), live);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
sort_block_kernel(const int* __restrict__ keys, const V* __restrict__ vals,
                  const int* __restrict__ lens, int N, int R, int cpb,
                  bool zero_start, int* __restrict__ ok, V* __restrict__ ov,
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
    in_k[e] = valid ? keys[g0 + e] : kEmpty;
    in_v[e] = valid ? load_val(vals + g0 + e) : 0.0f;
  }
  __syncthreads();
  sort_tile(E, R, in_k, in_v, tmp_k, tmp_v, bits, ok + g0, ov + g0, ol + n0,
            zero_start);
}

template <int ITEMS, typename V>
int launch_sort_warp(const int* keys, const V* vals, const int* lens,
                     long long E, int lgR, int warps, bool zero_start,
                     int* ok, V* ov, int* ol, cudaStream_t s) {
  const long long nwarps = (E + 32 * ITEMS - 1) / (32 * ITEMS);
  const long long grid = (nwarps + warps - 1) / warps;
  sort_warp_kernel<ITEMS, V><<<(unsigned)grid, 32 * warps, 0, s>>>(
      keys, vals, lens, E, lgR, zero_start, ok, ov, ol);
  return (int)cudaGetLastError();
}

// items, warps: the warp route's shape (sort_config); items = 0: the
// block route.  R a power of two.
template <typename V>
int launch_sort(const int* keys, const V* vals, const int* lens, int N, int R,
                int items, int warps, bool zero_start, int* ok, V* ov,
                int* ol, void* stream) {
  if (N == 0) return 0;
  if (R <= 0 || (R & (R - 1))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (items == 0) {
    const int cpb = std::max(1, kSortTileElems / R);
    const size_t cap = (size_t)cpb * R;
    const size_t smem = cap * 16 + ((cap >> 5) + 1) * 4;
    cudaError_t err = allow_smem(sort_block_kernel<V>, smem);
    if (err != cudaSuccess) return (int)err;
    sort_block_kernel<V><<<(N + cpb - 1) / cpb, kThreads, smem, s>>>(
        keys, vals, lens, N, R, cpb, zero_start, ok, ov, ol);
    return (int)cudaGetLastError();
  }
  if ((items & (items - 1)) || items > 8 || items > R || R > 32 * items ||
      warps < 1 || warps > kSortMaxWarps)
    return (int)cudaErrorInvalidValue;
  const long long E = (long long)N * R;
  const int lgR = __builtin_ctz(R);
  switch (items) {
    case 1: return launch_sort_warp<1>(keys, vals, lens, E, lgR, warps,
                                       zero_start, ok, ov, ol, s);
    case 2: return launch_sort_warp<2>(keys, vals, lens, E, lgR, warps,
                                       zero_start, ok, ov, ol, s);
    case 4: return launch_sort_warp<4>(keys, vals, lens, E, lgR, warps,
                                       zero_start, ok, ov, ol, s);
    default: return launch_sort_warp<8>(keys, vals, lens, E, lgR, warps,
                                        zero_start, ok, ov, ol, s);
  }
}

}  // namespace zipper

extern "C" const char* zipper_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
