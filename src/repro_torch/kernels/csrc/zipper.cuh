// Device building blocks shared by the SparseZipper kernels
// (chunk_sort.cu, merge_partitions.cu; fused_bucket.cu takes the
// conventions, count_span and allow_smem).
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
// Chunk sort (kernel K1's body).
//
// in_k/in_v hold E = n_chunks * R elements, chunk-major, already masked
// (EMPTY / 0 past each chunk's length).  Each element finds its rank in
// its chunk by comparing (key, lane) pairs, a stable order: ties keep
// their source lane order, as a stable argsort does.  The element that
// ends a run of equal keys sums the run left to right from its first
// value; the run totals are compressed to the chunk front by a
// ballot/popc prefix count.  out_k/out_v may alias in_k/in_v and may lie
// in global memory; out_len[c] gets chunk c's unique count.
// tmp_k/tmp_v: E elements of scratch; bits: E/32 + 1 words.
// zero_start: sum each run from zero (0 + v0 + v1 ...), the order of the
// host-tier oracle's segment sum; it differs from the default only in
// turning a lone -0.0 into +0.0.  VOut: float, or __nv_bfloat16 (the
// float32 total rounded once).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float load_val(const float* p) { return *p; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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

}  // namespace zipper

extern "C" const char* zipper_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
