// K3: fused bucket (expansion, chunk sort and the whole zip-merge tree) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/fused_bucket.py::
// fused_bucket_pallas and, on its expansion entry, the jitted program
// repro/core/spgemm.py::_fused_bucket_impl around it: sort all S * C
// R-chunks of an (S, L = C * R) work bucket, then fold the C sorted
// partitions of every stream through log2(C) merge rounds, with the
// per-(round, pair) SparseZipper counters (steps, zip elements, tail
// chunks of each side) reduced into a lock-step group's accumulators.
// Bit for bit the plain composition (kernels/fused_bucket.py).
//
// Two load stages feed one kernel body:
//   expand   row_ids, lane_ids and the six stacked CSR arrays (the
//            arguments of _fused_bucket_impl): a stream reads its A row's
//            entries, takes a prefix of their B row lengths in shared
//            memory (entries with no work dropped), and each product slot
//            finds its entry by a search in that table and gathers B's
//            column and value.  The product is __fmul_rn(a, b): nvcc may
//            not contract it into a later add, so the duplicate-run sums
//            see torch's rounded a_val * b_val.  The (S, L) keys and values
//            never exist in device memory.
//   streams  padded (S, L) keys / values and the valid lengths (the
//            kernel-level contract of fused_bucket_pallas).
//
// Bound: bytes.  Expand: per stream its two ids and A's row pointers, per
// A entry its column, value and B row pointers (16 B), per product the
// gathered B column and value (8 B); out 8 B per output slot and the
// lengths.  Everything between load and store stays in shared memory.
//
// Design, against the four things that bound a kernel of this shape (a
// grid too small for the card, a serial counter loop, repeated work in
// each merge round, round trips through device memory):
//   1. Grid.  A thread owns ITEMS consecutive slots of a stream,
//      ITEMS = min(8, 2R, max(1, L / 256)); a stream has L / ITEMS threads
//      and a block max(1, 32 / (L / ITEMS)) streams (one warp at least).
//      The wrapper (fused_config) picks them; a 512-stream bucket gives
//         L        16   32   64  128  256  512 1024 2048 4096 8192
//         ITEMS     1    1    1    1    1    2    4    8    8    8
//         threads  32   32   64  128  256  256  256  256  512 1024
//         streams   2    1    1    1    1    1    1    1    1    1
//         blocks  256  512  512  512  512  512  512  512  512  512
//      A block holds 12 B of shared memory per slot (keys, values, one
//      candidate word) plus 16 B per (stream, merge pair) of counters and
//      small arrays: 15 KB at L = 1,024, 113 KB at L = 8,192.  Each step
//      of a thread's serial merge is a chain of dependent instructions,
//      so a block's time is latency: few slots a thread, and up to 256
//      threads a stream (four such blocks an SM at 64 registers a
//      thread: 528 blocks in one wave), against the longer scans of a
//      wider block.  L >= 16,384 (or L / ITEMS > 1,024 at R < 4) is the
//      wrapper's large route (K1 + one K2 a round).
//   2. Counters without the serial front loop.  While merging, every
//      element is a candidate cutoff of the advance state machine: the
//      state after a step whose cutoff is key c is (#A <= c, #B <= c), and
//      the merge knows both counts.  Each element stores its rank in the
//      other side and the successor candidate (the smaller of the two
//      fronts' last keys), 16 bits each, in one shared word; the pair's
//      first thread then follows the chain with one shared load a step
//      while the other threads store the round's output.  A pair with a
//      negative key (only reachable through the streams entry) runs the
//      plain front loop instead, whose -1 floor the chain does not model.
//      Each walk leaves its pair's counters in a shared slot; at the end
//      the block takes the max of steps and tails and the sum of zip
//      elements over its streams, and one atomic per block and column
//      lands in the group's accumulators at the column
//      fused_process_group uses (round k, pair q of a group whose widest
//      bucket has Cg chunks: Cg - (Cg >> k) + q), zip elements per round.
//      Integer max and sum are order-free, so SpzStats stay exact.
//   3. Merge rounds by merge path.  A thread's ITEMS diagonals of one
//      pair's output take their split with one binary search (A first on
//      equal keys) and merge sequentially in registers, one element a
//      step without a branch (both heads and A's previous key held); a
//      key on both sides becomes the single add va + vb in the A element,
//      and its B partner, wherever its diagonal falls, sees A's previous
//      key and drops out.  Ranks shift by the pair's earlier drops from
//      one block scan (warp shuffles), and the round writes in place
//      after it.
//   4. No round trips.  The expansion is the load stage and no
//      per-stream counter planes are written: the kernel writes only the
//      merged streams, their lengths and a few atomics.
// The chunk sort ranks each key by (key, lane) within its chunk and sums
// each duplicate run left to right from its first value, as K1 does.
// Where a chunk lies in one warp (ITEMS <= R <= 32 ITEMS) it is K1's and
// K4's own warp chunk sort (zipper.cuh: sort_chunks_warp), in registers:
// keys by shuffles, run sums carried lane to lane in order, run ends
// counted by a shuffle prefix, the warp's slots of shared memory ordered
// by __syncwarp only; any other R reads the chunk from shared memory.
#include "zipper.cuh"

namespace {

using zipper::kEmpty;
using zipper::kFull;

constexpr int kMaxThreads = 1024;
constexpr int kMaxLen = 8192;     // slots of a stream (16-bit candidate words)
constexpr unsigned kEnd = 0xffffu;  // candidate whose chain ends there

struct Params {
  // streams entry
  const int* keys; const float* vals; const int* plens;
  // expand entry
  const long long* row_ids; const long long* lane_ids;
  const int* a_indptr; const int* a_idx; const float* a_val;
  const int* b_indptr; const int* b_idx; const float* b_val;
  int Bn, a_rows1, nnz_cap, b_rows1, bcap;
  // both
  int S, L, R, spb;
  int* ok; float* ov; int* ol;
  unsigned long long* steps; unsigned long long* tails;
  unsigned long long* zips; int Cg;
};

__host__ __device__ inline int n_cols(int C) { return C > 1 ? C - 1 : 1; }

// Dynamic shared memory: keys, values and candidate words (E each), the
// counters of each (stream, column) (16 B), ballot words, two length
// arrays, the scan and warp totals.
__host__ __device__ inline size_t smem_bytes(int L, int R, int spb, int T) {
  const size_t E = (size_t)spb * L, C = (size_t)(L / R);
  return 4 * (3 * E + 4 * spb * n_cols((int)C) + (E / 32 + 1) +
              2 * spb * C + (T + 1) + 32);
}

// Exclusive prefix of v over the block into sc[0, T], sc[T] the total.
// Ends with a barrier.
__device__ int block_scan(int v, int* sc, int* wt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wt[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < nw ? wt[lane] : 0;
    int inc = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane < nw) wt[lane] = inc - t;
  }
  __syncthreads();
  const int excl = wt[warp] + incl - v;
  sc[tid] = excl;
  if (tid == (int)blockDim.x - 1) sc[blockDim.x] = excl + v;
  __syncthreads();
  return excl;
}

// A elements among the first d of the merged order, A first on equal
// keys: the first i with A[i] > B[d - 1 - i]; A at slot a0, B at b0.
__device__ __forceinline__ int merge_path(const int* sk, int a0, int na,
                                          int b0, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[a0 + mid] <= sk[b0 + d - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// load stages: each thread's ITEMS products into registers
// ---------------------------------------------------------------------------
template <int ITEMS>
__device__ void load_streams(const Params& p, int (&k)[ITEMS],
                             float (&v)[ITEMS]) {
  const int x0 = threadIdx.x * ITEMS, sl = x0 / p.L, q0 = x0 - sl * p.L;
  const long long g = (long long)blockIdx.x * p.spb + sl;
  const int plen = g < p.S ? p.plens[g] : 0;
  const long long row = g * p.L;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool valid = q0 + i < plen;
    k[i] = valid ? p.keys[row + q0 + i] : kEmpty;
    v[i] = valid ? p.vals[row + q0 + i] : 0.0f;
  }
}

// The expansion of _fused_expand: stream s takes output row row_ids[s] of
// batch lane lane_ids[s] (row_ids < 0: a padding stream, no products).
// The table (first product, B row start, A value) of the row's entries
// with work lives in the block's key, value and candidate arrays, which
// the caller overwrites after the closing barrier.
template <int ITEMS>
__device__ void load_expand(const Params& p, int* sk, float* sv,
                            unsigned* aux, int* sc, int* wt, int (&k)[ITEMS],
                            float (&v)[ITEMS]) {
  const int L = p.L, tps = L / ITEMS;
  const int sl = threadIdx.x / tps, r = threadIdx.x - sl * tps;
  const long long g = (long long)blockIdx.x * p.spb + sl;
  int lane = 0, t0 = 0, t1 = 0;
  if (g < p.S && p.row_ids[g] >= 0) {
    lane = (int)min(max(p.lane_ids[g], 0LL), (long long)p.Bn - 1);
    const int row = (int)min(p.row_ids[g], (long long)p.a_rows1 - 2);
    const int* ip = p.a_indptr + (long long)lane * p.a_rows1 + row;
    t0 = ip[0];
    t1 = ip[1];
  }
  const int* aidx = p.a_idx + (long long)lane * p.nnz_cap;
  const float* aval = p.a_val + (long long)lane * p.nnz_cap;
  const int* bptr = p.b_indptr + (long long)lane * p.b_rows1;
  // each thread takes a run of the row's entries
  const int ne = t1 - t0, per = (ne + tps - 1) / tps;
  const int e0 = t0 + min(r * per, ne), e1 = t0 + min(r * per + per, ne);
  int cnt = 0, work = 0;
  for (int e = e0; e < e1; ++e) {
    const int j = aidx[e], w = bptr[j + 1] - bptr[j];
    cnt += w > 0;
    work += w;
  }
  const int tf = sl * tps;
  int ci = block_scan(cnt, sc, wt);
  const int cbase = sc[tf], n = min(sc[tf + tps] - cbase, L);
  ci -= cbase;
  int wi = block_scan(work, sc, wt);
  const int wbase = sc[tf], lim = min(sc[tf + tps] - wbase, L);
  wi -= wbase;
  int* cum = sk + sl * L;
  int* bst = reinterpret_cast<int*>(sv) + sl * L;
  float* av = reinterpret_cast<float*>(aux) + sl * L;
  for (int e = e0; e < e1 && ci < L; ++e) {
    const int j = aidx[e], b0 = bptr[j], w = bptr[j + 1] - b0;
    if (w > 0) {
      cum[ci] = wi;
      bst[ci] = b0;
      av[ci] = aval[e];
      ++ci;
      wi += w;
    }
  }
  __syncthreads();
  const int* bidx = p.b_idx + (long long)lane * p.bcap;
  const float* bval = p.b_val + (long long)lane * p.bcap;
  const int q0 = r * ITEMS;
  // the last entry whose first product is <= q0, then forward
  int lo = 0, hi = q0 < lim ? n : 0;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= q0) lo = mid + 1; else hi = mid;
  }
  int e = lo - 1;
  // positions first, so the gathers below issue back to back
  int pos[ITEMS];
  float a[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int q = q0 + i;
    pos[i] = -1;
    if (q < lim) {
      while (e + 1 < n && cum[e + 1] <= q) ++e;
      pos[i] = bst[e] + (q - cum[e]);
      a[i] = av[e];
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    k[i] = pos[i] >= 0 ? bidx[pos[i]] : kEmpty;
    v[i] = pos[i] >= 0 ? __fmul_rn(a[i], bval[pos[i]]) : 0.0f;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// chunk sort: stable (key, lane) rank in each R-chunk, duplicate runs
// summed left to right from their first value, run totals compressed to
// the chunk's front; lens[c] gets block chunk c's unique count.  A chunk
// in one warp takes zipper::sort_chunks_warp (in fused_bucket_kernel).
// ---------------------------------------------------------------------------

// Any other R: ranks and runs read from shared memory, run ends as
// ballot words.
template <int ITEMS>
__device__ void sort_chunks_smem(int R, int* sk, float* sv, unsigned* bits,
                                 int* lens, int (&k)[ITEMS],
                                 float (&v)[ITEMS]) {
  const int tid = threadIdx.x, x0 = tid * ITEMS, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    sk[x0 + i] = k[i];
    sv[x0 + i] = v[i];
  }
  __syncthreads();
  int rk[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int x = x0 + i, c0 = x & ~(R - 1), pi = x - c0;
    rk[i] = 0;
    for (int j = 0; j < R; ++j) {
      const int kj = sk[c0 + j];
      rk[i] += (kj < k[i]) || (kj == k[i] && j < pi);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c0 = (x0 + i) & ~(R - 1);
    sk[c0 + rk[i]] = k[i];
    sv[c0 + rk[i]] = v[i];
  }
  __syncthreads();
  unsigned last = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int x = x0 + i, c0 = x & ~(R - 1), pi = x - c0;
    const int kk = sk[x];
    const int nx = pi + 1 < R ? sk[x + 1] : kEmpty;
    k[i] = kk;
    if (kk != nx && kk != kEmpty) {
      int s = pi;
      while (s > 0 && sk[c0 + s - 1] == kk) --s;
      float acc = sv[c0 + s];
      for (int t = s + 1; t <= pi; ++t) acc += sv[c0 + t];
      v[i] = acc;
      last |= 1u << i;
    }
  }
  // one ballot word per 32 slots: OR the masks of the lanes that share it
  unsigned m = last << (x0 & 31);
#pragma unroll
  for (int o = 1; o < 32 / ITEMS; o <<= 1) m |= __shfl_xor_sync(kFull, m, o);
  if ((lane & (32 / ITEMS - 1)) == 0) bits[x0 >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int x = x0 + i, c0 = x & ~(R - 1), pi = x - c0;
    const int n = zipper::count_span(bits, c0, c0 + R);
    if ((last >> i) & 1u) {
      const int pos = zipper::count_span(bits, c0, x);
      sk[c0 + pos] = k[i];
      sv[c0 + pos] = v[i];
    }
    if (pi >= n) {
      sk[x] = kEmpty;
      sv[x] = 0.0f;
    }
    if (pi == 0) lens[c0 / R] = n;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// counters of one pair
// ---------------------------------------------------------------------------
struct Walk {
  int steps, zips, pa, pb;
};

// The plain front loop (repro's advance_tile): max of each front's valid
// keys from -1, cutoff the smaller, each side advanced by its keys <= it.
// A at slot a0, B at b0.
__device__ Walk walk_fronts(const int* sk, int a0, int la, int b0, int lb,
                            int R) {
  Walk w = {0, 0, 0, 0};
  while (w.pa < la && w.pb < lb) {
    const int na = min(la - w.pa, R), nb = min(lb - w.pb, R);
    int mxa = -1, mxb = -1;
    for (int r = 0; r < na; ++r) {
      const int kk = sk[a0 + w.pa + r];
      if (kk != kEmpty) mxa = max(mxa, kk);
    }
    for (int r = 0; r < nb; ++r) {
      const int kk = sk[b0 + w.pb + r];
      if (kk != kEmpty) mxb = max(mxb, kk);
    }
    const int cut = min(mxa, mxb);
    int ca = 0, cb = 0;
    for (int r = 0; r < na; ++r) {
      const int kk = sk[a0 + w.pa + r];
      ca += kk != kEmpty && kk <= cut;
    }
    for (int r = 0; r < nb; ++r) {
      const int kk = sk[b0 + w.pb + r];
      cb += kk != kEmpty && kk <= cut;
    }
    ++w.steps;
    w.zips += na + nb;
    w.pa += ca;
    w.pb += cb;
  }
  return w;
}

// The same loop on non-negative keys, along the successor chain the
// merge stored: the pair's candidate word at slot base + x is
// successor | rank << 16, for A's x < W and B's W + j.  first: the start
// state's successor.
__device__ Walk walk_chain(const unsigned* aux, int base, unsigned first,
                           int la, int lb, int W, int R) {
  Walk w = {1, min(la, R) + min(lb, R), 0, 0};
  unsigned x = first;
  for (;;) {
    const unsigned c = aux[base + (int)x];
    const int rank = (int)(c >> 16);
    if ((int)x < W) {
      w.pa = x + 1;
      w.pb = rank;
    } else {
      w.pa = rank;
      w.pb = x - W + 1;
    }
    const unsigned nx = c & kEnd;
    if (nx == kEnd) break;
    w.zips += min(la - w.pa, R) + min(lb - w.pb, R);
    ++w.steps;
    x = nx;
  }
  return w;
}

// ---------------------------------------------------------------------------
// the merge tree, in place in (sk, sv); lens/lens_n swap each round
// ---------------------------------------------------------------------------
template <int ITEMS>
__device__ void merge_rounds(int L, int R, int C, int* sk, float* sv,
                             unsigned* aux, int*& lens, int*& lens_n,
                             int* sc, int* wt, int4* pc, int ncol,
                             int (&k)[ITEMS], float (&v)[ITEMS]) {
  const int tid = threadIdx.x, x0 = tid * ITEMS, sl = x0 / L;
  const int sx0 = x0 - sl * L;
  int W = R, cc = C, lw2 = __ffs(R);  // log2 of a pair's width
  for (int round = 0; cc > 1; ++round, ++lw2) {
    const int half = cc >> 1, W2 = 2 * W;
    const int q = sx0 >> lw2, d0 = sx0 & (W2 - 1), base = sl * L + q * W2;
    const int b0 = base + W;  // B's first slot
    const int la = lens[sl * cc + 2 * q], lb = lens[sl * cc + 2 * q + 1];
    const int tot = la + lb, dstart = min(d0, tot);
    int ia = merge_path(sk, base, la, b0, lb, dstart);
    int ib = dstart - ia;
    // the two heads and A's key before its head, in registers: each step
    // takes one element without a branch and reloads both heads
    int ka = ia < la ? sk[base + ia] : 0;
    int kb = ib < lb ? sk[b0 + ib] : 0;
    int prev = ia > 0 ? sk[base + ia - 1] : 0;
    unsigned drop = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (d0 + i < tot) {
        const bool ta = ib >= lb || (ia < la && ka <= kb);
        const bool m = ta && ib < lb && kb == ka;
        float vv = sv[ta ? base + ia : b0 + ib];
        if (m) vv = vv + sv[b0 + ib];
        if (!ta && ia > 0 && prev == kb) drop |= 1u << i;
        k[i] = ta ? ka : kb;
        v[i] = vv;
        // candidate: this element's key as a cutoff gives the state
        // (pa, pb); its rank is its count in the other side
        const int rank = ta ? ib + m : ia;
        const int slot = ta ? ia : W + ib;
        const int pa = ta ? ia + 1 : ia, pb = ta ? ib + m : ib + 1;
        if (ta) prev = ka;
        ia += ta;
        ib += !ta;
        ka = ia < la ? sk[base + ia] : 0;
        kb = ib < lb ? sk[b0 + ib] : 0;
        unsigned nxt = kEnd;
        if (pa < la && pb < lb) {
          const int na = min(la - pa, R), nb = min(lb - pb, R);
          nxt = sk[base + pa + na - 1] <= sk[b0 + pb + nb - 1]
                    ? pa + na - 1 : W + pb + nb - 1;
        }
        aux[base + slot] = nxt | ((unsigned)rank << 16);
      }
    }
    // the pair's first thread owns its counters; what reads the data runs
    // before the scan's barriers, the chain (candidates only) after them
    const bool walker = d0 == 0, live = la > 0 && lb > 0;
    Walk w = {0, 0, 0, 0};
    unsigned first = kEnd;
    if (walker && live) {
      if (sk[base] < 0 || sk[b0] < 0) {
        w = walk_fronts(sk, base, la, b0, lb, R);
      } else {
        const int na = min(la, R), nb = min(lb, R);
        first = sk[base + na - 1] <= sk[b0 + nb - 1] ? na - 1
                                                             : W + nb - 1;
      }
    }
    const int excl = block_scan(__popc(drop), sc, wt);
    const int tf = tid - d0 / ITEMS;
    const int before = excl - sc[tf];
    const int n_out = tot - (sc[tf + W2 / ITEMS] - sc[tf]);
    if (walker) {
      if (first != kEnd) w = walk_chain(aux, base, first, la, lb, W, R);
      pc[sl * ncol + C - (C >> round) + q] = make_int4(
          w.steps, w.zips, (max(la - w.pa, 0) + R - 1) / R,
          (max(lb - w.pb, 0) + R - 1) / R);
      lens_n[sl * half + q] = n_out;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int d = d0 + i;
      if (d < tot && !((drop >> i) & 1u)) {
        const int pos = d - before - __popc(drop & ((1u << i) - 1u));
        sk[base + pos] = k[i];
        sv[base + pos] = v[i];
      }
      if (d >= n_out) {
        sk[base + d] = kEmpty;
        sv[base + d] = 0.0f;
      }
    }
    __syncthreads();
    int* t = lens;
    lens = lens_n;
    lens_n = t;
    W = W2;
    cc = half;
  }
}

template <int ITEMS, bool EXPAND>
__global__ void __launch_bounds__(kMaxThreads)
fused_bucket_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.L, R = p.R, C = L / R, spb = p.spb;
  const int T = blockDim.x, E = spb * L, ncol = n_cols(C), tid = threadIdx.x;
  int* sk = reinterpret_cast<int*>(smem);
  float* sv = reinterpret_cast<float*>(sk + E);
  unsigned* aux = reinterpret_cast<unsigned*>(sv + E);
  int4* pc = reinterpret_cast<int4*>(aux + E);  // E % 32 == 0: aligned
  unsigned* bits = reinterpret_cast<unsigned*>(pc + spb * ncol);
  int* lens = reinterpret_cast<int*>(bits + E / 32 + 1);
  int* lens_n = lens + spb * C;
  int* sc = lens_n + spb * C;
  int* wt = sc + T + 1;
  if (tid == 0) bits[E / 32] = 0;

  int k[ITEMS];
  float v[ITEMS];
  if (EXPAND) load_expand<ITEMS>(p, sk, sv, aux, sc, wt, k, v);
  else load_streams<ITEMS>(p, k, v);
  if (ITEMS <= R && R <= 32 * ITEMS) {
    // zipper.cuh's warp chunk sort (K1's and K4's), in place in the
    // warp's own slots of sk/sv
    const int w0 = (tid & ~31) * ITEMS;
    zipper::sort_chunks_warp<ITEMS>(R, false, k, v, sk + w0, sv + w0,
                                    sk + w0, sv + w0, lens + w0 / R, true);
    __syncthreads();
  } else {
    sort_chunks_smem<ITEMS>(R, sk, sv, bits, lens, k, v);
  }
  merge_rounds<ITEMS>(L, R, C, sk, sv, aux, lens, lens_n, sc, wt, pc, ncol,
                      k, v);

  const long long s0 = (long long)blockIdx.x * spb;
  const int lgL = __ffs(L) - 1;
  for (int x = tid; x < E; x += T) {
    const int sl = x >> lgL;
    if (s0 + sl < p.S) {
      const long long gi = (s0 + sl) * L + (x & (L - 1));
      p.ok[gi] = sk[x];
      p.ov[gi] = sv[x];
    }
  }
  for (int s = tid; s < spb; s += T)
    if (s0 + s < p.S) p.ol[s0 + s] = lens[s];
  // bucket column b (round r, pair q) -> group column Cg - (Cg >> r) + q:
  // the block's streams reduced, then one atomic a counter
  for (int b = tid; b < C - 1; b += T) {
    int4 c = pc[b];
    for (int s = 1; s < spb; ++s) {
      const int4 o = pc[s * ncol + b];
      c = make_int4(max(c.x, o.x), c.y + o.y, max(c.z, o.z), max(c.w, o.w));
    }
    int r = 0;
    while (b >= C - (C >> (r + 1))) ++r;
    const int gc = p.Cg - (p.Cg >> r) + b - (C - (C >> r));
    if (c.x) atomicMax(p.steps + gc, (unsigned long long)c.x);
    if (c.y) atomicAdd(p.zips + r, (unsigned long long)c.y);
    if (c.z) atomicMax(p.tails + 2 * gc, (unsigned long long)c.z);
    if (c.w) atomicMax(p.tails + 2 * gc + 1, (unsigned long long)c.w);
  }
}

template <int ITEMS, bool EXPAND>
int launch_items(const Params& p, int T, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.L, p.R, p.spb, T);
  cudaError_t err =
      zipper::allow_smem(fused_bucket_kernel<ITEMS, EXPAND>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (p.S + p.spb - 1) / p.spb;
  fused_bucket_kernel<ITEMS, EXPAND><<<grid, T, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool pow2(int x) { return x > 0 && !(x & (x - 1)); }

// items slots a thread, spb streams and T threads a block: the choice of
// kernels/fused_bucket.py::fused_config, checked against what the body
// assumes (whole warps, a thread's slots inside one merge pair, 16-bit
// candidate words).
template <bool EXPAND>
int launch(const Params& p, int items, int T, void* stream) {
  if (p.S == 0) return 0;
  const int C = p.R > 0 ? p.L / p.R : 0;
  if (!pow2(p.R) || !pow2(C) || C * p.R != p.L || p.L > kMaxLen ||
      !pow2(items) || items > 8 || items > 2 * p.R || T % 32 ||
      T > kMaxThreads || (long long)p.spb * p.L != (long long)T * items ||
      p.Cg < C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (items) {
    case 1: return launch_items<1, EXPAND>(p, T, s);
    case 2: return launch_items<2, EXPAND>(p, T, s);
    case 4: return launch_items<4, EXPAND>(p, T, s);
    default: return launch_items<8, EXPAND>(p, T, s);
  }
}

}  // namespace

// Streams entry.  keys/vals/ok/ov: (S, L); plens/ol: (S,); steps: (Cg - 1,)
// (or 1), tails: (Cg - 1, 2), zips: per round; int64 accumulators, zeroed
// or holding a group's earlier buckets.
extern "C" int zipper_fused_bucket(const int* keys, const float* vals,
                                   const int* plens, int S, int L, int R,
                                   int items, int spb, int threads, int* ok,
                                   float* ov, int* ol, long long* steps,
                                   long long* tails, long long* zips, int Cg,
                                   void* stream) {
  Params p = {};
  p.keys = keys; p.vals = vals; p.plens = plens;
  p.S = S; p.L = L; p.R = R; p.spb = spb;
  p.ok = ok; p.ov = ov; p.ol = ol;
  p.steps = reinterpret_cast<unsigned long long*>(steps);
  p.tails = reinterpret_cast<unsigned long long*>(tails);
  p.zips = reinterpret_cast<unsigned long long*>(zips);
  p.Cg = Cg;
  return launch<false>(p, items, threads, stream);
}

// Expand entry.  row_ids/lane_ids: (S,) int64; the six CSR arrays (Bn, ...)
// stacked, a_rows1 / b_rows1 their row-pointer widths, nnz_cap / bcap
// their entry capacities.  Outputs and accumulators as above.
extern "C" int zipper_fused_expand(
    const long long* row_ids, const long long* lane_ids, int S,
    const int* a_indptr, const int* a_idx, const float* a_val,
    const int* b_indptr, const int* b_idx, const float* b_val, int Bn,
    int a_rows1, int nnz_cap, int b_rows1, int bcap, int L, int R, int items,
    int spb, int threads, int* ok, float* ov, int* ol, long long* steps,
    long long* tails, long long* zips, int Cg, void* stream) {
  Params p = {};
  p.row_ids = row_ids; p.lane_ids = lane_ids;
  p.a_indptr = a_indptr; p.a_idx = a_idx; p.a_val = a_val;
  p.b_indptr = b_indptr; p.b_idx = b_idx; p.b_val = b_val;
  p.Bn = Bn; p.a_rows1 = a_rows1; p.nnz_cap = nnz_cap;
  p.b_rows1 = b_rows1; p.bcap = bcap;
  p.S = S; p.L = L; p.R = R; p.spb = spb;
  p.ok = ok; p.ov = ov; p.ol = ol;
  p.steps = reinterpret_cast<unsigned long long*>(steps);
  p.tails = reinterpret_cast<unsigned long long*>(tails);
  p.zips = reinterpret_cast<unsigned long long*>(zips);
  p.Cg = Cg;
  return launch<true>(p, items, threads, stream);
}
