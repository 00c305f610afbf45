// K2: partition merge for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/merge_partitions.py::merge_partitions_pallas (merge_tile +
// advance_tile): the full merge of two sorted, duplicate-free,
// EMPTY-padded partitions per stream (a key on both sides becomes the
// single add va + vb), plus the per-stream chunk-advancement state
// machine that yields the mszip counters.  Bit-identical, counters
// included, to the plain-torch merge_tree.merge_partitions.
//
// Bound: bytes.  Each valid input element is read once (8 B), each output
// slot written once (8 B), plus lengths and four int32 counters per
// stream; the least time is those bytes at 3.35 TB/s.
//
// Short rows (La + Lb <= 4,096 slots): one launch of two roles.  Payload
// blocks take whole rows (as many as fit a tile of 4,096 slots) and place
// every element straight at its rank among the merged uniques: a binary
// search in the other side gives the cross rank, a block prefix over
// ballot words in shared memory the count of earlier cross-side
// duplicates.  Counter blocks give one warp to each stream for the
// advance loop, whose trip count depends on the data.
//
// Long rows (La + Lb > 4,096; the last rounds of a row of A*A with many
// products merge up to 2^20 slots).  One CTA per row made a long row the
// work of one SM, and one warp per row walked the advance loop, a chain of
// thousands of dependent global loads.  Both are now spread over the card:
//   payload   the row's la + lb valid elements, in merged order, are cut
//             into diagonal tiles of kLongTile; CTA c finds where its tile
//             starts in A and B by a binary search on the merge path
//             (ties go to A first, so a key on both sides sits as the
//             pair A, B), loads both slices into shared memory with
//             cp.async, merges them there by rank, and counts the B
//             elements its tile drops as duplicates.  An output rank is
//             the merged position less the duplicates before it: those
//             of earlier tiles come from a decoupled look-back over the
//             row's tiles (tickets taken in launch order, so a CTA waits
//             only on CTAs already running), those of its own tile from
//             a block prefix.  CTAs past the merged length only store
//             EMPTY / 0, 16 bytes at a time.
//   counters  after each step both sides are consumed up to the step's
//             cutoff c, so the state (pa, pb) is a function of c alone:
//             pa = #A <= c, pb = #B <= c, and the next cutoff is the
//             smaller of the two fronts' last valid keys.  The candidate
//             cutoffs are the la + lb keys plus the start; one thread per
//             candidate computes its successor, its step (1) and zip
//             elements, and ceil(log2((La + Lb) / R + 2)) rounds of
//             pointer jumping (each a short launch that returns at once
//             when the previous round found every chain ended) sum the
//             chain from the start.  A row that is not sorted and
//             duplicate-free with non-negative keys (EMPTY only past its
//             valid keys) runs the plain advance loop in one warp instead,
//             so every input the loop admits gives its counters bit for
//             bit.
// The wrapper reduces the per-stream counters per pair with a few torch
// ops, and counts one K2 launch per call whatever the route launches.
#include "zipper.cuh"

namespace {

constexpr int kTileSlots = 4096;

int rows_per_block(int La, int Lb) {
  return std::max(1, kTileSlots / (La + Lb));
}

bool long_route(int La, int Lb) { return La + Lb > kTileSlots; }

// 32-bit words of ballot bits (and as many of prefixes) per short tile
long long tile_words(int La, int Lb) {
  return ((long long)rows_per_block(La, Lb) * (La + Lb) >> 5) + 1;
}

__global__ void __launch_bounds__(zipper::kThreads)
merge_partitions_kernel(const int* __restrict__ ka, const float* __restrict__ va,
                        const int* __restrict__ la,
                        const int* __restrict__ kb, const float* __restrict__ vb,
                        const int* __restrict__ lb,
                        int N, int La, int Lb, int R, int rpb, int n_payload,
                        int* __restrict__ ok, float* __restrict__ ov,
                        int* __restrict__ ol, int* __restrict__ st,
                        int* __restrict__ zp, int* __restrict__ ta,
                        int* __restrict__ tb) {
  if ((int)blockIdx.x < n_payload) {
    extern __shared__ unsigned char smem[];
    const long long nwords = ((long long)rpb * (La + Lb) >> 5) + 1;
    unsigned* bits = reinterpret_cast<unsigned*>(smem);
    int* pre = reinterpret_cast<int*>(bits + nwords);
    const long long n0 = (long long)blockIdx.x * rpb;
    zipper::PairTile t;
    t.ka = ka + n0 * La; t.va = va + n0 * La; t.a_stride = La;
    t.kb = kb + n0 * Lb; t.vb = vb + n0 * Lb; t.b_stride = Lb;
    t.la = la + n0; t.lb = lb + n0; t.len_stride = 1;
    t.ok = ok + n0 * (La + Lb); t.ov = ov + n0 * (La + Lb);
    t.o_stride = La + Lb;
    t.ol = ol + n0;
    t.Wa = La; t.Wb = Lb;
    t.P = (int)min((long long)rpb, N - n0);
    zipper::merge_tile(t, bits, pre);
    return;
  }
  const long long row = (long long)(blockIdx.x - n_payload) *
                            (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;
  const zipper::Advance a = zipper::advance_warp(
      ka + row * La, la[row], kb + row * Lb, lb[row], R);
  if ((threadIdx.x & 31) == 0) {
    st[row] = a.steps;
    zp[row] = a.zips;
    ta[row] = a.tail_a;
    tb[row] = a.tail_b;
  }
}

// ---------------------------------------------------------------------------
// Long rows: payload
// ---------------------------------------------------------------------------
constexpr int kLongTile = 2048;  // merged elements per payload CTA
constexpr int kLongWords = kLongTile / 32;
constexpr unsigned kAggregate = 1u << 30;  // tile status: own duplicates
constexpr unsigned kInclusive = 2u << 30;  // ... duplicates up to and in it
constexpr unsigned kValue = kAggregate - 1;

long long long_tiles(int La, int Lb) {
  return ((long long)La + Lb + kLongTile - 1) / kLongTile;
}

// Number of A elements among the first d of the merged order (A first on
// equal keys): the merge path's crossing of diagonal d, the first i with
// a[i] > b[d - 1 - i].  One warp probes 32 points of the range at a time,
// so a range of 2^19 takes 4 rounds of loads, not 19.
__device__ int merge_path_warp(const int* a, int na, const int* b, int nb,
                               long long d) {
  const int lane = threadIdx.x & 31;
  int lo = (int)max(0LL, d - nb), hi = (int)min(d, (long long)na);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int m = lo + lane * step;
    const bool before = m < hi && a[m] <= b[d - 1 - m];
    const int t = __popc(__ballot_sync(zipper::kFull, before));
    if (t == 0) break;  // a[lo] > b[d - 1 - lo]: the crossing is lo
    const int last = lo + (t - 1) * step;  // the last point before it
    lo = last + 1;
    hi = min(hi, last + step);
  }
  return lo;
}

// First index in sorted a[0, n) whose key is > key.
__device__ __forceinline__ int upper_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Store `value` over p[s0, s1): scalar stores up to a 16-byte boundary,
// then 16 bytes a store.
template <typename T>
__device__ void fill(T* p, T value, long long s0, long long s1) {
  if (s0 >= s1) return;
  const long long mis =
      (long long)(((16u - ((uintptr_t)(p + s0) & 15u)) & 15u) / sizeof(T));
  const long long h = min(s1, s0 + mis);
  for (long long x = s0 + threadIdx.x; x < h; x += blockDim.x) p[x] = value;
  const long long nv = (s1 - h) / 4;
  T quad[4] = {value, value, value, value};
  const int4 q4 = *reinterpret_cast<int4*>(quad);
  int4* p4 = reinterpret_cast<int4*>(p + h);
  for (long long x = threadIdx.x; x < nv; x += blockDim.x) p4[x] = q4;
  for (long long x = h + 4 * nv + threadIdx.x; x < s1; x += blockDim.x)
    p[x] = value;
}

__global__ void __launch_bounds__(zipper::kThreads)
merge_partitions_long_payload(const int* __restrict__ ka,
                              const float* __restrict__ va,
                              const int* __restrict__ la,
                              const int* __restrict__ kb,
                              const float* __restrict__ vb,
                              const int* __restrict__ lb, int La, int Lb,
                              long long tiles, int* __restrict__ ok,
                              float* __restrict__ ov, int* __restrict__ ol,
                              unsigned* __restrict__ ticket) {
  __shared__ int s_keys[kLongTile];   // the tile's A slice, then its B slice
  __shared__ float s_vals[kLongTile];
  __shared__ int s_okeys[kLongTile];  // by merged position in the tile
  __shared__ float s_ovals[kLongTile];
  __shared__ unsigned s_bits[kLongWords];  // B elements dropped as duplicates
  __shared__ int s_pre[kLongWords];
  __shared__ long long s_t;
  __shared__ int s_i0, s_i1;
  __shared__ unsigned s_excl, s_dups;
  const int tid = threadIdx.x;

  if (tid == 0) s_t = atomicAdd(reinterpret_cast<unsigned long long*>(ticket),
                                1ULL);
  __syncthreads();
  const long long t = s_t, row = t / tiles, c = t % tiles;
  const long long L = (long long)La + Lb;
  const int* A = ka + row * La;
  const int* B = kb + row * Lb;
  const int na = la[row], nb = lb[row];
  const long long M = (long long)na + nb;
  int* okr = ok + row * L;
  float* ovr = ov + row * L;
  unsigned* status = ticket + 2 + row * tiles;
  const long long d0 = c * kLongTile;
  // slots past the merged length that lie in this CTA's stretch
  fill(okr, zipper::kEmpty, max(d0, M), min(d0 + kLongTile, L));
  fill(ovr, 0.0f, max(d0, M), min(d0 + kLongTile, L));
  if (d0 >= M) {
    if (c == 0 && tid == 0) ol[row] = 0;
    return;
  }
  const long long d1 = min(d0 + kLongTile, M);
  if (tid < 32) {
    const int i0 = merge_path_warp(A, na, B, nb, d0);
    if (tid == 0) s_i0 = i0;
  } else if (tid < 64) {
    const int i1 = merge_path_warp(A, na, B, nb, d1);
    if (tid == 32) s_i1 = i1;
  }
  for (int w = tid; w < kLongWords; w += blockDim.x) s_bits[w] = 0;
  __syncthreads();
  const int i0 = s_i0, i1 = s_i1;
  const int j0 = (int)(d0 - i0), j1 = (int)(d1 - i1);
  const int nA = i1 - i0, n = (int)(d1 - d0);
  for (int e = tid; e < n; e += blockDim.x) {
    const long long src = e < nA ? i0 + e : j0 + e - nA;
    cp_async4(s_keys + e, (e < nA ? A : B) + src);
    cp_async4(s_vals + e, (e < nA ? va + row * La : vb + row * Lb) + src);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the one duplicate partner that may lie outside the tile on each side:
  // A[i0 - 1] for the tile's first B element, B[j1] for its last A element
  const bool has_prev = i0 > 0, has_next = j1 < nb;
  const int a_prev = has_prev ? A[i0 - 1] : 0;
  const int b_next = has_next ? B[j1] : 0;
  __syncthreads();
  const int* As = s_keys;
  const int* Bs = s_keys + nA;
  const int nB = n - nA;
  for (int e = tid; e < n; e += blockDim.x) {
    const int k = s_keys[e];
    if (e < nA) {
      const int r = zipper::lower_bound(Bs, nB, k);  // B before it: B < k
      float v = s_vals[e];
      if (r < nB ? Bs[r] == k : has_next && b_next == k)
        v = v + (r < nB ? s_vals[nA + r] : vb[row * Lb + j1]);
      s_okeys[e + r] = k;
      s_ovals[e + r] = v;
    } else {
      const int b = e - nA;
      const int r = upper_bound(As, nA, k);  // A before it: A <= k
      const int p = b + r;
      s_okeys[p] = k;
      s_ovals[p] = s_vals[e];
      if (r > 0 ? As[r - 1] == k : has_prev && a_prev == k)
        atomicOr(s_bits + (p >> 5), 1u << (p & 31));
    }
  }
  __syncthreads();
  const int nwords = (n + 31) >> 5;
  zipper::word_prefix(s_bits, s_pre, nwords);
  if (tid < 32) {  // look-back, one warp: 32 predecessors per read
    const unsigned dups =
        (unsigned)(s_pre[nwords - 1] + __popc(s_bits[nwords - 1]));
    volatile unsigned* vs = status;
    unsigned excl = 0;
    if (c > 0) {
      if (tid == 0) vs[c] = kAggregate | dups;
      for (long long top = c - 1;; top -= 32) {
        const long long p = top - tid;  // tile 0 is always inclusive, so
        unsigned s = kInclusive;        // lanes past it are never summed
        if (p >= 0) {
          do {
            s = vs[p];
          } while (s == 0);
        }
        const unsigned incl = __ballot_sync(zipper::kFull, s & kInclusive);
        // sum up to and with the nearest inclusive predecessor
        const int stop = incl ? __ffs(incl) - 1 : 31;
        excl += __reduce_add_sync(zipper::kFull,
                                  tid <= stop ? s & kValue : 0u);
        if (incl) break;
      }
    }
    if (tid == 0) {
      vs[c] = kInclusive | (excl + dups);
      s_excl = excl;
      s_dups = dups;
    }
  }
  __syncthreads();
  const long long base = d0 - s_excl;
  for (int p = tid; p < n; p += blockDim.x) {
    if ((s_bits[p >> 5] >> (p & 31)) & 1u) continue;
    const long long o = base + p - zipper::count_before(s_bits, s_pre, p);
    okr[o] = s_okeys[p];
    ovr[o] = s_ovals[p];
  }
  if (d1 == M) {  // the row's last valid tile: its length, and the slots
                  // its duplicates left below the merged length
    const long long n_out = M - (s_excl + s_dups);
    if (tid == 0) ol[row] = (int)n_out;
    fill(okr, zipper::kEmpty, n_out, M);
    fill(ovr, 0.0f, n_out, M);
  }
}

// ---------------------------------------------------------------------------
// Long rows: counters by pointer jumping
// ---------------------------------------------------------------------------
// Candidate cutoffs of row r, x in [0, la + lb]: 0 is the start (nothing
// consumed), 1 + i the key A[i], 1 + la + j the key B[j].  An entry holds
// the candidate reached after 2^round steps and the steps and zip
// elements on the way; a chain's end points to itself with zeros.
struct __align__(16) Jump {
  int next, steps, zips, pad;
};

// the first EMPTY in a[0, n) of a well-formed row
__device__ __forceinline__ int valid_len(const int* a, int n) {
  return zipper::lower_bound(a, n, zipper::kEmpty);
}

// (pa, pb) at candidate x of a well-formed row; false for an EMPTY key
__device__ bool node_state(const int* A, int na, int ea, const int* B, int nb,
                           int eb, int x, int* pa, int* pb) {
  if (x == 0) {
    *pa = *pb = 0;
    return true;
  }
  if (x <= na) {
    const int i = x - 1;
    if (i >= ea) return false;
    *pa = i + 1;
    *pb = upper_bound(B, eb, A[i]);
    return true;
  }
  const int j = x - 1 - na;
  if (j >= eb) return false;
  *pb = j + 1;
  *pa = upper_bound(A, ea, B[j]);
  return true;
}

// Row blockIdx.x, its la + lb + 1 candidates strided over the gridDim.y
// blocks of the row: one thread per candidate computes its successor and
// the well-formedness of its key; flags[0] is set when any chain takes a
// step.
__global__ void __launch_bounds__(zipper::kThreads)
merge_partitions_long_jump_init(const int* __restrict__ ka,
                                const int* __restrict__ la,
                                const int* __restrict__ kb,
                                const int* __restrict__ lb, int La, int Lb,
                                int R, Jump* __restrict__ tab,
                                unsigned* __restrict__ flags,
                                unsigned* __restrict__ malformed) {
  const long long row = blockIdx.x;
  const int na = la[row], nb = lb[row];
  const int* A = ka + row * La;
  const int* B = kb + row * Lb;
  Jump* t = tab + row * ((long long)La + Lb + 1);
  const int ea = valid_len(A, na), eb = valid_len(B, nb);
  for (int x = blockIdx.y * blockDim.x + threadIdx.x; x <= na + nb;
       x += gridDim.y * blockDim.x) {
    // sorted, duplicate-free, non-negative, EMPTY only at the end
    if (x > 0) {
      const int* s = x <= na ? A : B;
      const int n = x <= na ? na : nb;
      const int i = x <= na ? x - 1 : x - 1 - na;
      const int k = s[i];
      if (k < 0 ||
          (i + 1 < n && !(k < s[i + 1] || s[i + 1] == zipper::kEmpty)))
        atomicOr(malformed + row, 1u);
    }
    Jump j = {x, 0, 0, 0};
    int pa, pb;
    if (node_state(A, na, ea, B, nb, eb, x, &pa, &pb) && pa < na &&
        pb < nb) {
      const int fa = min(na - pa, R), fb = min(nb - pb, R);
      const int xa = min(pa + fa, ea), xb = min(pb + fb, eb);
      const int mxa = xa > pa ? A[xa - 1] : -1;
      const int mxb = xb > pb ? B[xb - 1] : -1;
      // a front with no valid key never advances: the plain loop does
      // not end there, and the chain stops
      if (mxa >= 0 && mxb >= 0) {
        j.next = mxa <= mxb ? xa : na + xb;
        j.steps = 1;
        j.zips = fa + fb;
        if (x == 0) flags[0] = 1;
      }
    }
    t[x] = j;
  }
}

// One round of pointer jumping, src -> dst, laid out as the init; nothing
// to do when round r - 1 left every chain at its end.  flags[r] is set
// when a chain still goes on after this round.
__global__ void __launch_bounds__(zipper::kThreads)
merge_partitions_long_jump_round(const int* __restrict__ la,
                                 const int* __restrict__ lb, int La, int Lb,
                                 const Jump* __restrict__ src,
                                 Jump* __restrict__ dst,
                                 unsigned* __restrict__ flags, int r) {
  if (*(volatile unsigned*)(flags + r - 1) == 0) return;
  const long long row = blockIdx.x;
  const long long NN = (long long)La + Lb + 1;
  const Jump* t = src + row * NN;
  Jump* d = dst + row * NN;
  const int n = la[row] + lb[row];
  for (int x = blockIdx.y * blockDim.x + threadIdx.x; x <= n;
       x += gridDim.y * blockDim.x) {
    Jump j = t[x];
    if (j.next != x) {
      const Jump f = t[j.next];
      j.next = f.next;
      j.steps += f.steps;
      j.zips += f.zips;
    }
    d[x] = j;
    if (x == 0 && t[j.next].next != j.next) flags[r] = 1;
  }
}

// One warp per row: the chain's totals from the start, the tails from
// where it ends; a row that is not well formed runs the plain loop.
__global__ void __launch_bounds__(zipper::kThreads)
merge_partitions_long_jump_final(const int* __restrict__ ka,
                                 const int* __restrict__ la,
                                 const int* __restrict__ kb,
                                 const int* __restrict__ lb, int N, int La,
                                 int Lb, int R, int rounds,
                                 const Jump* __restrict__ tab0,
                                 const Jump* __restrict__ tab1,
                                 const unsigned* __restrict__ flags,
                                 const unsigned* __restrict__ malformed,
                                 int* __restrict__ st, int* __restrict__ zp,
                                 int* __restrict__ ta, int* __restrict__ tb) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= N) return;
  const int na = la[row], nb = lb[row];
  const int* A = ka + row * La;
  const int* B = kb + row * Lb;
  int ran = 0;  // rounds that ran: each ran because the one before set
                // its flag
  while (ran < rounds && flags[ran]) ++ran;
  const Jump* t = ((ran & 1) ? tab1 : tab0) + row * ((long long)La + Lb + 1);
  const Jump j = t[0];
  zipper::Advance a;
  if (malformed[row] || t[j.next].next != j.next) {
    // not well formed, or (beyond the bound on steps) a chain not ended
    a = zipper::advance_warp(A, na, B, nb, R);
  } else {
    int pa, pb;
    node_state(A, na, valid_len(A, na), B, nb, valid_len(B, nb), j.next, &pa,
               &pb);
    a.steps = j.steps;
    a.zips = j.zips;
    a.tail_a = (max(na - pa, 0) + R - 1) / R;
    a.tail_b = (max(nb - pb, 0) + R - 1) / R;
  }
  if ((threadIdx.x & 31) == 0) {
    st[row] = a.steps;
    zp[row] = a.zips;
    ta[row] = a.tail_a;
    tb[row] = a.tail_b;
  }
}

// rounds of pointer jumping: 2^rounds >= (La + Lb) / R + 2 steps.  A step
// consumes the whole front of the side whose last valid key is the
// cutoff: R keys, or what that side has left, after which the chain ends.
int jump_rounds(int La, int Lb, int R) {
  int r = 0;
  while ((1LL << r) < ((long long)La + Lb) / R + 2) ++r;
  return r;
}

// blocks per row of the pointer-jumping kernels: about 2,048 candidates
// a block, at most 32
int jump_blocks(int La, int Lb) {
  return (int)std::min(32LL, ((long long)La + Lb + 1 + 2047) / 2048);
}

// words of the zeroed scratch: the ticket (2), the tiles' status, and with
// the counters the round flags and the rows' malformed flags
long long long_scratch_words(int N, int La, int Lb, int R,
                             int with_counters) {
  long long w = 2 + N * long_tiles(La, Lb);
  if (with_counters) w += jump_rounds(La, Lb, R) + 1 + N;
  return w;
}

int launch_long(const int* ka, const float* va, const int* la, const int* kb,
                const float* vb, const int* lb, int N, int La, int Lb, int R,
                int with_counters, int* ok, float* ov, int* ol, int* st,
                int* zp, int* ta, int* tb, unsigned* scratch, void* tables,
                cudaStream_t stream) {
  const long long tiles = long_tiles(La, Lb);
  merge_partitions_long_payload<<<(unsigned)(N * tiles), zipper::kThreads, 0,
                                  stream>>>(ka, va, la, kb, vb, lb, La, Lb,
                                            tiles, ok, ov, ol, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_counters) return (int)err;
  const int rounds = jump_rounds(La, Lb, R);
  unsigned* flags = scratch + 2 + N * tiles;
  unsigned* malformed = flags + rounds + 1;
  const long long NN = (long long)La + Lb + 1;
  Jump* tab[2] = {static_cast<Jump*>(tables),
                  static_cast<Jump*>(tables) + N * NN};
  const dim3 grid(N, jump_blocks(La, Lb));
  merge_partitions_long_jump_init<<<grid, zipper::kThreads, 0, stream>>>(
      ka, la, kb, lb, La, Lb, R, tab[0], flags, malformed);
  for (int r = 1; r <= rounds; ++r)
    merge_partitions_long_jump_round<<<grid, zipper::kThreads, 0, stream>>>(
        la, lb, La, Lb, tab[(r - 1) & 1], tab[r & 1], flags, r);
  const int warps = zipper::kThreads / 32;
  merge_partitions_long_jump_final<<<(N + warps - 1) / warps,
                                     zipper::kThreads, 0, stream>>>(
      ka, la, kb, lb, N, La, Lb, R, rounds, tab[0], tab[1], flags, malformed,
      st, zp, ta, tb);
  return (int)cudaGetLastError();
}

}  // namespace

// ka/va: (N, La); kb/vb: (N, Lb); la/lb: (N,); ok/ov: (N, La + Lb);
// ol and the per-stream counters st/zp/ta/tb: (N,).  with_counters = 0
// skips the advance loop (the counters are left untouched).  Long rows
// (La + Lb > 4,096) take scratch: zipper_merge_scratch_words words of
// zeroed device memory, and with the counters tables:
// zipper_merge_table_words words (need not be zeroed); both null for
// short rows.
extern "C" int zipper_merge_partitions(
    const int* ka, const float* va, const int* la, const int* kb,
    const float* vb, const int* lb, int N, int La, int Lb, int R,
    int with_counters, int* ok, float* ov, int* ol, int* st, int* zp,
    int* ta, int* tb, unsigned* scratch, void* tables, void* stream) {
  if (N == 0 || La + Lb == 0) return 0;
  if (long_route(La, Lb))
    return launch_long(ka, va, la, kb, vb, lb, N, La, Lb, R, with_counters,
                       ok, ov, ol, st, zp, ta, tb, scratch, tables,
                       (cudaStream_t)stream);
  const int rpb = rows_per_block(La, Lb);
  const size_t smem = (size_t)tile_words(La, Lb) * 8;
  cudaError_t err = zipper::allow_smem(merge_partitions_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_payload = (N + rpb - 1) / rpb;
  const int warps = zipper::kThreads / 32;
  const int n_counter = with_counters ? (N + warps - 1) / warps : 0;
  merge_partitions_kernel<<<n_payload + n_counter, zipper::kThreads, smem,
                            (cudaStream_t)stream>>>(
      ka, va, la, kb, vb, lb, N, La, Lb, R, rpb, n_payload, ok, ov, ol, st,
      zp, ta, tb);
  return (int)cudaGetLastError();
}

// Words of zeroed scratch a launch needs: 0 for short rows.
extern "C" long long zipper_merge_scratch_words(int N, int La, int Lb, int R,
                                                int with_counters) {
  if (N == 0 || !long_route(La, Lb)) return 0;
  return long_scratch_words(N, La, Lb, R, with_counters);
}

// Words of the pointer-jumping tables (two of N * (La + Lb + 1) entries
// of 4 words): 0 for short rows or without the counters.
extern "C" long long zipper_merge_table_words(int N, int La, int Lb,
                                              int with_counters) {
  if (N == 0 || !long_route(La, Lb) || !with_counters) return 0;
  return 2LL * N * ((long long)La + Lb + 1) * 4;
}
