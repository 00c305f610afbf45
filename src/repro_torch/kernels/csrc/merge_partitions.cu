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
// Bound: bytes.  Each input element is read once (8 B), each output slot
// written once (8 B), plus lengths and four int32 counters per stream;
// the least time is those bytes at 3.35 TB/s.  The design: the grid has
// two roles.  Payload blocks take whole rows (as many as fit a tile of
// 4096 slots, or one longer row) and place every element straight at its
// rank among the merged uniques: a binary search in the other side gives
// the cross rank, a block prefix over ballot words (bits in shared
// memory, 1/32 of the elements) gives the count of earlier cross-side
// duplicates.  Each element is read and each output slot written once,
// with no data-dependent loop.  Counter blocks give one warp to each
// stream for the advance loop, whose trip count depends on the data, so
// a long loop does not hold up any payload.  The wrapper reduces the
// per-stream counters per pair with a few torch ops.
//
// Long rows: the bits and word prefixes take 8 B per 32 slots, so a tile
// of more than ~929K slots would need more shared memory than the
// 232,448 B a block may use (an output row of A*A with more than 524,288
// products merges L = 2^20 slots in its last round).  Such tiles keep
// them in a global scratch buffer that the wrapper allocates
// (zipper_merge_scratch_words says how many words); merge_tile takes the
// two pointers wherever they lie.  Tiles that fit keep shared memory.
#include "zipper.cuh"

namespace {

constexpr int kTileSlots = 4096;
constexpr long long kMaxSmem = 232448;  // dynamic shared memory per block

int rows_per_block(int La, int Lb) {
  return std::max(1, kTileSlots / (La + Lb));
}

// 32-bit words of ballot bits (and as many of prefixes) per tile
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
                        int* __restrict__ tb, unsigned* __restrict__ scratch) {
  if ((int)blockIdx.x < n_payload) {
    extern __shared__ unsigned char smem[];
    const long long nwords = ((long long)rpb * (La + Lb) >> 5) + 1;
    unsigned* bits = scratch ? scratch + 2 * nwords * blockIdx.x
                             : reinterpret_cast<unsigned*>(smem);
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

}  // namespace

// ka/va: (N, La); kb/vb: (N, Lb); la/lb: (N,); ok/ov: (N, La + Lb);
// ol and the per-stream counters st/zp/ta/tb: (N,).  with_counters = 0
// skips the advance loop (the counters are left untouched).  scratch:
// null, or zipper_merge_scratch_words(N, La, Lb) words of device memory.
extern "C" int zipper_merge_partitions(
    const int* ka, const float* va, const int* la, const int* kb,
    const float* vb, const int* lb, int N, int La, int Lb, int R,
    int with_counters, int* ok, float* ov, int* ol, int* st, int* zp,
    int* ta, int* tb, unsigned* scratch, void* stream) {
  if (N == 0 || La + Lb == 0) return 0;
  const int rpb = rows_per_block(La, Lb);
  const size_t smem = scratch ? 0 : (size_t)tile_words(La, Lb) * 8;
  cudaError_t err = zipper::allow_smem(merge_partitions_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_payload = (N + rpb - 1) / rpb;
  const int warps = zipper::kThreads / 32;
  const int n_counter = with_counters ? (N + warps - 1) / warps : 0;
  merge_partitions_kernel<<<n_payload + n_counter, zipper::kThreads, smem,
                            (cudaStream_t)stream>>>(
      ka, va, la, kb, vb, lb, N, La, Lb, R, rpb, n_payload, ok, ov, ol, st,
      zp, ta, tb, scratch);
  return (int)cudaGetLastError();
}

// Words of global scratch a launch needs: 0 while a tile's bits and
// prefixes fit shared memory, else two tiles' worth per payload block.
extern "C" long long zipper_merge_scratch_words(int N, int La, int Lb) {
  if (N == 0 || La + Lb == 0 || tile_words(La, Lb) * 8 <= kMaxSmem) return 0;
  const int rpb = rows_per_block(La, Lb);
  return 2 * tile_words(La, Lb) * ((N + rpb - 1) / rpb);
}
