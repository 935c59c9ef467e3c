// K5: wide bucket-table upsert + classify for one sorted batch (k = 16..31).
//
// Replaces nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py::
// bucket_batch_wide (Pallas `_kernel_wide`, count and seed modes), which
// matches and inserts through bf16 one-hot MXU matmuls over 8-bit limbs of
// the fingerprints, on 128-row tiles visited by a scalar-prefetched (tile,
// chunk) grid. Contract: the stream holds the Feistel sort words (w1, w2)
// of ops/mix.py, sorted by (w1, w2, read id), the sentinel pair
// (0xFFFFFFFF, 0xFFFFFFFF) last. An element is valid iff w2 != 0xFFFFFFFF
// (a real w2 is < 2^30; at k = 16 it is 0). For each valid element, with
// row = w1 >> row_shift, fA = (w1 & (2^row_shift - 1)) + 1 and fB = w2, the
// contract of csrc/bucket.cu (K4) holds with "fingerprint equal" read as
// "fpA equal and, at k > 16, fpB equal", and an insert writing both planes.
//
// Three traps the narrow kernel never meets:
// - a sentinel's w1 maps to row rows - 1, a real row, and a real code may
//   have w1 = 0xFFFFFFFF too; so validity is w2 != 0xFFFFFFFF everywhere;
// - a full 32-bit w1 can equal any int tag, so lanes group by the 64-bit
//   word pair in __match_any_sync, and a lane outside the row tags itself
//   with its lane number over a low word no real w2 has (0xFFFFFFFF);
// - plane B is absent at k = 16 (fpb == nullptr).
//
// Bound on the H100: memory latency, as K4. A row is 768 B (fpA, fpB and
// counts at 64 lanes), scattered over a table of up to 1.5 GiB. Design as
// K4: one warp owns a bucket row (the warp whose 32-element stream slice
// holds the row's first element), loads its planes into shared memory
// (3 x 128 x 4 B per warp, plus the count deltas), matches one element per
// thread, assigns insert lanes in stream order with a ballot prefix count,
// aggregates count deltas per lane with __match_any_sync and writes the row
// back. No atomics touch the table; per-read high tallies use int32
// atomicAdd, which is exact in any order.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLanes = 128;

__global__ void bucket_batch_wide_kernel(
    const uint32_t* __restrict__ sk1, const uint32_t* __restrict__ sk2,
    const int32_t* __restrict__ p2, const int32_t* __restrict__ p3, int64_t n,
    int32_t* __restrict__ fpa, int32_t* __restrict__ fpb,
    int32_t* __restrict__ counts, int lanes, int row_shift, int depth,
    bool seed, int32_t* __restrict__ high, int n_reads,
    int32_t* __restrict__ stats) {
  __shared__ int32_t s_fpa[kWarpsPerBlock][kMaxLanes];
  __shared__ int32_t s_fpb[kWarpsPerBlock][kMaxLanes];
  __shared__ int32_t s_cnt[kWarpsPerBlock][kMaxLanes];    // pre-batch counts
  __shared__ int32_t s_delta[kWarpsPerBlock][kMaxLanes];  // this batch's adds
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* my_fpa = s_fpa[warp];
  int32_t* my_fpb = s_fpb[warp];
  int32_t* my_cnt = s_cnt[warp];
  int32_t* my_delta = s_delta[warp];
  const bool has_b = fpb != nullptr;
  const unsigned lt_mask = (1u << lane) - 1u;

  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp) * 32;
  if (base >= n) return;  // uniform per warp
  const uint32_t amask = (1u << row_shift) - 1u;

  // rows whose first element lies in this warp's slice; valid elements sort
  // before every sentinel, so a valid element's predecessor is valid
  const int64_t e = base + lane;
  const bool valid = e < n && sk2[e] != kSentinel;
  const uint32_t row = valid ? sk1[e] >> row_shift : 0;
  bool start = false;
  if (valid) start = e == 0 || (sk1[e - 1] >> row_shift) != row;
  unsigned starts = __ballot_sync(kFullMask, start);

  while (starts) {
    const int src = __ffs(starts) - 1;
    starts &= starts - 1;
    const uint32_t r = __shfl_sync(kFullMask, row, src);
    const int64_t row_off = static_cast<int64_t>(r) * lanes;

    int occ = 0;
    for (int j = lane; j < lanes; j += 32) {  // lanes is a multiple of 32
      const int32_t v = fpa[row_off + j];
      my_fpa[j] = v;
      my_fpb[j] = has_b ? fpb[row_off + j] : 0;
      my_cnt[j] = counts[row_off + j];
      my_delta[j] = 0;
      occ += __popc(__ballot_sync(kFullMask, v != 0));
    }
    __syncwarp();

    int next_lane = occ;  // lane of the row's next insert
    int n_inserted = 0, n_dropped = 0;
    for (int64_t pos = base + src; pos < n; pos += 32) {
      const int64_t i = pos + lane;
      uint32_t a = kSentinel, b = kSentinel;
      if (i < n) {
        a = sk1[i];
        b = sk2[i];
      }
      const bool in_row = b != kSentinel && (a >> row_shift) == r;
      if (__ballot_sync(kFullMask, in_row) == 0) break;

      const int32_t fa = static_cast<int32_t>(a & amask) + 1;
      const int32_t fb = has_b ? static_cast<int32_t>(b) : 0;
      int rank = 0, cand = 0, matched = -1;
      uint32_t rid = 0;
      if (in_row) {
        const uint32_t q = static_cast<uint32_t>(p2[i]);
        rank = static_cast<int>(q & 0xFFFFu);
        rid = q >> 16;
        cand = p3[i];
        for (int j = 0; j < lanes; ++j) {
          if (my_fpa[j] == fa && my_fpb[j] == fb) matched = j;
        }
      }

      // inserts, in stream order: the rank-1 occurrence of an unmatched code
      const bool head_new = in_row && matched < 0 && rank == 1;
      const bool inserting = head_new && cand < lanes;
      const unsigned ins_mask = __ballot_sync(kFullMask, inserting);
      const int my_lane =
          inserting ? next_lane + __popc(ins_mask & lt_mask) : -1;
      const bool fits = inserting && my_lane < lanes;
      n_inserted += __popc(__ballot_sync(kFullMask, fits));
      n_dropped += __popc(__ballot_sync(kFullMask, head_new && !fits));
      next_lane += __popc(ins_mask);
      __syncwarp();  // every match above has read the planes
      if (fits) {
        my_fpa[my_lane] = fa;
        my_fpb[my_lane] = fb;
      }

      // lane of each element's code: matched before this group, or inserted
      // by the code's first occurrence, the lowest thread of equal codes
      const unsigned long long tag =
          in_row ? (static_cast<unsigned long long>(a) << 32) | b
                 : (static_cast<unsigned long long>(lane) << 32) | kSentinel;
      const unsigned peers = __match_any_sync(kFullMask, tag);
      const int head_lane =
          __shfl_sync(kFullMask, fits ? my_lane : -1, __ffs(peers) - 1);
      const int target = matched >= 0 ? matched : head_lane;

      if (!seed) {
        if (in_row) {
          const int prior = matched >= 0 ? my_cnt[matched] : 0;
          if (static_cast<int64_t>(prior) + rank >= depth &&
              rid < static_cast<uint32_t>(n_reads)) {
            atomicAdd(&high[rid], 1);
          }
        }
        const bool adds = in_row && target >= 0;
        const unsigned same =
            __match_any_sync(kFullMask, adds ? target : -1 - lane);
        if (adds && lane == __ffs(same) - 1) my_delta[target] += __popc(same);
      }
      __syncwarp();
    }

    for (int j = lane; j < lanes; j += 32) {
      fpa[row_off + j] = my_fpa[j];
      if (has_b) fpb[row_off + j] = my_fpb[j];
      if (!seed) counts[row_off + j] = my_cnt[j] + my_delta[j];
    }
    if (lane == 0) {
      if (n_dropped) atomicAdd(&stats[0], n_dropped);
      if (n_inserted) atomicAdd(&stats[1], n_inserted);
    }
    __syncwarp();
  }
}

}  // namespace

// fpa, counts (and fpb, null at k = 16): int32 [rows, lanes], updated in
// place; rows = 2^(32 - row_shift). high: int32 [n_reads] and stats: int32
// [2] (dropped, inserted), both zeroed by the caller.
NKM_EXPORT int nkm_bucket_batch_wide(const void* sk1, const void* sk2,
                                     const void* p2, const void* p3,
                                     long long n, void* fpa, void* fpb,
                                     void* counts, int rows, int lanes,
                                     int row_shift, int depth, int seed,
                                     void* high, int n_reads, void* stats,
                                     int device, void* stream) {
  int err = nkm_select_device(device);
  if (err) return err;
  if (lanes % 32 != 0 || lanes > kMaxLanes || row_shift < 1 ||
      row_shift > 31 ||
      (static_cast<int64_t>(rows) << row_shift) != (int64_t{1} << 32)) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int64_t warps = (n + 31) / 32;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bucket_batch_wide_kernel<<<static_cast<unsigned>(blocks),
                               kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(sk1), static_cast<const uint32_t*>(sk2),
        static_cast<const int32_t*>(p2), static_cast<const int32_t*>(p3), n,
        static_cast<int32_t*>(fpa), static_cast<int32_t*>(fpb),
        static_cast<int32_t*>(counts), lanes, row_shift, depth, seed != 0,
        static_cast<int32_t*>(high), n_reads, static_cast<int32_t*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
