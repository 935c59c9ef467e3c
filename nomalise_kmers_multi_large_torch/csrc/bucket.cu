// K4: bucket-table upsert + classify for one sorted batch (k <= 15).
//
// Replaces nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py::bucket_batch
// (Pallas `_kernel`, count and seed modes), which matches, inserts and
// tallies through bf16 one-hot MXU matmuls over 128-row tiles visited by a
// scalar-prefetched (tile, chunk) grid. Contract, per valid element of the
// (key, read id)-sorted stream, with row = key >> fp_bits and
// f = (key & (2^fp_bits - 1)) + 1:
//   prior  = counts[row, l] if fp[row, l] == f before the batch, else 0
//   high   : prior + rank >= depth adds 1 to high[rid]       (count mode)
//   a matched code adds its multiplicity to counts[row, l]   (count mode)
//   an unmatched code inserts at its rank-1 occurrence when cand < lanes, at
//   lane occ[row] + (number of inserting codes of the row before it) if that
//   lane is < lanes: fp = f, count += multiplicity (count mode; 0 in seed
//   mode), stats[1] += 1. Otherwise the code is dropped: stats[0] += 1 and
//   none of its occurrences counts.
// The table is left-packed (occ = number of nonzero fp in the row) and an
// empty slot holds count 0, so an element matching a lane inserted earlier in
// this batch sees prior 0, as in the TPU kernel.
//
// Bound on the H100: memory latency. A batch touches up to ~2M rows of 512 B
// (fp + counts at 64 lanes) scattered over a table of up to 1 GiB, so every
// row costs a dependent round trip to HBM. Design: the stream is sorted by
// row, so each row's elements are contiguous and ONE WARP owns a row
// outright: it loads the row's planes into shared memory, resolves matches
// (each thread one element, scanning the row's fingerprints in shared
// memory), assigns insert lanes in stream order with a ballot prefix count,
// aggregates count deltas per lane with __match_any_sync, and writes the row
// back. No atomics touch the table; per-read high tallies use int32
// atomicAdd, which is exact in any order. A warp takes the rows whose first
// element lies in its 32-element slice of the stream, so every row has one
// owner and long rows are walked 32 elements at a time.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLanes = 128;

__global__ void bucket_batch_kernel(
    const uint32_t* __restrict__ skey, const int32_t* __restrict__ p2,
    const int32_t* __restrict__ p3, int64_t n, int32_t* __restrict__ fp,
    int32_t* __restrict__ counts, int rows, int lanes, int fp_bits, int depth,
    bool seed, int32_t* __restrict__ high, int n_reads,
    int32_t* __restrict__ stats) {
  __shared__ int32_t s_fp[kWarpsPerBlock][kMaxLanes];
  __shared__ int32_t s_cnt[kWarpsPerBlock][kMaxLanes];    // pre-batch counts
  __shared__ int32_t s_delta[kWarpsPerBlock][kMaxLanes];  // this batch's adds
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* my_fp = s_fp[warp];
  int32_t* my_cnt = s_cnt[warp];
  int32_t* my_delta = s_delta[warp];
  const unsigned lt_mask = (1u << lane) - 1u;

  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp) * 32;
  if (base >= n) return;  // uniform per warp
  const uint32_t fmask = (1u << fp_bits) - 1u;

  // rows whose first element lies in this warp's slice
  const int64_t e = base + lane;
  const uint32_t key = e < n ? skey[e] : kSentinel;
  const uint32_t row = key >> fp_bits;
  bool start = false;
  if (key != kSentinel && row < static_cast<uint32_t>(rows)) {
    start = e == 0 || (skey[e - 1] >> fp_bits) != row;
  }
  unsigned starts = __ballot_sync(kFullMask, start);

  while (starts) {
    const int src = __ffs(starts) - 1;
    starts &= starts - 1;
    const uint32_t r = __shfl_sync(kFullMask, row, src);
    const int64_t row_off = static_cast<int64_t>(r) * lanes;

    int occ = 0;
    for (int j = lane; j < lanes; j += 32) {  // lanes is a multiple of 32
      const int32_t v = fp[row_off + j];
      my_fp[j] = v;
      my_cnt[j] = counts[row_off + j];
      my_delta[j] = 0;
      occ += __popc(__ballot_sync(kFullMask, v != 0));
    }
    __syncwarp();

    int next_lane = occ;  // lane of the row's next insert
    int n_inserted = 0, n_dropped = 0;
    for (int64_t pos = base + src; pos < n; pos += 32) {
      const int64_t i = pos + lane;
      const uint32_t k2 = i < n ? skey[i] : kSentinel;
      const bool in_row = k2 != kSentinel && (k2 >> fp_bits) == r;
      if (__ballot_sync(kFullMask, in_row) == 0) break;

      int32_t f = 0;
      int rank = 0, cand = 0, matched = -1;
      uint32_t rid = 0;
      if (in_row) {
        f = static_cast<int32_t>(k2 & fmask) + 1;
        const uint32_t q = static_cast<uint32_t>(p2[i]);
        rank = static_cast<int>(q & 0xFFFFu);
        rid = q >> 16;
        cand = p3[i];
        for (int j = 0; j < lanes; ++j) {
          if (my_fp[j] == f) matched = j;
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
      __syncwarp();  // every match above has read my_fp
      if (fits) my_fp[my_lane] = f;

      // lane of each element's code: matched before this group, or inserted
      // by the code's first occurrence, the lowest thread of equal keys
      const unsigned peers = __match_any_sync(
          kFullMask, in_row ? static_cast<int>(k2) : -2 - lane);
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
        const unsigned same = __match_any_sync(kFullMask, adds ? target : -1 - lane);
        if (adds && lane == __ffs(same) - 1) my_delta[target] += __popc(same);
      }
      __syncwarp();
    }

    for (int j = lane; j < lanes; j += 32) {
      fp[row_off + j] = my_fp[j];
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

// fp, counts: int32 [rows, lanes], updated in place; high: int32 [n_reads]
// and stats: int32 [2] (dropped, inserted), both zeroed by the caller.
NKM_EXPORT int nkm_bucket_batch(const void* skey, const void* p2,
                                const void* p3, long long n, void* fp,
                                void* counts, int rows, int lanes, int fp_bits,
                                int depth, int seed, void* high, int n_reads,
                                void* stats, int device, void* stream) {
  int err = nkm_select_device(device);
  if (err) return err;
  if (lanes % 32 != 0 || lanes > kMaxLanes || fp_bits < 1 || fp_bits > 16) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int64_t warps = (n + 31) / 32;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bucket_batch_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(skey), static_cast<const int32_t*>(p2),
        static_cast<const int32_t*>(p3), n, static_cast<int32_t*>(fp),
        static_cast<int32_t*>(counts), rows, lanes, fp_bits, depth, seed != 0,
        static_cast<int32_t*>(high), n_reads, static_cast<int32_t*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
