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
// - a sentinel's w1 maps to row 2^(32 - row_shift) - 1: the last real row
//   of a whole table, and past the rows of a Mode B row shard; a real code
//   may have w1 = 0xFFFFFFFF too. So validity is w2 != 0xFFFFFFFF
//   everywhere, and only a valid element's row is ever read or written;
// - a full 32-bit w1 can equal any int tag, so lanes group by the 64-bit
//   word pair in __match_any_sync, and a lane outside the row tags itself
//   with its lane number over a low word no real w2 has (0xFFFFFFFF);
// - plane B is absent at k = 16 (fpb == nullptr).
//
// Bound on the H100: memory latency, as K4, with two fingerprint planes
// (fpA, fpB) beside the counts, over a table of up to 1.5 GiB. Design as K4
// (csrc/bucket_rows.cuh): the warp that owns the rows starting in its slice
// copies lanes 0..31 of fpA and fpB of all of them into a shared-memory ring
// with one cp.async batch (8.25 KiB per warp), so it waits on one round trip
// for its ~18 rows; lanes 32.. are read only for rows whose first 32 lanes
// are full; only matched counts are read; only inserted fingerprints (both
// planes) and changed counts are stored.
#include "bucket_rows.cuh"

namespace {

using nkm_bucket::kMaxLanes;
using nkm_bucket::kRingStride;
using nkm_bucket::kWarpsPerBlock;

// two 32-bit sort words per element
struct WideStream {
  const uint32_t* __restrict__ sk1;
  const uint32_t* __restrict__ sk2;
  int row_shift;

  __device__ __forceinline__ void load(int64_t i, int64_t n, uint32_t& a,
                                       uint32_t& b) const {
    const bool in = i >= 0 && i < n;
    a = in ? sk1[i] : kSentinel;
    b = in ? sk2[i] : kSentinel;
  }
  __device__ __forceinline__ bool valid(uint32_t, uint32_t b) const {
    return b != kSentinel;
  }
  __device__ __forceinline__ uint32_t row(uint32_t a) const {
    return a >> row_shift;
  }
  __device__ __forceinline__ int32_t fa(uint32_t a) const {
    return static_cast<int32_t>(a & ((1u << row_shift) - 1u)) + 1;
  }
  __device__ __forceinline__ int32_t fb(uint32_t b) const {
    return static_cast<int32_t>(b);
  }
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    bucket_batch_wide_kernel(WideStream s, const int32_t* __restrict__ p2,
                             const int32_t* __restrict__ p3, int64_t n,
                             int32_t* __restrict__ fpa,
                             int32_t* __restrict__ fpb,
                             int32_t* __restrict__ counts, int lanes,
                             int depth, bool seed, int32_t* __restrict__ high,
                             int n_reads, int32_t* __restrict__ stats) {
  __shared__ int32_t s_ring_a[kWarpsPerBlock][32][kRingStride];
  __shared__ int32_t s_ring_b[kWarpsPerBlock][32][kRingStride];
  const int warp = threadIdx.x >> 5;
  nkm_bucket::upsert_slice(s, p2, p3, n, fpa, fpb, counts, lanes, depth, seed,
                           high, n_reads, stats, s_ring_a[warp],
                           s_ring_b[warp]);
}

}  // namespace

// fpa, counts (and fpb, null at k = 16): int32 [rows, lanes], updated in
// place; rows a power of two <= 2^(32 - row_shift): a whole table, or a
// row shard of one whose stream holds only rebased rows below `rows`. high: int32 [n_reads] and stats: int32
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
      row_shift > 31 || rows < 1 || (rows & (rows - 1)) != 0 ||
      (static_cast<int64_t>(rows) << row_shift) > (int64_t{1} << 32)) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int64_t warps = (n + 31) / 32;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const WideStream s{static_cast<const uint32_t*>(sk1),
                       static_cast<const uint32_t*>(sk2), row_shift};
    bucket_batch_wide_kernel<<<static_cast<unsigned>(blocks),
                               kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        s, static_cast<const int32_t*>(p2), static_cast<const int32_t*>(p3), n,
        static_cast<int32_t*>(fpa), static_cast<int32_t*>(fpb),
        static_cast<int32_t*>(counts), lanes, depth, seed != 0,
        static_cast<int32_t*>(high), n_reads, static_cast<int32_t*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
