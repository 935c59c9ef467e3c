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
// empty slot holds count 0, so an element of a code inserted earlier in this
// batch sees prior 0, as in the TPU kernel.
//
// Bound on the H100: memory latency, not bytes. A batch touches ~1.3M rows
// scattered over a table of up to 1 GiB, about 1.7 elements per row and, at
// the fills the stream reaches, 3 to 20 occupied lanes of 64. The work needs
// a few tens of MB (the stream, the occupied fingerprints, the counts that
// are read or change); what costs is the number of dependent round trips to
// HBM each warp waits on. Design (csrc/bucket_rows.cuh): one warp owns the
// rows that start in its 32-element slice; it loads lanes 0..31 of every
// owned row with one batch of cp.async copies into a padded shared-memory
// ring (one round trip for ~18 rows, where a warp per row at a time waited
// on one per row), reads lanes 32.. only of rows whose first 32 lanes are
// full, matches each element against the occupied lanes only, reads the
// count of matched codes only, and stores only inserted fingerprints and
// changed counts (seed mode: inserted fingerprints only). Insert lanes come
// from a ballot prefix in stream order, count deltas from __match_any_sync
// over equal codes; a code whose run crosses a group of 32 carries its lane,
// prior and running multiplicity to the next group. No atomics touch the
// table; per-read high tallies use int32 atomicAdd, exact in any order.
#include "bucket_rows.cuh"

namespace {

using nkm_bucket::kMaxLanes;
using nkm_bucket::kRingStride;
using nkm_bucket::kWarpsPerBlock;

// one 32-bit sort key per element; plane B absent
struct NarrowStream {
  const uint32_t* __restrict__ skey;
  uint32_t rows;
  int fp_bits;

  __device__ __forceinline__ void load(int64_t i, int64_t n, uint32_t& a,
                                       uint32_t& b) const {
    a = i >= 0 && i < n ? skey[i] : kSentinel;
    b = 0;
  }
  __device__ __forceinline__ bool valid(uint32_t a, uint32_t) const {
    return a != kSentinel && (a >> fp_bits) < rows;
  }
  __device__ __forceinline__ uint32_t row(uint32_t a) const {
    return a >> fp_bits;
  }
  __device__ __forceinline__ int32_t fa(uint32_t a) const {
    return static_cast<int32_t>(a & ((1u << fp_bits) - 1u)) + 1;
  }
  __device__ __forceinline__ int32_t fb(uint32_t) const { return 0; }
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    bucket_batch_kernel(NarrowStream s, const int32_t* __restrict__ p2,
                        const int32_t* __restrict__ p3, int64_t n,
                        int32_t* __restrict__ fp, int32_t* __restrict__ counts,
                        int lanes, int depth, bool seed,
                        int32_t* __restrict__ high, int n_reads,
                        int32_t* __restrict__ stats) {
  __shared__ int32_t s_ring[kWarpsPerBlock][32][kRingStride];
  nkm_bucket::upsert_slice(s, p2, p3, n, fp, nullptr, counts, lanes, depth,
                           seed, high, n_reads, stats, s_ring[threadIdx.x >> 5],
                           nullptr);
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
    const NarrowStream s{static_cast<const uint32_t*>(skey),
                         static_cast<uint32_t>(rows), fp_bits};
    bucket_batch_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, static_cast<cudaStream_t>(stream)>>>(
        s, static_cast<const int32_t*>(p2), static_cast<const int32_t*>(p3), n,
        static_cast<int32_t*>(fp), static_cast<int32_t*>(counts), lanes,
        depth, seed != 0, static_cast<int32_t*>(high), n_reads,
        static_cast<int32_t*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
