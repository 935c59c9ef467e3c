// K3 and K3w: rank / candidate scan over the sorted key stream.
//
// Replaces nomalise_kmers_multi_large_tpu/ops/segscan.py::rank_cand_scan
// (Pallas `_kernel`, narrow and wide=True), whose carry is chained from one
// grid step to the next through SMEM on the TPU's in-order grid. Contract,
// for sorted uint32 keys (sentinel 0xFFFFFFFF last) and their read ids:
//   rank = 1-based position in the run of equal codes, clamped to 65535
//   cand = index of the code among the distinct codes of its bucket row
//          (row = key >> shift), clamped to 128
//   p2   = (min(rid, n_reads - 1) << 16) | rank,  p3 = cand
// Narrow (K3): the code is the key and shift = fp_bits. Wide (K3w, k > 15):
// the code is the word pair (key, key2), sorted by (key, key2); a code
// changes when either word changes, and the row comes from key alone, with
// shift = row_shift.
//
// Both quantities are segmented sums, as in the TPU kernel: rank sums 1 and
// resets where the code changes, cand sums "code changed" and resets where
// the row changes. The combine (flag, value) is associative but not
// commutative, so every scan step applies the earlier operand on the left.
//
// Bound on the H100: memory (read 8 B, or 12 B wide, and write 8 B per
// element, twice over the keys). GPU blocks run in no order, so the TPU's
// chained carry becomes a reduce-then-scan: (1) each tile of 2048 elements
// reduces to one aggregate, (2) one block scans the tile aggregates into
// exclusive tile prefixes, (3) each tile rescans its elements from its prefix
// and writes p2/p3. An element compares both words with its predecessor in
// device memory, so a run or row that spans tiles keeps counting through the
// prefixes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // must match ops/segscan.py _TILE
constexpr int kWarps = kThreads / 32;

struct Seg {
  int rf, rv;  // rank segmented sum: reset flag, value
  int cf, cv;  // cand segmented sum: reset flag, value
};

__device__ __forceinline__ Seg identity() { return Seg{0, 0, 0, 0}; }

// a precedes b in stream order
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  Seg o;
  o.rf = a.rf | b.rf;
  o.rv = b.rf ? b.rv : a.rv + b.rv;
  o.cf = a.cf | b.cf;
  o.cv = b.cf ? b.cv : a.cv + b.cv;
  return o;
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int d) {
  Seg o;
  o.rf = __shfl_up_sync(kFullMask, s.rf, d);
  o.rv = __shfl_up_sync(kFullMask, s.rv, d);
  o.cf = __shfl_up_sync(kFullMask, s.cf, d);
  o.cv = __shfl_up_sync(kFullMask, s.cv, d);
  return o;
}

// key2 is null on the narrow path
__device__ __forceinline__ Seg element(const uint32_t* __restrict__ key,
                                       const uint32_t* __restrict__ key2,
                                       int64_t i, int shift) {
  const uint32_t k = key[i];
  bool changed = true, rchanged = true;
  if (i > 0) {
    const uint32_t p = key[i - 1];
    changed = k != p || (key2 != nullptr && key2[i] != key2[i - 1]);
    rchanged = (k >> shift) != (p >> shift);
  }
  return Seg{changed, 1, rchanged, changed};
}

// Exclusive scan of one value per thread over the block; *total gets the
// block's inclusive aggregate. Every thread of the block must call it.
__device__ Seg block_exclusive_scan(Seg v, Seg* total) {
  __shared__ Seg warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const Seg o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg t = lane < kWarps ? warp_total[lane] : identity();
    for (int d = 1; d < kWarps; d <<= 1) {
      const Seg o = shfl_up(t, d);
      if (lane >= d) t = combine(o, t);
    }
    if (lane < kWarps) warp_total[lane] = t;
  }
  __syncthreads();
  Seg lane_excl = shfl_up(inc, 1);
  if (lane == 0) lane_excl = identity();
  const Seg warp_excl = warp > 0 ? warp_total[warp - 1] : identity();
  *total = warp_total[kWarps - 1];
  __syncthreads();  // warp_total is reused by the next call
  return combine(warp_excl, lane_excl);
}

__global__ void tile_reduce(const uint32_t* __restrict__ key,
                            const uint32_t* __restrict__ key2, int64_t n,
                            int shift, Seg* __restrict__ tile_agg) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  Seg acc = identity();
  for (int j = 0; j < kItems; ++j) {
    if (base + j < n) acc = combine(acc, element(key, key2, base + j, shift));
  }
  Seg total;
  block_exclusive_scan(acc, &total);
  if (threadIdx.x == 0) tile_agg[blockIdx.x] = total;
}

// one block: tile aggregates -> exclusive tile prefixes, in place
__global__ void tile_scan(Seg* __restrict__ tile_agg, int64_t n_tiles) {
  Seg carry = identity();
  for (int64_t b = 0; b < n_tiles; b += kThreads) {
    const int64_t i = b + threadIdx.x;
    const Seg v = i < n_tiles ? tile_agg[i] : identity();
    Seg total;
    const Seg ex = block_exclusive_scan(v, &total);
    if (i < n_tiles) tile_agg[i] = combine(carry, ex);
    carry = combine(carry, total);
  }
}

__global__ void tile_apply(const uint32_t* __restrict__ key,
                           const uint32_t* __restrict__ key2,
                           const int32_t* __restrict__ rid, int64_t n,
                           int shift, int n_reads,
                           const Seg* __restrict__ tile_prefix,
                           int32_t* __restrict__ p2, int32_t* __restrict__ p3) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  Seg local[kItems];
  Seg acc = identity();
  for (int j = 0; j < kItems; ++j) {
    local[j] = base + j < n ? element(key, key2, base + j, shift) : identity();
    acc = combine(acc, local[j]);
  }
  Seg total;
  const Seg ex = block_exclusive_scan(acc, &total);
  Seg run = combine(tile_prefix[blockIdx.x], ex);
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i >= n) break;
    run = combine(run, local[j]);
    const int rank = min(run.rv, 65535);
    const int cand = min(run.cv - 1, 128);
    const int r = min(rid[i], n_reads - 1);
    p2[i] = (r << 16) | rank;
    p3[i] = cand;
  }
}

int scan(const void* skey, const void* skey2, const void* srid, int64_t n,
         int shift, int n_reads, void* tile_scratch, int64_t n_tiles,
         void* p2, void* p3, int device, void* stream) {
  int err = nkm_select_device(device);
  if (err) return err;
  if (n_tiles != (n + kTile - 1) / kTile) return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* key = static_cast<const uint32_t*>(skey);
  const uint32_t* key2 = static_cast<const uint32_t*>(skey2);
  Seg* tiles = static_cast<Seg*>(tile_scratch);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  tile_reduce<<<grid, kThreads, 0, s>>>(key, key2, n, shift, tiles);
  tile_scan<<<1, kThreads, 0, s>>>(tiles, n_tiles);
  tile_apply<<<grid, kThreads, 0, s>>>(
      key, key2, static_cast<const int32_t*>(srid), n, shift, n_reads, tiles,
      static_cast<int32_t*>(p2), static_cast<int32_t*>(p3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile_scratch: 4 * n_tiles int32, n_tiles = ceil(n / 2048)
NKM_EXPORT int nkm_rank_cand_scan(const void* skey, const void* srid,
                                  long long n, int fp_bits, int n_reads,
                                  void* tile_scratch, long long n_tiles,
                                  void* p2, void* p3, int device,
                                  void* stream) {
  return scan(skey, nullptr, srid, n, fp_bits, n_reads, tile_scratch,
              n_tiles, p2, p3, device, stream);
}

// the wide scan: skey2 is the second sort word, row = skey >> row_shift
NKM_EXPORT int nkm_rank_cand_scan_wide(const void* skey, const void* skey2,
                                       const void* srid, long long n,
                                       int row_shift, int n_reads,
                                       void* tile_scratch, long long n_tiles,
                                       void* p2, void* p3, int device,
                                       void* stream) {
  if (skey2 == nullptr) return cudaErrorInvalidValue;
  return scan(skey, skey2, srid, n, row_shift, n_reads, tile_scratch,
              n_tiles, p2, p3, device, stream);
}
