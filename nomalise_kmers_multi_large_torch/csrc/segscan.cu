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
// commutative, so every step applies the earlier operand on the left. The
// values may saturate at 65535: min(a + b, 65535) is still associative and
// both outputs clamp at or below it.
//
// Bound on the H100: memory. Each element reads its key and read id (and
// key2 on the wide path) and writes p2 and p3, once: 16 B (narrow) or 20 B
// (wide) per element over 3.35 TB/s.
//
// Design: one pass with decoupled look-back, one launch per call after a
// memset of the tile states and the tile counter (`scan`, below).
//  - One launch, no serial pass: each block owns one tile of kTile
//    elements, taken from a global atomic counter when the block starts (so
//    a block waits only on tiles whose blocks already run). It publishes its
//    tile's aggregate, then its first warp folds the states of the 32
//    preceding tiles at once, right to left, and stops at the first
//    inclusive prefix or as soon as the folded value holds both reset flags
//    (nothing further back can change it). Most tiles hold a row change, so
//    the look-back usually ends at the nearest predecessor.
//  - Every key is read once: the tile's keys are copied to shared memory
//    and each thread takes its predecessor's key from there; only the
//    tile's first element reads key[base - 1] (and key2) from device memory.
//  - Coalesced loads: keys are copied with 16-byte cp.async and read ids
//    loaded as int4, neighbouring threads on neighbouring 16 bytes; shared
//    memory (4 words of padding per 32) turns them into kItems consecutive
//    elements per thread without bank conflicts, and turns the results back
//    for int4 stores of p2 and p3.
//  - A compact carry: inside a tile (values <= kTile) one 32-bit word holds
//    both segmented sums (rank value bits 0..14, flag 15; cand value 16..30,
//    flag 31), one shuffle per scan step; a tile's state is one 64-bit word
//    (rank value bits 0..15, flag 16; cand value 32..47, flag 48; status
//    bits 62..63: invalid, aggregate, inclusive prefix), published with one
//    st.release.gpu and read with one ld.acquire.gpu, so flag, values and
//    status are never torn.
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kItems = 16;  // consecutive elements per thread
constexpr int kTile = kThreads * kItems;  // must match ops/segscan.py _TILE
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kItems / 4;  // int4 groups per thread
constexpr int kPadded = kTile + kTile / 8;
static_assert(kItems % 4 == 0 && kItems <= 32, "items: 4..32, by 4");
static_assert(kWarps >= 1 && kWarps <= 32, "threads: 32..1024, by 32");
static_assert(kTile < 32768, "in-tile values must fit 15 bits");

// tile state
constexpr u64 kRankFlag = 1ull << 16;
constexpr u64 kCandFlag = 1ull << 48;
constexpr u64 kAggregate = 1ull << 62;
constexpr u64 kPrefix = 2ull << 62;
constexpr u64 kStatus = 3ull << 62;

// shared-memory word of tile element i: 4 words of padding after every 32
__device__ __forceinline__ int padded(int i) { return i + ((i >> 5) << 2); }

// in-tile carry: a precedes b
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  const uint32_t lo = (b & 0x8000u) ? (b & 0xFFFFu) : ((a + b) & 0xFFFFu);
  const uint32_t hi = (b & 0x80000000u)
                          ? (b & 0xFFFF0000u)
                          : (a & 0xFFFF0000u) + (b & 0xFFFF0000u);
  return hi | lo;
}

// one half of a tile state (value bits 0..15, flag 16), saturating
__device__ __forceinline__ uint32_t combine_half(uint32_t a, uint32_t b) {
  return (b & 0x10000u) ? b
                        : (a & 0x10000u) |
                              min((a & 0xFFFFu) + (b & 0xFFFFu), 0xFFFFu);
}

// tile states without status: a precedes b
__device__ __forceinline__ u64 combine_state(u64 a, u64 b) {
  return combine_half(a & 0x1FFFFu, b & 0x1FFFFu) |
         static_cast<u64>(combine_half((a >> 32) & 0x1FFFFu,
                                            (b >> 32) & 0x1FFFFu))
             << 32;
}

__device__ __forceinline__ u64 widen(uint32_t c) {
  return (c & 0x7FFFu) | static_cast<u64>((c >> 15) & 1u) << 16 |
         static_cast<u64>((c >> 16) & 0x7FFFu) << 32 |
         static_cast<u64>(c >> 31) << 48;
}

__device__ __forceinline__ void store_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 load_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ int first_lane(unsigned mask) {
  return mask ? __ffs(mask) - 1 : 32;
}

// Run by the tile's first warp: publish the tile's aggregate, fold the
// preceding tiles' states into the exclusive prefix, publish the inclusive
// prefix; returns the exclusive prefix (in every lane).
__device__ u64 look_back(u64* state, unsigned tile, u64 agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_release(state, agg | kPrefix);
    return 0;
  }
  if (lane == 0) store_release(state + tile, agg | kAggregate);
  u64 acc = 0;  // fold of the tiles after the window, up to this one
  for (int64_t pred = static_cast<int64_t>(tile) - 1;; pred -= 32) {
    // lane i holds tile pred - i: higher lanes are earlier in the stream
    const int64_t idx = pred - lane;
    u64 s;
    int stop, need;
    while (true) {
      s = idx >= 0 ? load_acquire(state + idx) : kPrefix;
      const unsigned invalid = __ballot_sync(kFullMask, (s & kStatus) == 0);
      const unsigned prefix =
          __ballot_sync(kFullMask, (s & kStatus) == kPrefix);
      const unsigned rflag = __ballot_sync(kFullMask, (s & kRankFlag) != 0);
      const unsigned cflag = __ballot_sync(kFullMask, (s & kCandFlag) != 0);
      // the fold ends at the first inclusive prefix or where it (with acc)
      // holds both reset flags
      const int rank_at = (acc & kRankFlag) ? 0 : first_lane(rflag);
      const int cand_at = (acc & kCandFlag) ? 0 : first_lane(cflag);
      stop = min(first_lane(prefix), max(rank_at, cand_at));
      need = min(stop + 1, 32);
      const unsigned needed = need == 32 ? kFullMask : (1u << need) - 1;
      if (!(invalid & needed)) break;
      __nanosleep(32);
    }
    u64 v = lane < need ? s & ~kStatus : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const u64 o = __shfl_down_sync(kFullMask, v, d);
      if (lane + d < 32) v = combine_state(o, v);
    }
    acc = combine_state(__shfl_sync(kFullMask, v, 0), acc);
    if (stop < 32) break;
  }
  if (lane == 0) store_release(state + tile, combine_state(acc, agg) | kPrefix);
  return acc;
}

// key2 is null on the narrow path; vec: every pointer is 16-byte aligned
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    rank_cand_kernel(const uint32_t* __restrict__ key,
                     const uint32_t* __restrict__ key2,
                     const int32_t* __restrict__ rid, int64_t n, int shift,
                     int n_reads, u64* __restrict__ state,
                     unsigned* __restrict__ counter, int32_t* __restrict__ p2,
                     int32_t* __restrict__ p3, bool vec) {
  __shared__ __align__(16) uint32_t s_key[kPadded];  // keys, then results
  __shared__ __align__(16) uint32_t s_key2[kWide ? kPadded : 1];
  __shared__ uint32_t s_warp[kWarps];
  __shared__ u64 s_prefix;
  __shared__ unsigned s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  const int64_t base = static_cast<int64_t>(tile) * kTile;

  // keys to shared memory, read ids to registers, all requests in flight
  int4 r[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int q = g * kThreads + tid;  // int4 group of the tile
    const int64_t e = base + 4 * q;
    uint32_t* sk = s_key + padded(4 * q);
    uint32_t* sk2 = s_key2 + (kWide ? padded(4 * q) : 0);
    if (vec && e + 4 <= n) {
      cp_async16(sk, key + e);
      if (kWide) cp_async16(sk2, key2 + e);
      r[g] = *reinterpret_cast<const int4*>(rid + e);
    } else {
      int v[4] = {0, 0, 0, 0};
      for (int c = 0; c < 4; ++c) {
        if (e + c < n) {
          sk[c] = key[e + c];
          if (kWide) sk2[c] = key2[e + c];
          v[c] = rid[e + c];
        }
      }
      r[g] = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
  uint32_t prev = 0, prev2 = 0;
  if (tid == 0 && base > 0) {
    prev = key[base - 1];
    if (kWide) prev2 = key2[base - 1];
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // this thread's elements: code-change and row-change bit masks
  const int first = kItems * tid;
  const int64_t start = base + first;
  const int valid = n - start >= kItems ? kItems
                    : n > start           ? static_cast<int>(n - start)
                                          : 0;
  if (tid > 0) {
    prev = s_key[padded(first - 1)];
    if (kWide) prev2 = s_key2[padded(first - 1)];
  }
  uint32_t ch = 0, rch = 0;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const uint4 k4 = *reinterpret_cast<const uint4*>(
        s_key + padded(first + 4 * i));
    uint4 w4 = make_uint4(0, 0, 0, 0);
    if (kWide)
      w4 = *reinterpret_cast<const uint4*>(s_key2 + padded(first + 4 * i));
    const uint32_t ks[4] = {k4.x, k4.y, k4.z, k4.w};
    const uint32_t ws[4] = {w4.x, w4.y, w4.z, w4.w};
    for (int c = 0; c < 4; ++c) {
      const bool changed = ks[c] != prev || (kWide && ws[c] != prev2);
      const bool rchanged = (ks[c] >> shift) != (prev >> shift);
      ch |= static_cast<uint32_t>(changed) << (4 * i + c);
      rch |= static_cast<uint32_t>(rchanged) << (4 * i + c);
      prev = ks[c];
      prev2 = ws[c];
    }
  }
  if (start == 0) {  // the stream's first element starts a run and a row
    ch |= 1u;
    rch |= 1u;
  }
  const uint32_t live = valid == 32 ? 0xFFFFFFFFu : (1u << valid) - 1;
  ch &= live;
  rch &= live;

  // the thread's aggregate: rank counts from its last code change, cand
  // counts code changes from its last row change
  const uint32_t rank_agg =
      ch ? 0x8000u | (valid - (31 - __clz(ch))) : static_cast<uint32_t>(valid);
  const uint32_t cand_agg =
      rch ? 0x8000u | __popc(ch >> (31 - __clz(rch))) : __popc(ch);
  const uint32_t agg = rank_agg | cand_agg << 16;

  // block scan of the thread aggregates
  uint32_t inc = agg;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(kFullMask, inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  uint32_t lane_excl = __shfl_up_sync(kFullMask, inc, 1);
  if (lane == 0) lane_excl = 0;
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t t = lane < kWarps ? s_warp[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFullMask, t, d);
      if (lane >= d) t = combine(o, t);
    }
    const uint32_t tile_agg = __shfl_sync(kFullMask, t, kWarps - 1);
    uint32_t excl = __shfl_up_sync(kFullMask, t, 1);
    if (lane < kWarps) s_warp[lane] = lane == 0 ? 0 : excl;
    const u64 prefix = look_back(state, tile, widen(tile_agg));
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  // rank and cand of each element, from the tile prefix and the in-tile
  // exclusive prefix; staged in shared memory (rank | cand << 16)
  const uint32_t x = combine(s_warp[warp], lane_excl);
  const u64 pre = s_prefix;
  int rank = (x & 0x8000u) ? (x & 0x7FFF)
                           : static_cast<int>(pre & 0xFFFFu) + (x & 0x7FFF);
  int cand = (x & 0x80000000u)
                 ? ((x >> 16) & 0x7FFF)
                 : static_cast<int>((pre >> 32) & 0xFFFFu) + ((x >> 16) & 0x7FFF);
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    uint32_t o[4];
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * i + c;
      const int cj = (ch >> j) & 1, rj = (rch >> j) & 1;
      rank = cj ? 1 : rank + 1;
      cand = rj ? cj : cand + cj;
      o[c] = static_cast<uint32_t>(min(rank, 65535)) |
             static_cast<uint32_t>(min(cand - 1, 128)) << 16;
    }
    *reinterpret_cast<uint4*>(s_key + padded(first + 4 * i)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();

  // back to int4 groups: p2, p3
  const int hi_rid = n_reads - 1;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int q = g * kThreads + tid;
    const int64_t e = base + 4 * q;
    if (e >= n) break;
    const uint4 w = *reinterpret_cast<const uint4*>(s_key + padded(4 * q));
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    const int rs[4] = {r[g].x, r[g].y, r[g].z, r[g].w};
    int o2[4], o3[4];
    for (int c = 0; c < 4; ++c) {
      o2[c] = min(rs[c], hi_rid) << 16 | static_cast<int>(ws[c] & 0xFFFFu);
      o3[c] = static_cast<int>(ws[c] >> 16);
    }
    if (vec && e + 4 <= n) {
      *reinterpret_cast<int4*>(p2 + e) = make_int4(o2[0], o2[1], o2[2], o2[3]);
      *reinterpret_cast<int4*>(p3 + e) = make_int4(o3[0], o3[1], o3[2], o3[3]);
    } else {
      for (int c = 0; c < 4 && e + c < n; ++c) {
        p2[e + c] = o2[c];
        p3[e + c] = o3[c];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int scan(const void* skey, const void* skey2, const void* srid, int64_t n,
         int shift, int n_reads, void* tile_scratch, int64_t n_tiles,
         void* p2, void* p3, int device, void* stream) {
  int err = nkm_select_device(device);
  if (err) return err;
  if (n_tiles != (n + kTile - 1) / kTile) return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* state = static_cast<u64*>(tile_scratch);
  unsigned* counter = reinterpret_cast<unsigned*>(state + n_tiles);
  err = static_cast<int>(
      cudaMemsetAsync(tile_scratch, 0, (n_tiles + 1) * sizeof(u64), s));
  if (err) return err;
  const bool vec = aligned16(skey) && aligned16(srid) && aligned16(p2) &&
                   aligned16(p3) && (skey2 == nullptr || aligned16(skey2));
  const unsigned grid = static_cast<unsigned>(n_tiles);
  const uint32_t* key = static_cast<const uint32_t*>(skey);
  const uint32_t* key2 = static_cast<const uint32_t*>(skey2);
  const int32_t* rid = static_cast<const int32_t*>(srid);
  int32_t* out2 = static_cast<int32_t*>(p2);
  int32_t* out3 = static_cast<int32_t*>(p3);
  if (key2 != nullptr) {
    rank_cand_kernel<true><<<grid, kThreads, 0, s>>>(
        key, key2, rid, n, shift, n_reads, state, counter, out2, out3, vec);
  } else {
    rank_cand_kernel<false><<<grid, kThreads, 0, s>>>(
        key, nullptr, rid, n, shift, n_reads, state, counter, out2, out3, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile_scratch: n_tiles + 1 zeroed-per-call 64-bit words (the tile states,
// then the tile counter), n_tiles = ceil(n / kTile)
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
  if (skey2 == nullptr && n > 0) return cudaErrorInvalidValue;
  return scan(skey, skey2, srid, n, row_shift, n_reads, tile_scratch,
              n_tiles, p2, p3, device, stream);
}
