// The warp routine shared by K4 (csrc/bucket.cu) and K5 (csrc/bucket_wide.cu):
// upsert + classify one 32-element slice of a sorted stream into a bucket
// table whose rows are left-packed (the occupied lanes of a row are a
// prefix; an empty slot holds fingerprint 0 and count 0).
//
// A stream type S says how an element reads: S::load(i) gives its two sort
// words (a, b), S::valid(a, b) whether it is a real window, S::row(a) its
// bucket row, S::fa(a) / S::fb(b) its fingerprints in plane A / plane B.
// Planes: fpa and counts, and fpb (nullptr where the table has no plane B).
//
// Ownership: a row belongs to the warp whose slice holds the row's first
// element, so no two warps touch one row and no atomics touch the table.
// The warp walks its rows' elements in groups of 32: group 0 is its own
// slice (elements before its first row start belong to an earlier warp), and
// groups 1, 2, ... hold the rest of its last row, which runs on past the
// slice. The first spill group is loaded with the slice, so a row that ends
// in the next slice costs no extra round trip.
//
// Memory (the bound): per warp, the stream words of two slices; lanes 0..31
// of plane A (and B) of each owned row, as one cp.async batch into a
// shared-memory ring, so the warp waits on ONE round trip for all its rows;
// lanes 32.. only for rows whose first 32 lanes are all occupied; the count
// of each matched code; stores only of inserted fingerprints and of the
// counts that change.
#pragma once

#include "common.cuh"

namespace nkm_bucket {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLanes = 128;
// ring row stride: 33 words, so threads reading lane j of 32 different rows
// hit 32 different banks
constexpr int kRingStride = 33;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A tag per element for __match_any_sync: equal for equal codes; an inactive
// lane tags itself with its lane number over a low word no real element has
// (the b word of a real element is never 0xFFFFFFFF).
__device__ __forceinline__ unsigned long long code_tag(bool active, uint32_t a,
                                                       uint32_t b, int lane) {
  return active ? (static_cast<unsigned long long>(a) << 32) | b
                : (static_cast<unsigned long long>(lane) << 32) | kSentinel;
}

template <class S>
__device__ __forceinline__ void upsert_slice(
    const S& s, const int32_t* __restrict__ p2, const int32_t* __restrict__ p3,
    int64_t n, int32_t* __restrict__ fpa, int32_t* __restrict__ fpb,
    int32_t* __restrict__ counts, int lanes, int depth, bool seed,
    int32_t* __restrict__ high, int n_reads, int32_t* __restrict__ stats,
    int32_t (*ring_a)[kRingStride], int32_t (*ring_b)[kRingStride]) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const unsigned le_mask = lt_mask | (1u << lane);
  const bool has_b = fpb != nullptr;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
      32;
  if (base >= n) return;  // uniform per warp

  // this slice, the next one (the likely spill of the last row) and the
  // predecessor of the slice, all loads issued before any is used
  const int64_t e = base + lane;
  uint32_t a, b, na, nb;
  s.load(e, n, a, b);
  s.load(e + 32, n, na, nb);
  int32_t q = e < n ? p2[e] : 0, c = e < n ? p3[e] : 0;
  const int32_t nq = e + 32 < n ? p2[e + 32] : 0;
  const int32_t nc = e + 32 < n ? p3[e + 32] : 0;
  uint32_t pa = 0, pb = 0;
  if (lane == 0 && base > 0) s.load(base - 1, n, pa, pb);

  // rows whose first element lies in this slice; valid elements sort before
  // every invalid one, so a valid element's predecessor is valid
  const uint32_t prev = __shfl_up_sync(kFullMask, a, 1);
  const bool valid0 = s.valid(a, b);
  const bool start =
      valid0 && (e == 0 || s.row(lane == 0 ? pa : prev) != s.row(a));
  const unsigned starts = __ballot_sync(kFullMask, start);
  if (starts == 0) return;  // the slice lies inside an earlier warp's row
  const int n_rows = __popc(starts);

  // lanes 0..31 of each owned row into the ring, one cp.async batch; ring
  // slot i holds the i-th row start of the slice, and thread i keeps its row
  uint32_t ring_row = 0;
  {
    unsigned m = starts;
    for (int i = 0; m; ++i) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const uint32_t r = __shfl_sync(kFullMask, s.row(a), src);
      if (lane == i) ring_row = r;
      const int64_t off = static_cast<int64_t>(r) * lanes + lane;
      cp_async4(&ring_a[i][lane], fpa + off);
      if (has_b) cp_async4(&ring_b[i][lane], fpb + off);
    }
    cp_async_wait_all();
    __syncwarp();
  }

  // pre-batch occupancy of each ring row (thread i keeps row i's); the rest
  // of a row is read only when its first 32 lanes are all occupied
  int ring_occ = 0;
  for (int i = 0; i < n_rows; ++i) {
    int occ = __popc(__ballot_sync(kFullMask, ring_a[i][lane] != 0));
    if (occ == 32 && lanes > 32) {
      const int64_t off =
          static_cast<int64_t>(__shfl_sync(kFullMask, ring_row, i)) * lanes;
      for (int j = 32; j < lanes; j += 32) {
        const int got =
            __popc(__ballot_sync(kFullMask, fpa[off + j + lane] != 0));
        occ += got;
        if (got < 32) break;
      }
    }
    if (lane == i) ring_occ = occ;
  }

  const int first_start = __ffs(starts) - 1;
  const int last_start = 31 - __clz(starts);
  const uint32_t last_row = __shfl_sync(kFullMask, ring_row, n_rows - 1);
  // the last row's next insert lane, carried from group to group
  int last_next = __shfl_sync(kFullMask, ring_occ, n_rows - 1);
  // the code of the previous group's lane 31, which may continue
  unsigned long long carry_tag = ~0ull;  // no real tag has low word ~0
  int carry_target = -1, carry_prior = 0, carry_cum = 0;
  int n_inserted = 0, n_dropped = 0;

  for (int g = 0;; ++g) {
    if (g == 1) {
      a = na;
      b = nb;
      q = nq;
      c = nc;
    } else if (g > 1) {  // a row longer than the spill group: load on
      const int64_t i = base + 32 * g + lane;
      s.load(i, n, a, b);
      q = i < n ? p2[i] : 0;
      c = i < n ? p3[i] : 0;
    }
    const bool valid = s.valid(a, b);
    bool active;
    int slot, my_start;
    if (g == 0) {
      active = valid && lane >= first_start;
      slot = __popc(starts & le_mask) - 1;
      my_start = active ? 31 - __clz(starts & le_mask) : 0;
    } else {
      active = valid && s.row(a) == last_row;
      slot = n_rows - 1;
      my_start = 0;
    }
    const unsigned act = __ballot_sync(kFullMask, active);
    if (act == 0) break;
    const int occ = __shfl_sync(kFullMask, ring_occ, slot < 0 ? 0 : slot);
    const int64_t row_off = static_cast<int64_t>(s.row(a)) * lanes;
    const int32_t fa = s.fa(a);
    const int32_t fb = has_b ? s.fb(b) : 0;
    const unsigned long long tag = code_tag(active, a, b, lane);
    const bool cont = active && tag == carry_tag;

    // match against the row as it was before the batch: the ring, then, for
    // a row fuller than 32 lanes, the rest in device memory (never written
    // by this batch: inserts land at lanes >= occ)
    int matched = -1;
    if (active && !cont) {
      const int top = occ < 32 ? occ : 32;
      for (int j = 0; j < top; ++j) {
        if (ring_a[slot][j] == fa && (!has_b || ring_b[slot][j] == fb)) {
          matched = j;
          break;
        }
      }
      for (int j = 32; matched < 0 && j < occ; ++j) {
        if (fpa[row_off + j] == fa && (!has_b || fpb[row_off + j] == fb)) {
          matched = j;
        }
      }
    }

    // inserts, in stream order: the rank-1 occurrence of an unmatched code
    // takes lane occ + the inserts of its row before it
    const int rank = q & 0xFFFF;
    const uint32_t rid = static_cast<uint32_t>(q) >> 16;
    const bool head_new = active && !cont && matched < 0 && rank == 1;
    const bool inserting = head_new && c < lanes;
    const unsigned ins = __ballot_sync(kFullMask, inserting);
    const int lane_base = g == 0 ? occ : last_next;
    const int my_lane =
        inserting ? lane_base +
                        __popc(ins & lt_mask & ~((1u << my_start) - 1u))
                  : -1;
    const bool fits = inserting && my_lane < lanes;
    n_inserted += __popc(__ballot_sync(kFullMask, fits));
    n_dropped += __popc(__ballot_sync(kFullMask, head_new && !fits));
    if (fits) {
      fpa[row_off + my_lane] = fa;
      if (has_b) fpb[row_off + my_lane] = fb;
    }
    if (g == 0) {
      last_next = __shfl_sync(kFullMask, ring_occ, n_rows - 1) +
                  __popc(ins >> last_start);
    } else {
      last_next += __popc(ins);
    }

    // each code's lane: the carried one, its pre-batch lane, or the lane its
    // first occurrence (the lowest thread of equal tags) inserted at
    const unsigned peers = __match_any_sync(kFullMask, tag);
    const int leader = __ffs(peers) - 1;
    const int head_lane =
        __shfl_sync(kFullMask, fits ? my_lane : -1, leader);
    const int target = cont ? carry_target : matched >= 0 ? matched : head_lane;
    const int cum = __popc(peers) + (cont ? carry_cum : 0);
    int prior = 0;
    if (!seed) {
      // the pre-batch count, read once per code, by its leader
      int p = 0;
      if (lane == leader && active && !cont && matched >= 0) {
        p = counts[row_off + matched];
      }
      const int leader_prior = __shfl_sync(kFullMask, p, leader);
      prior = cont ? carry_prior : leader_prior;
      if (active && static_cast<int64_t>(prior) + rank >= depth &&
          rid < static_cast<uint32_t>(n_reads)) {
        atomicAdd(&high[rid], 1);
      }
      if (active && lane == leader && target >= 0) {
        counts[row_off + target] = prior + cum;
      }
    }

    carry_tag = __shfl_sync(kFullMask, tag, 31);
    carry_target = __shfl_sync(kFullMask, target, 31);
    carry_prior = __shfl_sync(kFullMask, prior, 31);
    carry_cum = __shfl_sync(kFullMask, cum, 31);
    if (!(act >> 31)) break;  // the last row ends inside this group
    __syncwarp();  // this group's count stores before the next group's
  }
  if (lane == 0) {
    if (n_dropped) atomicAdd(&stats[0], n_dropped);
    if (n_inserted) atomicAdd(&stats[1], n_inserted);
  }
}

}  // namespace nkm_bucket
