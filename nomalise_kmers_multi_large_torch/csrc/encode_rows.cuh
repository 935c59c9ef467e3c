// The block design shared by K1 (csrc/encode.cu) and K2 (csrc/encode_wide.cu):
// a block owns a range of whole rows (reads), stages their bases in shared
// memory, packs them into 2-bit words once, and then spends a constant
// number of instructions on every window, whatever k is.
//
//  1. Rows per block (geometry, on the host) follow from W, so that a block
//     owns about kWindows windows (8 KB of keys on K1, 16 KB on K2), and
//     from R, so that the grid fits the card in one wave where the stage
//     allows (no tail of a few blocks after the first wave). A row is never
//     split across blocks, so the block's keys are one contiguous span of
//     the output.
//  2. Staging: a window past clip(len, 0, 1023) - k is a sentinel whatever
//     its bases are, so only the first Lc = min(L, 1023) bases of a row can
//     matter. The block copies the byte span that holds them, rows r0 ..
//     r0 + n - 1 (n * L bytes when L <= 1023; one row's first 1023 bytes
//     otherwise), with 16-byte loads over its 16-byte-aligned interior and
//     byte loads at the two edges: `bases` may start on any byte.
//  3. Packing: word j of a row holds bases 16j .. 16j + 15, first base in
//     the high bits (the order of the window code), bases past Lc as 0;
//     each row has kGuardWords zero words after its data.
//  4. Per window: the code is a funnel shift of two packed words (K1,
//     2k <= 30) or three (K2, 2k <= 62), the reverse complement a bit
//     reversal of the complemented code with its bit pairs swapped back and
//     one shift (revcomp32 / revcomp64).
//  5. Stores: the block's span is cut into groups of 4 keys aligned to 16
//     bytes of the output, one group per thread and step, so consecutive
//     threads write consecutive int4; the partial groups at the span's two
//     edges take scalar stores. A group's first window finds its row with a
//     multiply-high by the reciprocal of W computed once on the host (no
//     division per window); the next three step along the row.
#pragma once

#include "common.cuh"

namespace nkm_encode {

constexpr int kThreads = 256;
constexpr int kWindows = 2048;  // windows a block aims to own
constexpr int kMaxRows = 256;   // rows a block may own
constexpr int kMaxLen = 1023;   // bases past it never reach a valid window
// staged bases of a block, at most: rows of ~kWindows windows, or one row
// of kMaxLen bases
constexpr int kStageBytes = 2 * kWindows > 1024 ? 2 * kWindows : 1024;
constexpr int kGuardWords = 2;  // zero words after a row's packed bases
// packed words of a block: n * (ceil(Lc / 16) + kGuardWords) with n * Lc <=
// kStageBytes, or one row of Lc = kMaxLen
constexpr int kWords = kStageBytes / 16 + (kGuardWords + 1) * kMaxRows;
static_assert(kMaxLen <= kStageBytes, "one row must fit the stage");

// p / d for p < 2^31 from m = 0xFFFFFFFF / d: the multiply-high is at most
// one below the quotient.
__device__ __forceinline__ int quot(int p, int d, uint32_t m) {
  int q = static_cast<int>(__umulhi(static_cast<uint32_t>(p), m));
  if (p - q * d >= d) ++q;
  return q;
}

// Launch shape of a call, computed once on the host.
struct Geometry {
  int rows;        // rows per block
  uint32_t w_div;  // 0xFFFFFFFF / W
  int nw;          // packed words per row, guard words included
  uint32_t nw_div;  // 0xFFFFFFFF / nw
  unsigned blocks;
};

// Blocks of `kernel` that the card holds at once (SMs x blocks per SM),
// asked once per device.
template <class Kernel>
inline int resident_blocks(Kernel kernel, int device) {
  static int cache[64];
  if (device < 0 || device >= 64) return 0;
  if (cache[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    cache[device] = sms * per_sm;
  }
  return cache[device];
}

// resident: resident_blocks of the kernel (0: unknown)
inline Geometry geometry(int R, int L, int W, int resident) {
  Geometry g;
  const int lc = L < kMaxLen ? L : kMaxLen;
  int rows = 1;
  if (L <= kMaxLen) {  // else one row a block: the stage holds Lc bases
    rows = kWindows / W;
    if (resident > 0 && rows < (R + resident - 1) / resident)
      rows = (R + resident - 1) / resident;  // one wave
    if (rows > kStageBytes / L) rows = kStageBytes / L;
    if (rows > kMaxRows) rows = kMaxRows;
    if (rows < 1) rows = 1;
  }
  g.rows = rows;
  g.w_div = 0xFFFFFFFFu / static_cast<uint32_t>(W);
  g.nw = (lc + 15) / 16 + kGuardWords;
  g.nw_div = 0xFFFFFFFFu / static_cast<uint32_t>(g.nw);
  g.blocks = static_cast<unsigned>((R + rows - 1) / rows);
  return g;
}

struct Shared {
  alignas(16) uint8_t bytes[kStageBytes + 16];
  uint32_t words[kWords];
  int lim[kMaxRows];  // last valid window of each row (clip(len) - k)
};

// The block's rows, staged and packed (ends with __syncthreads). Returns n,
// the number of rows the block owns.
__device__ __forceinline__ int stage_rows(Shared& sh,
                                          const uint8_t* __restrict__ bases,
                                          const int32_t* __restrict__ lengths,
                                          int R, int L, int k,
                                          const Geometry& g) {
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * g.rows;
  const int n = min(g.rows, R - r0);
  const int lc = min(L, kMaxLen);
  const uint8_t* start = bases + static_cast<int64_t>(r0) * L;
  const uint8_t* end = start + static_cast<int64_t>(n - 1) * L + lc;
  // the span starts `head` bytes past a 16-byte boundary; shared memory
  // holds it at the same offset, so the 16-byte loads land aligned there
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(start) & 15);
  // [start, mid) and [tail, end) by bytes, [mid, tail) by 16-byte loads
  const uint8_t* mid = head ? start + (16 - head) : start;
  if (mid > end) mid = end;
  const uint8_t* tail = end - (reinterpret_cast<uintptr_t>(end) & 15);
  if (tail < mid) tail = mid;
  const int n_vec = static_cast<int>((tail - mid) / 16);
  const int4* src = reinterpret_cast<const int4*>(mid);
  int4* dst = reinterpret_cast<int4*>(sh.bytes + (mid - start) + head);
  for (int i = tid; i < n_vec; i += kThreads) dst[i] = __ldg(src + i);
  const int n_head = static_cast<int>(mid - start);
  const int n_tail = static_cast<int>(end - tail);
  if (tid < n_head) sh.bytes[head + tid] = start[tid];
  if (tid < n_tail) sh.bytes[head + (tail - start) + tid] = tail[tid];
  for (int i = tid; i < n; i += kThreads)
    sh.lim[i] = min(max(lengths[r0 + i], 0), kMaxLen) - k;
  __syncthreads();

  for (int idx = tid; idx < n * g.nw; idx += kThreads) {
    const int i = quot(idx, g.nw, g.nw_div);
    const int b0 = 16 * (idx - i * g.nw);
    const int cnt = min(max(lc - b0, 0), 16);
    const uint8_t* s = sh.bytes + head + i * L + b0;
    uint32_t word = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (t < cnt) word |= (s[t] & 3u) << (30 - 2 * t);
    sh.words[idx] = word;
  }
  __syncthreads();
  return n;
}

// 2k-bit code of the window at base w of a packed row (2k <= 30).
__device__ __forceinline__ uint32_t window32(const uint32_t* row, int w,
                                             int k) {
  const uint32_t* p = row + (w >> 4);
  return __funnelshift_l(p[1], p[0], 2 * (w & 15)) >> (32 - 2 * k);
}

// 2k-bit code of the window at base w of a packed row (2k <= 62).
__device__ __forceinline__ uint64_t window64(const uint32_t* row, int w,
                                             int k) {
  const uint32_t* p = row + (w >> 4);
  const int s = 2 * (w & 15);
  const uint64_t hi = __funnelshift_l(p[1], p[0], s);
  const uint64_t lo = __funnelshift_l(p[2], p[1], s);
  return ((hi << 32) | lo) >> (64 - 2 * k);
}

// Reverse complement of a 2k-bit code: complement, reverse the bits (which
// reverses the bases and swaps the two bits of each), swap the bits of each
// pair back, drop the 32 - 2k (64 - 2k) low bits, which held the complement
// of the zero bits above the code.
__device__ __forceinline__ uint32_t revcomp32(uint32_t code, int k) {
  uint32_t x = __brev(~code);
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  return x >> (32 - 2 * k);
}

__device__ __forceinline__ uint64_t revcomp64(uint64_t code, int k) {
  uint64_t x = __brevll(~code);
  x = ((x >> 1) & 0x5555555555555555ull) |
      ((x & 0x5555555555555555ull) << 1);
  return x >> (64 - 2 * k);
}

// Every window of the block's rows: key(row words, w, in_len, v) fills v[o]
// for each of the kOut outputs, stored at out[o][r * W + w]; in_len says
// whether w <= clip(len, 0, 1023) - k. A window past Lc - k (only where
// L > 1023) is out of length and is read at Lc - k, inside the packed row.
// An output whose address is not 16-byte aligned to out[0]'s takes scalar
// stores.
template <int kOut, class Key>
__device__ __forceinline__ void write_windows(const Shared& sh, int n, int L,
                                              int W, int k, const Geometry& g,
                                              int32_t* const (&out)[kOut],
                                              Key key) {
  const int wmax = min(L, kMaxLen) - k;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * g.rows * W;
  const int span = n * W;
  // the span starts `lead` keys past a 16-byte boundary of out[0]
  const int lead =
      static_cast<int>((reinterpret_cast<uintptr_t>(out[0] + e0) >> 2) & 3);
  bool vec[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o)
    vec[o] = ((reinterpret_cast<uintptr_t>(out[o]) -
               reinterpret_cast<uintptr_t>(out[0])) & 15) == 0;
  const int groups = (lead + span + 3) >> 2;
  // the outputs of window w of row i
  auto at = [&](int i, int w, uint32_t(&kv)[kOut]) {
    key(sh.words + i * g.nw, min(w, wmax), w <= sh.lim[i], kv);
  };
  for (int grp = threadIdx.x; grp < groups; grp += kThreads) {
    const int p0 = 4 * grp - lead;  // the group's first key in the span
    const int p = max(p0, 0);
    int i = quot(p, W, g.w_div);
    int w = p - i * W;
    if (p0 >= 0 && p0 + 4 <= span) {  // a whole group: one int4 per output
      uint32_t v[kOut][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kv[kOut];
        at(i, w, kv);
#pragma unroll
        for (int o = 0; o < kOut; ++o) v[o][j] = kv[o];
        if (++w == W) {
          w = 0;
          ++i;
        }
      }
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        int32_t* dst = out[o] + e0 + p0;
        if (vec[o]) {
          *reinterpret_cast<int4*>(dst) = make_int4(
              static_cast<int>(v[o][0]), static_cast<int>(v[o][1]),
              static_cast<int>(v[o][2]), static_cast<int>(v[o][3]));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) dst[j] = static_cast<int32_t>(v[o][j]);
        }
      }
      continue;
    }
    // a group at an edge of the span: its keys inside the span, one by one
    for (int j = max(-p0, 0); j < 4 && p0 + j < span; ++j) {
      uint32_t kv[kOut];
      at(i, w, kv);
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        out[o][e0 + p0 + j] = static_cast<int32_t>(kv[o]);
      if (++w == W) {
        w = 0;
        ++i;
      }
    }
  }
}

}  // namespace nkm_encode
