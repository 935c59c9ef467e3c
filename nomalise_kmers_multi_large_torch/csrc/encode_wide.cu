// K2: fused wide encode + canonical + Feistel + validity -> sort words
// (k = 16..31).
//
// Replaces nomalise_kmers_multi_large_tpu/ops/encode_kernel.py::
// encode_keys_wide (Pallas `_kernel_wide`, which builds two-word window codes
// from log-doubled lane rolls of a VMEM block of reads, because the TPU has
// no 64-bit integers). Contract: for read r and window w,
//   code = 2k-bit big-endian code of bases[r, w .. w+k-1]
//   with canonical, code = min(code, reverse complement) over all 2k bits
//   (w1, w2) = feistel_words(code, 2k) of ops/mix.py if
//              w <= clip(len[r], 0, 1023) - k and code != 0,
//              else (0xFFFFFFFF, 0xFFFFFFFF) (the sentinel pair)
// A real w2 is < 2^(2k-32) <= 2^30, so w2 != 0xFFFFFFFF is validity.
//
// Bound on the H100: memory. Each read's bases are read once and each window
// writes 8 bytes, so at 16384 reads x 150 bp and k = 25 the kernel moves
// ~2.5 MB in and ~16 MB out. Design (csrc/encode_rows.cuh): a block owns
// whole rows, stages their bases with 16-byte loads and packs them into
// 2-bit words once; a window's code is a funnel shift of three packed words
// into a uint64_t and its reverse complement a 64-bit bit reversal, so
// every window costs the same whatever k is, and the canonical min is one
// 64-bit compare (the TPU's (hi, lo) compare); the three Feistel rounds run
// inline in 32-bit arithmetic; both words leave as int4 stores.
#include "encode_rows.cuh"

namespace {

using namespace nkm_encode;

constexpr uint32_t kC1 = 0x7FEB352Du;  // ops/mix.py _C1 | 1
constexpr uint32_t kC2 = 0x846CA68Bu;  // ops/mix.py _C2 | 1
constexpr uint32_t kCA = 0x243F6A88u;  // ops/mix.py Feistel round keys
constexpr uint32_t kCB = 0x85A308D3u;
constexpr uint32_t kCC = 0x13198A2Eu;
constexpr uint32_t kM31 = 0x7FFFFFFFu;

// ops/mix.py mix32(x, 32)
__device__ __forceinline__ uint32_t mix32_full(uint32_t x) {
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
    encode_keys_wide_kernel(const uint8_t* __restrict__ bases,
                            const int32_t* __restrict__ lengths, int R,
                            int L, int W, int k, bool canonical, Geometry g,
                            int32_t* __restrict__ w1_out,
                            int32_t* __restrict__ w2_out) {
  __shared__ Shared sh;
  const int n = stage_rows(sh, bases, lengths, R, L, k, g);
  int32_t* const out[2] = {w1_out, w2_out};
  const int nb = 2 * k;
  write_windows<2>(sh, n, L, W, k, g, out,
                   [&](const uint32_t* row, int w, bool in_len,
                       uint32_t (&v)[2]) {
    uint64_t code = window64(row, w, k);
    if (canonical) {
      const uint64_t rc = revcomp64(code, k);
      if (rc < code) code = rc;
    }
    uint32_t w1, w2;
    if (nb == 32) {  // k = 16: the code fits one word; w2 = 0
      w1 = mix32_full(static_cast<uint32_t>(code));
      w2 = 0;
    } else {
      const uint32_t m_l = (1u << (nb - 31)) - 1u;
      uint32_t right = static_cast<uint32_t>(code >> (nb - 31)) & kM31;
      uint32_t left = static_cast<uint32_t>(code) & m_l;
      right ^= mix32_full(left ^ kCA) & kM31;
      left ^= mix32_full(right ^ kCB) & m_l;
      right ^= mix32_full(left ^ kCC) & kM31;
      w1 = (right << 1) | (left >> (nb - 32));
      w2 = left & ((1u << (nb - 32)) - 1u);
    }
    // poly-A windows (code 0) are dropped
    const bool valid = in_len && code != 0;
    v[0] = valid ? w1 : kSentinel;
    v[1] = valid ? w2 : kSentinel;
  });
}

}  // namespace

NKM_EXPORT int nkm_encode_keys_wide(const void* bases, const void* lengths,
                                    int R, int L, int k, int canonical,
                                    void* w1, void* w2, int device,
                                    void* stream) {
  int err = nkm_select_device(device);
  if (err) return err;
  if (k < 16 || k > 31) return cudaErrorInvalidValue;
  const int W = L - k + 1;
  if (R > 0 && W > 0) {
    const Geometry g =
        geometry(R, L, W, resident_blocks(encode_keys_wide_kernel, device));
    encode_keys_wide_kernel<<<g.blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bases),
        static_cast<const int32_t*>(lengths), R, L, W, k, canonical != 0, g,
        static_cast<int32_t*>(w1), static_cast<int32_t*>(w2));
  }
  return static_cast<int>(cudaGetLastError());
}
