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
// Bound on the H100: memory. Each window reads k bytes and writes 8, so at
// 16384 reads x 150 bp and k = 25 the kernel moves ~2.5 MB in and ~16 MB
// out; the k-fold re-read of bases hits L1 because neighbouring threads take
// neighbouring windows of one read. Design: one thread per (read, window);
// the code is built in a uint64_t, so the canonical min is one 64-bit
// compare (the TPU's (hi, lo) compare); the three Feistel rounds run inline
// in 32-bit arithmetic; two coalesced int32 stores.
#include "common.cuh"

namespace {

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

__global__ void encode_keys_wide_kernel(const uint8_t* __restrict__ bases,
                                        const int32_t* __restrict__ lengths,
                                        int R, int L, int W, int k,
                                        bool canonical,
                                        int32_t* __restrict__ w1_out,
                                        int32_t* __restrict__ w2_out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(R) * W) return;
  const int r = static_cast<int>(t / W);
  const int w = static_cast<int>(t - static_cast<int64_t>(r) * W);
  const int len = min(max(lengths[r], 0), 1023);
  const uint8_t* b = bases + static_cast<int64_t>(r) * L + w;
  uint64_t code = 0, rc = 0;
  for (int j = 0; j < k; ++j) {
    const uint64_t x = b[j];
    code = (code << 2) | x;
    rc |= (x ^ 3u) << (2 * j);
  }
  if (canonical && rc < code) code = rc;
  uint32_t w1 = kSentinel, w2 = kSentinel;
  if (w <= len - k && code != 0) {  // poly-A windows (code 0) are dropped
    const int nb = 2 * k;
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
  }
  w1_out[t] = static_cast<int32_t>(w1);
  w2_out[t] = static_cast<int32_t>(w2);
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
  const int64_t n = static_cast<int64_t>(R) * W;
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    encode_keys_wide_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bases),
        static_cast<const int32_t*>(lengths), R, L, W, k, canonical != 0,
        static_cast<int32_t*>(w1), static_cast<int32_t*>(w2));
  }
  return static_cast<int>(cudaGetLastError());
}
