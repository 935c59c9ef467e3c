// K1: fused encode + canonical + mix + validity -> sort keys (k <= 15).
//
// Replaces nomalise_kmers_multi_large_tpu/ops/encode_kernel.py::encode_keys
// (Pallas `_kernel`, which builds window codes from log-doubled lane rolls of
// a VMEM block of reads). Contract: for read r and window w,
//   code = 2k-bit big-endian code of bases[r, w .. w+k-1]
//   with canonical, code = min(code, reverse complement)
//   key  = mix32(code, 2k) if w <= clip(len[r], 0, 1023) - k and code != 0
//          else 0xFFFFFFFF (the sentinel: int32 -1)
//
// Bound on the H100: memory. Each window reads k bytes and writes 4, so at
// 16384 reads x 150 bp the kernel moves ~2.5 MB in and ~9 MB out; the k-fold
// re-read of bases hits L1 because neighbouring threads take neighbouring
// windows of one read. Design: one thread per (read, window), coalesced
// int32 stores, the mix inlined with its shift distances passed from the
// host. No shared memory: the rolls the TPU kernel needed are plain indexed
// byte loads here.
#include "common.cuh"

namespace {

constexpr uint32_t kC1 = 0x7FEB352Du;  // ops/mix.py _C1 | 1
constexpr uint32_t kC2 = 0x846CA68Bu;  // ops/mix.py _C2 | 1

__global__ void encode_keys_kernel(const uint8_t* __restrict__ bases,
                                   const int32_t* __restrict__ lengths,
                                   int R, int L, int W, int k, bool canonical,
                                   uint32_t mask, int s1, int s2,
                                   int32_t* __restrict__ keys) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(R) * W) return;
  const int r = static_cast<int>(t / W);
  const int w = static_cast<int>(t - static_cast<int64_t>(r) * W);
  const int len = min(max(lengths[r], 0), 1023);
  const uint8_t* b = bases + static_cast<int64_t>(r) * L + w;
  uint32_t code = 0, rc = 0;
  for (int j = 0; j < k; ++j) {
    const uint32_t x = b[j];
    code = (code << 2) | x;
    rc |= (x ^ 3u) << (2 * j);
  }
  if (canonical && rc < code) code = rc;
  int32_t key = -1;
  if (w <= len - k && code != 0) {  // poly-A windows (code 0) are dropped
    uint32_t x = code;
    x = (x ^ (x >> s1)) & mask;
    x = (x * kC1) & mask;
    x = (x ^ (x >> s2)) & mask;
    x = (x * kC2) & mask;
    x = (x ^ (x >> s1)) & mask;
    key = static_cast<int32_t>(x);
  }
  keys[t] = key;
}

}  // namespace

NKM_EXPORT int nkm_encode_keys(const void* bases, const void* lengths, int R,
                               int L, int k, int canonical, int s1, int s2,
                               void* keys, int device, void* stream) {
  int err = nkm_select_device(device);
  if (err) return err;
  const int W = L - k + 1;
  const int64_t n = static_cast<int64_t>(R) * W;
  const uint32_t mask = (1u << (2 * k)) - 1u;
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    encode_keys_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bases),
        static_cast<const int32_t*>(lengths), R, L, W, k, canonical != 0,
        mask, s1, s2, static_cast<int32_t*>(keys));
  }
  return static_cast<int>(cudaGetLastError());
}
