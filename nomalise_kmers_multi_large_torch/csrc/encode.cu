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
// Bound on the H100: memory. Each read's bases are read once and each window
// writes 4 bytes, so at 16384 reads x 150 bp the kernel moves ~2.5 MB in and
// ~9 MB out. Design (csrc/encode_rows.cuh): a block owns whole rows, stages
// their bases with 16-byte loads and packs them into 2-bit words once; a
// window's code is one funnel shift of two packed words and its reverse
// complement a bit reversal, so every window costs the same few dozen
// instructions whatever k is; keys leave as int4 stores. The mix is inlined
// with its shift distances passed from the host.
#include "encode_rows.cuh"

namespace {

using namespace nkm_encode;

constexpr uint32_t kC1 = 0x7FEB352Du;  // ops/mix.py _C1 | 1
constexpr uint32_t kC2 = 0x846CA68Bu;  // ops/mix.py _C2 | 1

__global__ void __launch_bounds__(kThreads)
    encode_keys_kernel(const uint8_t* __restrict__ bases,
                       const int32_t* __restrict__ lengths, int R, int L,
                       int W, int k, bool canonical, uint32_t mask, int s1,
                       int s2, Geometry g, int32_t* __restrict__ keys) {
  __shared__ Shared sh;
  const int n = stage_rows(sh, bases, lengths, R, L, k, g);
  int32_t* const out[1] = {keys};
  write_windows<1>(sh, n, L, W, k, g, out,
                   [&](const uint32_t* row, int w, bool in_len,
                       uint32_t (&v)[1]) {
    uint32_t code = window32(row, w, k);
    if (canonical) {
      const uint32_t rc = revcomp32(code, k);
      if (rc < code) code = rc;
    }
    // ops/mix.py mix32(code, 2k); an xor-shift keeps x below 2^2k, so only
    // the multiplies need the mask
    uint32_t x = code;
    x ^= x >> s1;
    x = (x * kC1) & mask;
    x ^= x >> s2;
    x = (x * kC2) & mask;
    x ^= x >> s1;
    // poly-A windows (code 0) are dropped
    v[0] = in_len && code != 0 ? x : kSentinel;
  });
}

}  // namespace

NKM_EXPORT int nkm_encode_keys(const void* bases, const void* lengths, int R,
                               int L, int k, int canonical, int s1, int s2,
                               void* keys, int device, void* stream) {
  int err = nkm_select_device(device);
  if (err) return err;
  if (k < 1 || k > 15) return cudaErrorInvalidValue;
  const int W = L - k + 1;
  const uint32_t mask = (1u << (2 * k)) - 1u;
  if (R > 0 && W > 0) {
    const Geometry g =
        geometry(R, L, W, resident_blocks(encode_keys_kernel, device));
    encode_keys_kernel<<<g.blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bases),
        static_cast<const int32_t*>(lengths), R, L, W, k, canonical != 0,
        mask, s1, s2, g, static_cast<int32_t*>(keys));
  }
  return static_cast<int>(cudaGetLastError());
}
