// Hashed-table find-or-insert, with the count update fused in.
//
// Replaces no Pallas kernel: it replaces the XLA while_loop `_insert` of
// nomalise_kmers_multi_large_tpu/table/hashed.py:57-107 and the count gather
// and scatter after it (:140-149). There each probe round claims empty slots
// by scattering a ticket per code ("duplicate scatter indices leave exactly
// one writer") and tests `any(pending)` on the device. Eager PyTorch would
// pay a host sync per round and has no such scatter guarantee; one 64-bit
// atomicCAS per probe does the whole protocol in one launch, with no sync.
//
// Contract. keys: int64 [C] (C a power of two), a code per slot, 0 = empty.
// codes: int64 [n]; 0 means "not a code" (code 0, poly-A, is never counted,
// so the caller zeroes every slot of the stream but its run heads). The
// codes that are not 0 are distinct. For each such code, with the slot hash
// h = fmix32(lo ^ fmix32(hi ^ 0x9E3779B9)) of the JAX table, probe round r
// (0..63) tries slot (h + r(r+1)/2) & (C - 1): a slot that holds the code
// matches; an empty slot is claimed with atomicCAS (old 0: this thread won,
// stats[0] += 1); another code goes on to round r + 1. A code unresolved
// after 64 rounds adds 1 to stats[1] and gets slot -1, prior 0, and no
// count. With `counts`, a resolved code reads prior = counts[slot] and, with
// `mult`, writes counts[slot] = prior + mult[i]: distinct codes own distinct
// slots, so no other thread touches that count. stats[2] counts the probes.
// Every output pointer but stats may be null; slot and prior are written for
// every i < n (-1 and 0 where codes[i] is 0).
//
// Bound on the H100: memory latency, not bandwidth. Per run head: one random
// 32-byte sector per probe of `keys` (~1.2 probes a head below half load),
// one for its count (read, then written), plus 8 B of code in, 4 B of mult
// in and 8 B of slot and prior out for every stream element. A 150 bp batch
// of 16384 reads has ~2.2M elements and ~1.5M heads: ~40 MB of sectors and
// ~45 MB streamed, ~0.03 ms at 3.35 TB/s. What costs is that each probe is a
// dependent round trip to a random place in a table of up to 12 GiB. Design:
// one thread per stream element (most exit at once), a plain load
// (ld.global.cg, not cached in L1) of the slot before any CAS, since a slot
// never changes once it holds a code; the CAS only where that load read 0.
// Stats are summed by warp ballots and shuffles, then across the block in
// shared memory, and added with one atomic per block and stat: atomics on
// the same three words from every warp (64k warps a batch) serialise in L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxProbe = 64;  // table/hashed.py _MAX_PROBE

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
    hashed_insert_kernel(const unsigned long long* __restrict__ codes,
                         int64_t n, unsigned long long* keys, uint32_t mask,
                         const int32_t* __restrict__ mult,
                         int32_t* __restrict__ counts,
                         int32_t* __restrict__ slot_out,
                         int32_t* __restrict__ prior_out,
                         unsigned long long* __restrict__ stats) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  bool is_new = false, is_over = false;
  unsigned probes = 0;
  if (i < n) {
    const unsigned long long code = codes[i];
    int32_t slot = -1, prior = 0;
    if (code != 0) {
      const uint32_t hi = static_cast<uint32_t>(code >> 32);
      const uint32_t lo = static_cast<uint32_t>(code);
      const uint32_t h = fmix32(lo ^ fmix32(hi ^ 0x9E3779B9u));
      for (unsigned r = 0; r < kMaxProbe; ++r) {
        const uint32_t cand = (h + r * (r + 1) / 2) & mask;
        ++probes;
        unsigned long long cur = __ldcg(keys + cand);
        if (cur == 0) cur = atomicCAS(keys + cand, 0ull, code);
        if (cur == 0 || cur == code) {
          is_new = cur == 0;
          slot = static_cast<int32_t>(cand);
          break;
        }
      }
      is_over = slot < 0;
      if (slot >= 0 && counts != nullptr) {
        prior = counts[slot];
        if (mult != nullptr) counts[slot] = prior + mult[i];
      }
    }
    if (slot_out != nullptr) slot_out[i] = slot;
    if (prior_out != nullptr) prior_out[i] = prior;
  }
  // every thread reaches the ballots and the barrier: none returned early
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned part[3][kWarps];
  unsigned pr = probes;
  for (int off = 16; off > 0; off >>= 1) {
    pr += __shfl_down_sync(kFullMask, pr, off);
  }
  const unsigned nb = __popc(__ballot_sync(kFullMask, is_new));
  const unsigned ob = __popc(__ballot_sync(kFullMask, is_over));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = nb;
    part[1][warp] = ob;
    part[2][warp] = pr;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += part[threadIdx.x][w];
    if (sum) atomicAdd(stats + threadIdx.x, sum);
  }
}

}  // namespace

// codes: int64 [n]; keys: int64 [capacity], updated in place; mult: int32
// [n] or null; counts: int32 [capacity] or null, updated in place when mult
// is given; slot, prior: int32 [n] or null; stats: int64 [3] (new, unresolved,
// probes), zeroed by the caller.
NKM_EXPORT int nkm_hashed_insert(const void* codes, long long n, void* keys,
                                 long long capacity, const void* mult,
                                 void* counts, void* slot, void* prior,
                                 void* stats, int device, void* stream) {
  int err = nkm_select_device(device);
  if (err) return err;
  if (capacity < 2 || (capacity & (capacity - 1)) != 0 ||
      capacity > (1ll << 31)) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    hashed_insert_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(codes), n,
        static_cast<unsigned long long*>(keys),
        static_cast<uint32_t>(capacity - 1),
        static_cast<const int32_t*>(mult), static_cast<int32_t*>(counts),
        static_cast<int32_t*>(slot), static_cast<int32_t*>(prior),
        static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
