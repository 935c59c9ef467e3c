"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere (a
CUDA kernel has no CPU mode). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

Every output is an integer, so every comparison is exact (tolerance 0).
"""
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
    bucket_upsert, bucket_upsert_plain, sort_stream,
)
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    encode_keys, encode_keys_plain,
)
from nomalise_kmers_multi_large_torch.ops.segscan import (
    rank_cand_scan, rank_cand_scan_plain,
)
from nomalise_kmers_multi_large_torch.table.bucket import BucketTable

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _reads(rng, n, length, pool=None):
    pool = pool or max(2, n // 8)
    seqs = rng.integers(0, 4, size=(pool, length), dtype=np.uint8)
    bases = seqs[rng.integers(0, pool, size=n)]
    sub = rng.random(bases.shape) < 0.01
    bases[sub] = rng.integers(0, 4, size=int(sub.sum()), dtype=np.uint8)
    lengths = np.full(n, length, np.int32)
    lengths[::5] = rng.integers(0, length + 1, size=lengths[::5].size)
    return bases, lengths


@pytest.mark.parametrize("k", [5, 9, 15])
@pytest.mark.parametrize("canonical", [False, True])
def test_encode_kernel_matches_plain(dev, k, canonical):
    bases, lengths = _reads(np.random.default_rng(k), 1000, 150)
    bases[3] = 0
    bases[4] = 3
    b, ln = torch.from_numpy(bases).to(dev), torch.from_numpy(lengths).to(dev)
    got = encode_keys(b, ln, k, canonical)
    torch.cuda.synchronize()
    assert torch.equal(got, encode_keys_plain(b, ln, k, canonical))


def test_scan_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    key = np.sort(rng.integers(0, 1 << 20, size=300_000)).astype(np.uint32)
    key = np.concatenate([key, np.full(70_000, 77 << 20, np.uint32),
                          np.full(1234, 0xFFFFFFFF, np.uint32)])
    key.sort()
    rid = rng.integers(0, 16384, size=key.size).astype(np.int32)
    sk = torch.from_numpy(key.view(np.int32)).to(dev)
    sr = torch.from_numpy(rid).to(dev)
    for fp_bits in (1, 9, 16):
        got = rank_cand_scan(sk, sr, fp_bits=fp_bits, n_reads=9000)
        want = rank_cand_scan_plain(sk, sr, fp_bits=fp_bits, n_reads=9000)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("lanes", [64, 128])
@pytest.mark.parametrize("seed", [False, True])
def test_bucket_kernel_matches_plain(dev, lanes, seed):
    """A table pre-filled by two seed batches, then one batch whose rows
    partly overflow: planes, tallies and stats equal."""
    rng = np.random.default_rng(lanes + seed)
    table = BucketTable(11, rows=256, lanes=lanes, device=dev)
    state = table.init()
    stream = []
    for _ in range(3):
        bases, lengths = _reads(rng, 512, 100)
        key = encode_keys(torch.from_numpy(bases).to(dev),
                          torch.from_numpy(lengths).to(dev), 11, False)
        rid = torch.arange(key.numel(), device=dev) // key.shape[1]
        skey, srid = sort_stream(key.reshape(-1), rid)
        p2, p3 = rank_cand_scan(skey, srid, fp_bits=table.fp_bits,
                                n_reads=key.shape[0])
        stream.append((skey, p2, p3, key.shape[0]))
    for skey, p2, p3, n in stream[:2]:
        bucket_upsert(state.keys, state.counts, skey, p2, p3,
                      fp_bits=table.fp_bits, depth=4, seed=True, n_reads=n)
    skey, p2, p3, n = stream[2]
    fp2, c2 = state.keys.clone(), state.counts.clone()
    kw = dict(fp_bits=table.fp_bits, depth=4, seed=seed, n_reads=n)
    high, stats = bucket_upsert(state.keys, state.counts, skey, p2, p3, **kw)
    phigh, pstats = bucket_upsert_plain(fp2, c2, skey, p2, p3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(state.keys, fp2) and torch.equal(state.counts, c2)
    assert torch.equal(high, phigh) and torch.equal(stats, pstats)
    assert int(stats[0]) > 0 and int(stats[1]) > 0
