"""Port rank_cand_scan (K3, narrow) vs the reference's Pallas kernel in
interpret mode, on the cases of tests/test_segscan.py; a run longer than
65535 is checked against that file's numpy oracle. Exact (tolerance 0); the
reference leaves padded sentinels as don't-care values, so they are
compared only against the oracle."""
import jax.numpy as jnp
import numpy as np
import torch

from nomalise_kmers_multi_large_tpu.ops.segscan import (
    BLOCK, rank_cand_scan as ref_scan,
)
from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan
from test_segscan import SENT, _oracle


def _port(skey, rid, fp_bits, n_reads):
    p2, p3 = rank_cand_scan(torch.from_numpy(skey.view(np.int32)),
                            torch.from_numpy(rid), fp_bits=fp_bits,
                            n_reads=n_reads)
    return p2.numpy(), p3.numpy()


def _check(skey, rid, fp_bits, n_reads):
    w2, w3 = ref_scan(jnp.asarray(skey), jnp.asarray(rid), fp_bits=fp_bits,
                      w=1, n_reads=n_reads, interpret=True)
    g2, g3 = _port(skey, rid, fp_bits, n_reads)
    real = skey != SENT
    np.testing.assert_array_equal(g2[real], np.asarray(w2)[real])
    np.testing.assert_array_equal(g3[real], np.asarray(w3)[real])
    o2, o3 = _oracle(skey, rid, fp_bits, n_reads)
    np.testing.assert_array_equal(g2, o2)
    np.testing.assert_array_equal(g3, o3)


def test_random_sorted_stream_matches_reference():
    rng = np.random.default_rng(7)
    n = BLOCK * 2
    key = np.sort(rng.integers(0, 5000, size=n - 777, dtype=np.uint32))
    key = np.concatenate([key, np.full(777, SENT, np.uint32)])
    rid = (rng.permutation(n) // 36).astype(np.int32)
    _check(key, rid, fp_bits=7, n_reads=n // 36)


def test_all_distinct_block_matches_reference():
    rng = np.random.default_rng(1)
    key = np.sort(rng.choice(1 << 20, size=BLOCK, replace=False)
                  ).astype(np.uint32)
    rid = (np.arange(BLOCK, dtype=np.int32) // 100)
    _check(key, rid, fp_bits=3, n_reads=BLOCK // 100)


def test_run_spanning_block_boundary_matches_reference():
    n = BLOCK * 2
    key = np.full(n, 42, np.uint32)
    rid = (np.arange(n, dtype=np.int32) // 64)
    _check(key, rid, fp_bits=4, n_reads=n // 64)


def test_rank_and_cand_clamps_match_oracle():
    # one run of 70000 (rank clamps at 65535), then 200 distinct keys of one
    # row (cand clamps at 128), then sentinels; unpadded length
    key = np.concatenate([
        np.full(70000, 5, np.uint32),
        (np.uint32(1 << 12) + np.arange(200, dtype=np.uint32)),
        np.full(33, SENT, np.uint32),
    ])
    rid = (np.arange(key.size, dtype=np.int32) // 150)
    n_reads = 400  # ids above it clamp to n_reads - 1
    g2, g3 = _port(key, rid, fp_bits=10, n_reads=n_reads)
    o2, o3 = _oracle(key, rid, 10, n_reads)
    np.testing.assert_array_equal(g2, o2)
    np.testing.assert_array_equal(g3, o3)
    assert (g2[65534:70000] & 0xFFFF == 65535).all()
    assert g3[70000 + 199] == 128
