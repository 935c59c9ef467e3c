"""The port's wide-path ops against the reference package: feistel_words
(torch and numpy) and its inverse, encode_keys_wide_plain (K2's plain
version) against the Pallas encode_keys_wide in interpret mode, the wide
rank/cand scan (K3w's plain version) against the Pallas scan with skey2 in
interpret mode, and the wide sort's order against np.lexsort. Exact
(tolerance 0): every output is an integer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops import mix as ref_mix
from nomalise_kmers_multi_large_tpu.ops.encode_kernel import (
    encode_keys_wide as ref_encode_wide,
)
from nomalise_kmers_multi_large_tpu.ops.segscan import (
    BLOCK, rank_cand_scan as ref_scan,
)
from nomalise_kmers_multi_large_torch.ops import mix as port_mix
from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
    sort_stream_wide,
)
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    encode_keys_wide,
)
from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan

SENT = np.uint32(0xFFFFFFFF)


def _t(x):
    """torch int32 bit patterns of a uint32 numpy array."""
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [16, 17, 21, 25, 28, 31])
def test_feistel_matches_reference(k):
    b = 2 * k
    rng = np.random.default_rng(k)
    code = rng.integers(0, 1 << b, size=4096, dtype=np.uint64)
    code[:2] = (0, (1 << b) - 1)
    want1, want2 = ref_mix.feistel_words_np(code, b)
    hi = (code >> np.uint64(32)).astype(np.uint32)
    lo = (code & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    d1, d2 = ref_mix.feistel_words(jnp.asarray(hi), jnp.asarray(lo), b)
    np.testing.assert_array_equal(np.asarray(d1), want1)
    np.testing.assert_array_equal(np.asarray(d2), want2)
    g1, g2 = port_mix.feistel_words(torch.from_numpy(hi.astype(np.int64)),
                                    torch.from_numpy(lo.astype(np.int64)), b)
    np.testing.assert_array_equal(g1.numpy(), want1.astype(np.int64))
    np.testing.assert_array_equal(g2.numpy(), want2.astype(np.int64))
    n1, n2 = port_mix.feistel_words_np(code, b)
    np.testing.assert_array_equal(n1, want1)
    np.testing.assert_array_equal(n2, want2)
    np.testing.assert_array_equal(port_mix.unfeistel_np(n1, n2, b), code)
    # a real w2 is below the sentinel
    assert (n2 < (1 << 30)).all()


def _reads(k, canonical):
    rng = np.random.default_rng(10 * k + canonical)
    R, L = 24, 80
    bases = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
    lengths = np.full(R, L, np.int32)
    lengths[::3] = rng.integers(0, L + 1, size=lengths[::3].size)   # short
    lengths[1] = 0                                                   # empty
    lengths[2] = k - 1                                               # < k
    lengths[6] = 5000                                                # clips
    bases[4] = 0                                                     # poly-A
    bases[5] = 3                                                     # poly-T
    return bases, lengths


@pytest.mark.parametrize("k", [16, 17, 21, 25, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_encode_wide_matches_reference(k, canonical):
    bases, lengths = _reads(k, canonical)
    want = ref_encode_wide(jnp.asarray(bases), jnp.asarray(lengths), k,
                           canonical, interpret=True)
    got = encode_keys_wide(torch.from_numpy(bases), torch.from_numpy(lengths),
                           k, canonical)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    w1, w2 = (_u(g) for g in got)
    assert (w2[[1, 2, 4]] == SENT).all() and (w1[[1, 2, 4]] == SENT).all()
    # canonical drops poly-T too: min(code, revcomp) == 0
    assert (w2[5] == SENT).all() == canonical
    valid = w2 != SENT
    assert valid.any() and (w2[valid] < (1 << (2 * k - 32))).all()


def _sorted_stream(rng, k, n_codes, n, n_sent, W=50):
    """A read-major stream of n words (codes from a pool of n_codes, some
    pairs sharing w1 with different w2) plus n_sent sentinel windows,
    through the port's wide sort."""
    pool = rng.integers(1, 1 << (2 * k), size=n_codes, dtype=np.uint64)
    codes = pool[rng.integers(0, n_codes, size=n)]
    w1, w2 = port_mix.feistel_words_np(codes, 2 * k)
    if k > 16:
        w2[::5] ^= np.uint32(1)
    w1 = np.concatenate([w1, np.full(n_sent, SENT)])
    w2 = np.concatenate([w2, np.full(n_sent, SENT)])
    perm = rng.permutation(w1.size)
    return sort_stream_wide(_t(w1[perm]), _t(w2[perm]), W)


def _check_scan(sk1, sk2, srid, row_shift, n_reads):
    n = sk1.numel()
    pad = -n % BLOCK
    padded = [np.concatenate([_u(x), np.full(pad, SENT)]) for x in (sk1, sk2)]
    rid = np.concatenate([srid.numpy(), np.full(pad, n_reads - 1, np.int32)])
    w2_, w3_ = ref_scan(jnp.asarray(padded[0]), jnp.asarray(rid), fp_bits=0,
                        w=1, n_reads=n_reads, interpret=True,
                        skey2=jnp.asarray(padded[1]), row_shift=row_shift)
    g2, g3 = rank_cand_scan(sk1, srid, fp_bits=0, n_reads=n_reads, skey2=sk2,
                            row_shift=row_shift)
    real = _u(sk2) != SENT
    np.testing.assert_array_equal(g2.numpy()[real], np.asarray(w2_)[:n][real])
    np.testing.assert_array_equal(g3.numpy()[real], np.asarray(w3_)[:n][real])
    return g2.numpy(), g3.numpy()


@pytest.mark.parametrize("k,row_shift", [(16, 23), (25, 17), (31, 11)])
def test_scan_wide_matches_reference(k, row_shift):
    """Two scan blocks: runs and rows that cross the block boundary, codes
    that share w1 and differ in w2, sentinels last."""
    rng = np.random.default_rng(k)
    n = BLOCK + 9000
    sk1, sk2, srid = _sorted_stream(rng, k, 3000, n - 700, 700)
    _check_scan(sk1, sk2, srid, row_shift, n // 50)


def test_scan_wide_clamps_match_reference():
    """One code 40,000 times across the block boundary (rank reaches the
    JAX carry), and 200 codes of one row (cand clamps at 128)."""
    k, row_shift = 21, 20
    w1 = np.concatenate([np.full(40_000, 5 << row_shift, np.uint32),
                         np.full(200, 9 << row_shift, np.uint32),
                         np.full(300, SENT)])
    w2 = np.concatenate([np.full(40_000, 3, np.uint32),
                         np.arange(200, dtype=np.uint32),
                         np.full(300, SENT)])
    sk1, sk2, srid = sort_stream_wide(_t(w1), _t(w2), 50)
    g2, g3 = _check_scan(sk1, sk2, srid, row_shift, w1.size // 50)
    assert g2[39_999] & 0xFFFF == 40_000 and g3[40_000 + 199] == 128


def test_sort_stream_wide_order_is_lexsort():
    """(w1, w2, read id) order with the sentinel pair last, including a real
    code whose w1 is 0xFFFFFFFF."""
    rng = np.random.default_rng(3)
    W, R = 40, 300
    w1 = rng.integers(0, 64, size=R * W).astype(np.uint32) << np.uint32(26)
    w1[::97] = SENT
    w2 = rng.integers(0, 4, size=R * W).astype(np.uint32)
    sent = rng.random(R * W) < 0.1
    w1[sent], w2[sent] = SENT, SENT
    sk1, sk2, srid = sort_stream_wide(_t(w1), _t(w2), W)
    rid = np.arange(R * W) // W
    order = np.lexsort((rid, w2, w1))
    np.testing.assert_array_equal(_u(sk1), w1[order])
    np.testing.assert_array_equal(_u(sk2), w2[order])
    np.testing.assert_array_equal(srid.numpy(), rid[order])
    assert (_u(sk2)[-int(sent.sum()):] == SENT).all()
