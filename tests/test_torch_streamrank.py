"""The port's sorted occurrence stream against the JAX package's
``sorted_occurrence_stream``, tolerance 0: the same stream (codes made from
a seed with numpy, with duplicates and invalid occurrences) gives the same
sort permutation, validity, run heads, ranks and multiplicities, and the
same codes at every valid slot. k = 11 and 15 (the JAX two-key sort) and
16, 21, 31 (three keys); at k = 16 the all-T k-mer, whose low word equals
the JAX sentinel, and at k = 31 the largest code. Also unsort."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops.streamrank import (
    sorted_occurrence_stream as ref_stream,
)
from nomalise_kmers_multi_large_torch.ops.streamrank import (
    SENTINEL, sorted_occurrence_stream,
)


def _codes(rng, k, n):
    pool = rng.integers(1, 1 << (2 * k), size=max(2, n // 6),
                        dtype=np.int64)
    codes = pool[rng.integers(0, pool.size, size=n)]
    top = (1 << (2 * k)) - 1           # the all-T k-mer
    codes[rng.random(n) < 0.05] = top
    codes[rng.random(n) < 0.05] = 0    # poly-A: never valid
    valid = (rng.random(n) > 0.15) & (codes != 0)
    return codes, valid


def _compare(codes, valid, k):
    u = codes.astype(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ref = ref_stream(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
                     hi_is_zero=k <= 15)
    got = sorted_occurrence_stream(torch.from_numpy(codes),
                                   torch.from_numpy(valid))
    for name in ("src", "valid", "boundary", "rank", "mult"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert got.rank.dtype == got.mult.dtype == torch.int32
    v = got.valid.numpy()
    ref_code = (np.asarray(ref.hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(ref.lo)
    np.testing.assert_array_equal(got.code.numpy()[v].astype(np.uint64),
                                  ref_code[v])
    assert (got.code.numpy()[~v] == SENTINEL).all()
    return got


@pytest.mark.parametrize("k", [11, 15, 16, 21, 31])
def test_stream_equals_jax_stream(k):
    rng = np.random.default_rng(k)
    codes, valid = _codes(rng, k, 3000)
    got = _compare(codes, valid, k)
    assert int(got.boundary.sum()) > 100 and int(got.mult.max()) > 1
    top = (1 << (2 * k)) - 1
    assert valid[codes == top].any()


def test_k16_all_t_kmer_counts():
    """At k = 16 the all-T code is 0xFFFFFFFF, the JAX package's 32-bit
    sentinel: one int64 key keeps it a real code with its own run."""
    codes = np.array([0xFFFFFFFF, 5, 0xFFFFFFFF, 7, 0xFFFFFFFF, 5],
                     np.int64)
    valid = np.array([True, True, True, False, True, True])
    got = _compare(codes, valid, 16)
    heads = got.boundary.numpy()
    np.testing.assert_array_equal(got.code.numpy()[heads], [5, 0xFFFFFFFF])
    np.testing.assert_array_equal(got.mult.numpy()[heads], [2, 3])
    np.testing.assert_array_equal(got.rank.numpy()[got.valid.numpy()],
                                  [1, 2, 1, 2, 3])


def test_unsort_inverts_the_sort():
    rng = np.random.default_rng(3)
    codes, valid = _codes(rng, 13, 500)
    s = sorted_occurrence_stream(torch.from_numpy(codes),
                                 torch.from_numpy(valid))
    back = s.unsort(torch.where(s.valid, s.code, 0))
    np.testing.assert_array_equal(back.numpy(), np.where(valid, codes, 0))
