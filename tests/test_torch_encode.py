"""Port encode_keys (K1) vs the reference's Pallas encode_keys in interpret
mode. Keys are compared as uint32 bit patterns; exact (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops.encode_kernel import (
    encode_keys as ref_encode_keys,
)
from nomalise_kmers_multi_large_torch.ops.encode_kernel import encode_keys


def _both(bases, lengths, k, canonical):
    want = np.asarray(ref_encode_keys(jnp.asarray(bases), jnp.asarray(lengths),
                                      k, canonical, interpret=True))
    got = encode_keys(torch.from_numpy(bases), torch.from_numpy(lengths), k,
                      canonical)
    assert got.dtype == torch.int32 and got.shape == want.shape
    return got.numpy().view(np.uint32), want


@pytest.mark.parametrize("k", [5, 7, 9, 15])
@pytest.mark.parametrize("canonical", [False, True])
def test_encode_matches_reference(k, canonical):
    rng = np.random.default_rng(10 * k + canonical)
    R, L = 40, 100
    bases = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
    lengths = np.full(R, L, np.int32)
    lengths[::3] = rng.integers(0, L + 1, size=lengths[::3].size)  # short
    lengths[1] = 0                                                   # empty
    lengths[2] = k - 1                                               # < k
    bases[4] = 0                                                     # poly-A
    bases[5] = 3                                                     # poly-T
    got, want = _both(bases, lengths, k, canonical)
    np.testing.assert_array_equal(got, want)
    assert (got[4] == 0xFFFFFFFF).all()
    # canonical drops poly-T too: min(code, revcomp) == 0
    assert (got[5] == 0xFFFFFFFF).all() == canonical


def test_rows_not_block_multiple_and_long_lengths():
    # 600 reads: not a multiple of the reference kernel's 512-read block;
    # lengths above 1023 clip to 1023
    rng = np.random.default_rng(7)
    bases = rng.integers(0, 4, size=(600, 40), dtype=np.uint8)
    lengths = rng.integers(0, 41, size=600).astype(np.int32)
    lengths[:5] = 5000
    got, want = _both(bases, lengths, 15, False)
    np.testing.assert_array_equal(got, want)
