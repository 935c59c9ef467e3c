"""The port's codec (ops/codec.py) against the JAX codec and the string
oracle (tests/oracle.py): window codes, canonical codes, window validity
and decoding, at k = 5..31, canonical off and on. Exact (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops import codec as ref_codec
from nomalise_kmers_multi_large_torch.io.pack import LUT
from nomalise_kmers_multi_large_torch.ops import codec
from oracle import encode as oracle_encode
from oracle import revcomp

KS = [5, 11, 15, 16, 25, 31]


def _reads(k, seed, n=12, length=48):
    """Random reads packed to `length` with random padding bases, lengths
    from 0 to `length` (some shorter than k), a poly-A and a poly-T read."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(m)))
            for m in rng.integers(0, length + 1, size=n)]
    seqs[0], seqs[1] = "A" * length, "T" * length
    seqs[2] = seqs[2][:k - 1]
    bases = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    for i, s in enumerate(seqs):
        bases[i, :len(s)] = LUT[np.frombuffer(s.encode(), np.uint8)]
    return seqs, bases, np.array([len(s) for s in seqs], np.int32)


def _oracle_code(kmer: str, canonical: bool) -> int:
    return oracle_encode(min(kmer, revcomp(kmer)) if canonical else kmer)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_codec_matches_jax_codec_and_oracle(k, canonical):
    seqs, bases, lengths = _reads(k, k + 100 * canonical)
    hi, lo = codec.encode_windows_canonical(torch.from_numpy(bases), k,
                                            canonical)
    valid = codec.window_validity(torch.from_numpy(lengths), hi, lo, k)
    rhi, rlo = ref_codec.encode_windows_canonical(jnp.asarray(bases), k,
                                                  canonical)
    rvalid = ref_codec.window_validity(jnp.asarray(lengths), rhi, rlo, k)
    assert hi.dtype == lo.dtype == torch.int64
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    code = (hi << 32) | lo
    for r, s in enumerate(seqs):
        for i in range(bases.shape[1] - k + 1):
            if i <= len(s) - k:
                want = _oracle_code(s[i:i + k], canonical)
                assert int(code[r, i]) == want, (r, i)
                assert bool(valid[r, i]) == (want != 0)
            else:
                assert not valid[r, i]
    assert not valid[0].any()                  # poly-A: code 0
    assert bool(valid[1].any()) != canonical   # poly-T: canonical code 0
    assert not valid[2].any()                  # shorter than k


@pytest.mark.parametrize("k", KS)
def test_plain_encode_and_decode(k):
    """encode_windows (no canonical step) equals the JAX codec's, and
    decode_codes inverts it to the window strings, as the JAX decoder."""
    seqs, bases, _ = _reads(k, k + 7)
    hi, lo = codec.encode_windows(torch.from_numpy(bases), k)
    rhi, rlo = ref_codec.encode_windows(jnp.asarray(bases), k)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    got = codec.decode_codes(hi[:, 0].numpy(), lo[:, 0].numpy(), k)
    assert got == ref_codec.decode_codes(np.asarray(rhi)[:, 0],
                                         np.asarray(rlo)[:, 0], k)
    letters = np.frombuffer(b"ACGT", np.uint8)
    assert got == [bytes(letters[row[:k]]).decode() for row in bases]
