"""Port mix32 (torch, int64 carriers) vs the reference's numpy and JAX mix32,
and the port's numpy inverse. Exact (tolerance 0): integer outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops import mix as ref_mix
from nomalise_kmers_multi_large_torch.ops import mix as port_mix


@pytest.mark.parametrize("bits", range(8, 33))
def test_mix32_matches_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.integers(0, 1 << bits, size=4096, dtype=np.uint32)
    x[:2] = (0, (1 << bits) - 1)
    want = ref_mix.mix32_np(x, bits)
    np.testing.assert_array_equal(
        np.asarray(ref_mix.mix32(jnp.asarray(x), bits)), want)
    got = port_mix.mix32(torch.from_numpy(x.astype(np.int64)), bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(port_mix.mix32_np(x, bits), want)


@pytest.mark.parametrize("bits", [8, 18, 30])
def test_unmix_roundtrip(bits):
    rng = np.random.default_rng(100 + bits)
    x = rng.integers(0, 1 << bits, size=4096, dtype=np.uint32)
    m = port_mix.mix32_np(x, bits)
    np.testing.assert_array_equal(port_mix.unmix32_np(m, bits), x)
    np.testing.assert_array_equal(port_mix.unmix32_np(m, bits),
                                  ref_mix.unmix32_np(m, bits))


def test_mix32_rejects_wide_bits():
    # 32 bits is the Feistel round function's width; nothing mixes wider
    with pytest.raises(ValueError):
        port_mix.mix32(torch.zeros(1, dtype=torch.int64), 33)
