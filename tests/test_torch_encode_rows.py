"""A model of the encode kernels' arithmetic (csrc/encode_rows.cuh, K1 in
csrc/encode.cu and K2 in csrc/encode_wide.cu), held to the port's plain
versions and to the reference's Pallas kernels in interpret mode. Exact
(tolerance 0).

The model follows the kernel step by step on the host: rows split into
blocks at random; each block's byte span staged with 16-byte copies over its
aligned interior and byte copies at the edges, from a buffer that starts at
a random offset; rows packed into 2-bit words (first base in the high bits,
bases past min(L, 1023) zero, guard words after); the group-of-4 walk over
the block's output span aligned to a random output offset, each group's
first row found by a multiply-high with the reciprocal of W; each window's
code a funnel shift across two (K1) or three (K2) words, its reverse
complement a bit reversal with the bit pairs swapped back."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops.encode_kernel import (
    encode_keys as ref_encode_keys, encode_keys_wide as ref_encode_keys_wide,
)
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    encode_keys_plain, encode_keys_wide_plain,
)
from nomalise_kmers_multi_large_torch.ops.mix import (
    feistel_words_np, mix32_np,
)

MAX_LEN = 1023  # bases past it never reach a valid window
GUARD = 2       # zero words after a row's packed bases
U64 = np.uint64
M32 = 0xFFFFFFFF


def _quot(p, d: int):
    """p // d as the kernel takes it: a multiply-high by 0xFFFFFFFF // d,
    then one correction."""
    p = np.asarray(p, np.uint64)
    q = (p * U64(M32 // d)) >> U64(32)
    return (q + ((p - q * U64(d)) >= U64(d))).astype(np.int64)


def _stage(flat: np.ndarray, start: int, end: int):
    """Shared memory of a block after staging flat[start:end] (indices are
    byte addresses): the span at offset start % 16, its aligned interior by
    16-byte copies, the edges by bytes."""
    head = start % 16
    mid = min(start + (16 - head) if head else start, end)
    tail = max(end - end % 16, mid)
    assert mid - start < 16 and end - tail < 16 and (tail - mid) % 16 == 0
    smem = np.full(head + end - start, 255, np.uint8)  # 255: never staged
    for a in range(mid, tail, 16):  # 16-byte copies, aligned on both sides
        assert a % 16 == 0 and (a - start + head) % 16 == 0
        smem[a - start + head:a - start + head + 16] = flat[a:a + 16]
    for a in list(range(start, mid)) + list(range(tail, end)):
        smem[a - start + head] = flat[a]
    assert (smem[head:] != 255).all()
    return smem, head


def _pack(smem, head: int, n: int, L: int, lc: int) -> np.ndarray:
    """uint64 [n, nw] packed rows: word j holds bases 16j..16j+15 of the
    row, first base in bits 31..30; bases past lc are 0."""
    nw = -(-lc // 16) + GUARD
    col = np.arange(16 * nw)
    at = np.minimum(head + L * np.arange(n)[:, None] + col, smem.size - 1)
    b = np.where(col < lc, smem[at] & 3, 0).astype(np.uint64)
    shift = U64(30) - U64(2) * np.arange(16, dtype=np.uint64)
    return (b.reshape(n, nw, 16) << shift).sum(axis=2, dtype=np.uint64)


def _funnel(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the high 32 bits of (hi:lo) << s."""
    return ((((hi << U64(32)) | lo) << s.astype(np.uint64)) >> U64(32)) & U64(M32)


def _brev(x, bits: int):
    out = np.zeros_like(x)
    for i in range(bits):
        out |= ((x >> U64(i)) & U64(1)) << U64(bits - 1 - i)
    return out


def _revcomp(code, k: int, bits: int):
    """The kernel's reverse complement of 2k-bit codes in a `bits`-bit
    word (32 on K1, 64 on K2)."""
    mask = U64((1 << bits) - 1)
    x = _brev(~code & mask, bits)
    odd = U64(int("55" * (bits // 8), 16))
    x = ((x >> U64(1)) & odd) | ((x & odd) << U64(1))
    return x >> U64(bits - 2 * k)


def _walk(span: int, W: int, lead: int):
    """(position, row, window) of every key of a block's span in the order
    the threads take them: groups of 4 keys aligned `lead` keys before the
    span, the first row of a group by _quot, then steps along the row."""
    groups = (lead + span + 3) // 4
    p0 = 4 * np.arange(groups) - lead
    p = np.maximum(p0, 0)
    i = _quot(p, W)
    w = p - i * W
    out = []
    for j in range(4):
        pos = p0 + j
        inside = (pos >= 0) & (pos < span)
        out.append(np.stack([pos, i, w])[:, inside])
        w = np.where(inside, w + 1, w)
        wrap = w == W
        w, i = np.where(wrap, 0, w), np.where(wrap, i + 1, i)
    return np.concatenate(out, axis=1)


def model_encode(bases, lengths, k: int, canonical: bool, blocks, base_off,
                 out_off):
    """The kernels' keys for uint8 bases [R, L]: uint32 [R, W] (k <= 15) or
    (w1, w2) (k = 16..31). blocks: rows per block, in order, summing to R;
    base_off: the byte address of bases[0, 0]; out_off: the word address of
    the output's first key."""
    R, L = bases.shape
    W = L - k + 1
    wide = k > 15
    bits = 64 if wide else 32
    lc = min(L, MAX_LEN)
    flat = np.concatenate([np.zeros(base_off, np.uint8), bases.reshape(-1)])
    outs = np.full((2 if wide else 1, R * W), -1, np.int64)
    r0 = 0
    for n in blocks:
        start = base_off + r0 * L
        smem, head = _stage(flat, start, start + (n - 1) * L + lc)
        words = _pack(smem, head, n, L, lc)
        lim = np.clip(lengths[r0:r0 + n].astype(np.int64), 0, MAX_LEN) - k
        e0 = r0 * W
        pos, i, w = _walk(n * W, W, (out_off + e0) % 4)
        assert np.array_equal(np.sort(pos), np.arange(n * W))
        assert np.array_equal(i, pos // W) and np.array_equal(w, pos % W)
        wr = np.minimum(w, lc - k)  # past lc - k: out of length anyway
        q, s = wr >> 4, 2 * (wr & 15)
        assert (q + (2 if wide else 1) < words.shape[1]).all()
        hi = _funnel(words[i, q + 1], words[i, q], s)
        if wide:
            lo = _funnel(words[i, q + 2], words[i, q + 1], s)
            code = ((hi << U64(32)) | lo) >> U64(64 - 2 * k)
        else:
            code = hi >> U64(32 - 2 * k)
        if canonical:
            code = np.minimum(code, _revcomp(code, k, bits))
        valid = (w <= lim[i]) & (code != 0)
        if wide:
            mixed = feistel_words_np(code, 2 * k)
        else:
            mixed = [mix32_np(code, 2 * k)]
        for o, m in enumerate(mixed):
            assert outs[o, e0 + pos].max(initial=-1) == -1  # written once
            outs[o, e0 + pos] = np.where(valid, m.astype(np.int64), M32)
        r0 += n
    assert r0 == R and (outs >= 0).all()
    got = [x.astype(np.uint32).reshape(R, W) for x in outs]
    return tuple(got) if wide else got[0]


def _random_blocks(rng, R: int):
    blocks = []
    while sum(blocks) < R:
        blocks.append(int(rng.integers(1, R - sum(blocks) + 1)))
    return blocks


def _reads(rng, k: int, L: int, R: int = 9):
    """Rows of length 0, k - 1 and 5000 (clipped to 1023), poly-A and
    poly-T rows, and random lengths; padding bytes past a length are random
    codes 0..3."""
    bases = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    lengths[:3] = [0, k - 1, 5000]
    bases[3], lengths[3] = 0, L
    bases[4], lengths[4] = 3, 5000
    return bases, lengths


def _plain(bases, lengths, k: int, canonical: bool):
    b, ln = torch.from_numpy(bases), torch.from_numpy(lengths)
    if k <= 15:
        return encode_keys_plain(b, ln, k, canonical).numpy().view(np.uint32)
    return tuple(x.numpy().view(np.uint32)
                 for x in encode_keys_wide_plain(b, ln, k, canonical))


def _reference(bases, lengths, k: int, canonical: bool):
    fn = ref_encode_keys if k <= 15 else ref_encode_keys_wide
    out = fn(jnp.asarray(bases), jnp.asarray(lengths), k, canonical,
             interpret=True)
    return tuple(map(np.asarray, out)) if k > 15 else np.asarray(out)


def _assert_same(got, want):
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        np.testing.assert_array_equal(a, b)


KS = [5, 8, 15, 16, 17, 24, 25, 31]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("L", ["k", 37, 100, 152, 1100])
@pytest.mark.parametrize("canonical", [False, True])
def test_model_matches_plain_and_reference(k, L, canonical):
    """Random block splits, staging offsets and output offsets; the word
    seams (k = 16: 2k = 32; k = 31: 62 bits), W = 1 (L = k), L not a
    multiple of 4 or 16, L > 1023 with lengths above it."""
    L = k if L == "k" else L
    rng = np.random.default_rng(1000 * k + 2 * L + canonical)
    bases, lengths = _reads(rng, k, L)
    want = _plain(bases, lengths, k, canonical)
    _assert_same(want, _reference(bases, lengths, k, canonical))
    R = bases.shape[0]
    for blocks in (_random_blocks(rng, R), [1] * R, [R]):
        got = model_encode(bases, lengths, k, canonical, blocks,
                           int(rng.integers(0, 16)), int(rng.integers(0, 4)))
        _assert_same(got, want)
    valid = (want[1] if k > 15 else want) != M32
    assert not valid[:2].any()  # lengths 0 and k - 1
    assert not valid[3].any()  # poly-A dropped
    assert valid[4].any() != canonical  # poly-T dropped under canonical
    assert not valid[2, MAX_LEN - k + 1:].any()  # length 5000 clips to 1023


@pytest.mark.parametrize("k", KS)
def test_revcomp_by_bit_reversal(k):
    """The bit-reversed complement equals the reverse complement built base
    by base, in the kernel's 32-bit word (K1) or 64-bit word (K2)."""
    rng = np.random.default_rng(k)
    code = rng.integers(0, 1 << (2 * k), size=2000, dtype=np.uint64)
    code[:2] = [0, (1 << (2 * k)) - 1]
    want = np.zeros_like(code)
    for j in range(k):
        base = (code >> U64(2 * (k - 1 - j))) & U64(3)
        want |= (U64(3) - base) << U64(2 * j)
    np.testing.assert_array_equal(_revcomp(code, k, 64 if k > 15 else 32),
                                  want)


def test_quotient_by_reciprocal():
    """The multiply-high quotient with one correction is exact for every
    divisor the kernels take (W and the packed words per row) up to
    p < 2^31, powers of two and W = 1 included."""
    rng = np.random.default_rng(3)
    divisors = [1, 2, 3, 7, 16, 64, 66, 126, 128, 136, 1096, 4096, 1 << 20,
                (1 << 31) - 1]
    p = np.concatenate([np.arange(5000), rng.integers(0, 1 << 31, 20000),
                        [(1 << 31) - 1]])
    for d in divisors:
        np.testing.assert_array_equal(_quot(p, d), p // d)


def test_stage_covers_every_offset_and_length():
    """The 16-byte interior and the byte edges cover each span exactly
    once, for every start offset and short and long spans."""
    flat = np.random.default_rng(5).integers(0, 4, 400, dtype=np.uint8)
    for start in range(16, 48):
        for size in list(range(0, 40)) + [150, 151, 300]:
            smem, head = _stage(flat, start, start + size)
            np.testing.assert_array_equal(smem[head:],
                                          flat[start:start + size])
