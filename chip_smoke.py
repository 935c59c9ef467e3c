#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py        (from the root of a checkout; one card)

Phases, each of which fails the run on error:

1. The card's name and power limit; build every kernel from
   nomalise_kmers_multi_large_torch/csrc with nvcc (sm_90a).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (8192 read pairs = 16384 reads x 150 bp, a table of 2^21
   rows pre-filled by a seed pass): exact equality, and each one's time
   beside the plain version's (CUDA events, mean of several launches).
   The k <= 15 kernels (K1, K3, K4) at k = 15; the wide kernels (K2, K3w,
   K5) timed at k = 25, and checked for equality at k = 16 (no plane B)
   and k = 31 on a 2^18-row table.
3. Golden parity: the port's CLI on tests/data/{a1,b1}.fasta -t fa -o fa
   -d 4 --device cuda is byte-identical to tests/golden/fasta_in_paired_k15
   at -k 15 and to tests/golden/fasta_in_paired_k25_jax (made by the JAX
   package) at -k 25.
4. The main path at a size users run: 1,000,000 read pairs of 2 x 150 bp
   FASTQ from a synthetic transcriptome (20,000 transcripts x 1.5 kb,
   log-normal abundance, 0.2% substitutions), normalised with the
   reference defaults (-k 15 -d 100 -g 0.9 -p 1 --batch-reads 8192) through
   Normalizer.run(). Kernel launch counts are zeroed just before and read
   just after; every kernel of the path must have launched. The first
   20,000 pairs also run through the CPU plain path, whose output must be
   byte-identical.
5. The wide path on the same files at -k 25 (otherwise as phase 4): the
   same checks, and the table must have grown from its 2^14 rows.

Standard output ends with one JSON line of per-kernel results, then
{"ok": true, "device": {...}} as the last line. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke_work")
SEED = 20240823
PAIRS = 1_000_000         # phase 4 read pairs
CHECK_PAIRS = 20_000      # phase 4 pairs also run on the CPU plain path
BATCH_READS = 16384       # phase 2 batch: 8192 pairs, the CLI default
TABLE_ROWS = 1 << 21      # phase 2 table: the size phase 4 grows to

REPLACES = {  # kernel -> the TPU kernel's pallas_call it replaces
    "encode_keys": "nomalise_kmers_multi_large_tpu/ops/encode_kernel.py:289",
    "rank_cand_scan": "nomalise_kmers_multi_large_tpu/ops/segscan.py:194",
    "bucket_batch": "nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py:549",
    "encode_keys_wide":
        "nomalise_kmers_multi_large_tpu/ops/encode_kernel.py:236",
    "rank_cand_scan_wide": "nomalise_kmers_multi_large_tpu/ops/segscan.py:194",
    "bucket_batch_wide":
        "nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py:1127",
}
#: the kernels each path runs; a path's run must launch every one of them
PATH_KERNELS = {
    15: ("encode_keys", "rank_cand_scan", "bucket_batch"),
    25: ("encode_keys_wide", "rank_cand_scan_wide", "bucket_batch_wide"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


# ----------------------------------------------------------------------
# synthetic transcriptome reads

def synth_pairs(rng, n_pairs, n_tx=20_000, tx_len=1_500, read_len=150,
                err=0.002, sigma=1.5, chunk=100_000):
    """Yield (mate1, mate2) uint8 base-code blocks [n, read_len]: fragments
    of ~300 bp from transcripts drawn with log-normal abundance; mate 2 is
    the reverse complement of the fragment's other end."""
    tx = rng.integers(0, 4, size=(n_tx, tx_len), dtype=np.uint8)
    w = rng.lognormal(0.0, sigma, n_tx)
    p = w / w.sum()
    pos = np.arange(read_len)
    for lo in range(0, n_pairs, chunk):
        n = min(chunk, n_pairs - lo)
        t = rng.choice(n_tx, size=n, p=p)
        frag = np.clip(rng.normal(300, 30, n).astype(np.int64), read_len,
                       tx_len)
        start = (rng.random(n) * (tx_len - frag + 1)).astype(np.int64)
        m1 = tx[t[:, None], start[:, None] + pos]
        m2 = 3 - tx[t[:, None], (start + frag - 1)[:, None] - pos]
        for m in (m1, m2):
            hit = rng.random(m.shape) < err
            m[hit] = (m[hit] + rng.integers(1, 4, int(hit.sum()),
                                            dtype=np.uint8)) % 4
        yield m1, m2


def fastq_block(codes, first_id: int, mate: int) -> bytes:
    """FASTQ records @p<7-digit id>/<mate>, quality 'I', as one buffer."""
    n, L = codes.shape
    rec = np.empty((n, 14 + 2 * L + 1), np.uint8)
    ids = first_id + np.arange(n, dtype=np.int64)
    rec[:, 0] = ord("@")
    rec[:, 1:8] = (ids[:, None] // 10 ** np.arange(6, -1, -1)) % 10 + 48
    rec[:, 8:11] = np.frombuffer(f"/{mate}\n".encode(), np.uint8)
    rec[:, 11:11 + L] = np.frombuffer(b"ACGT", np.uint8)[codes]
    rec[:, 11 + L:14 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 14 + L:14 + 2 * L] = ord("I")
    rec[:, 14 + 2 * L] = ord("\n")
    return rec.tobytes()


def write_pairs(rng, n_pairs, path1, path2):
    done = 0
    with open(path1, "wb") as f1, open(path2, "wb") as f2:
        for m1, m2 in synth_pairs(rng, n_pairs):
            f1.write(fastq_block(m1, done, 1))
            f2.write(fastq_block(m2, done, 2))
            done += len(m1)


# ----------------------------------------------------------------------

def time_ms(fn, setup=None, iters=10, warmup=2) -> float:
    """Mean device time of fn() in ms between CUDA events; setup() (not
    timed) runs before each call."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    total = 0.0
    for _ in range(iters):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def max_abs_err(pairs) -> int:
    err = 0
    for got, want in pairs:
        if got.shape != want.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def read_batches(rng, dev, n_batches: int):
    """n_batches of BATCH_READS x 150 bp synthetic reads (mates
    interleaved, as the engine packs pairs), on the card."""
    reads, batches = BATCH_READS, []
    for m1, m2 in synth_pairs(rng, n_batches * reads // 2, chunk=reads // 2):
        b = np.empty((reads, 150), np.uint8)
        b[0::2], b[1::2] = m1, m2
        batches.append(torch.from_numpy(b).to(dev))
    return batches


def report(out: dict, label: str):
    for name, r in out.items():
        print(f"{label}: {name}: max_abs_err {r['max_abs_err']}, kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")


def phase_kernels(rng, dev) -> dict:
    """Each k <= 15 kernel vs its plain version at the main path's
    shapes."""
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

    k, reads, depth = 15, BATCH_READS, 100
    batches = read_batches(rng, dev, 5)
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)
    table = BucketTable(k, rows=TABLE_ROWS, device=dev)
    state = table.init()

    def stream(bases):
        key = encode_keys(bases, lengths, k, False)
        rid = torch.arange(key.numel(), device=dev) // key.shape[1]
        skey, srid = sort_stream(key.reshape(-1), rid)
        p2, p3 = rank_cand_scan(skey, srid, fp_bits=table.fp_bits,
                                n_reads=reads)
        return key, skey, srid, p2, p3

    for bases in batches[:4]:  # seed pass: fill the table
        _, skey, _, p2, p3 = stream(bases)
        bucket_upsert(state.keys, state.counts, skey, p2, p3,
                      fp_bits=table.fp_bits, depth=depth, seed=True,
                      n_reads=reads)
    bases = batches[4]
    key, skey, srid, p2, p3 = stream(bases)
    torch.cuda.synchronize()
    occupied = int((state.keys != 0).sum())
    print(f"phase 2: table {table.rows:,} rows x {table.lanes} lanes, "
          f"{occupied:,} slots filled by a 4-batch seed pass; batch "
          f"{reads:,} reads x 150 bp -> {skey.numel():,} windows")

    out = {}
    err = max_abs_err([(key, encode_keys_plain(bases, lengths, k, False))])
    out["encode_keys"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: encode_keys(bases, lengths, k, False)),
        plain_ms=time_ms(lambda: encode_keys_plain(bases, lengths, k, False),
                         iters=5))
    kw = dict(fp_bits=table.fp_bits, n_reads=reads)
    err = max_abs_err(zip(rank_cand_scan(skey, srid, **kw),
                          rank_cand_scan_plain(skey, srid, **kw)))
    out["rank_cand_scan"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: rank_cand_scan(skey, srid, **kw)),
        plain_ms=time_ms(lambda: rank_cand_scan_plain(skey, srid, **kw),
                         iters=5))

    fp0, c0 = state.keys.clone(), state.counts.clone()
    fp1, c1 = fp0.clone(), c0.clone()
    kw = dict(fp_bits=table.fp_bits, depth=depth, n_reads=reads)
    errs = []
    for seed in (True, False):
        for t, src in ((state.keys, fp0), (state.counts, c0),
                       (fp1, fp0), (c1, c0)):
            t.copy_(src)
        got = bucket_upsert(state.keys, state.counts, skey, p2, p3,
                            seed=seed, **kw)
        want = bucket_upsert_plain(fp1, c1, skey, p2, p3, seed=seed, **kw)
        errs.append(max_abs_err([(state.keys, fp1), (state.counts, c1),
                                 *zip(got, want)]))
    print(f"phase 2: bucket batch inserted {int(got[1][1]):,}, dropped "
          f"{int(got[1][0]):,}, high windows {int(got[0].sum()):,}")

    def reset():
        state.keys.copy_(fp0)
        state.counts.copy_(c0)

    out["bucket_batch"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: bucket_upsert(state.keys, state.counts, skey, p2,
                                         p3, seed=False, **kw), setup=reset),
        plain_ms=time_ms(lambda: bucket_upsert_plain(
            state.keys, state.counts, skey, p2, p3, seed=False, **kw),
            setup=reset, iters=3))
    report(out, "phase 2")
    del state, fp0, c0, fp1, c1, batches
    torch.cuda.empty_cache()
    return out


def phase_kernels_wide(rng, dev) -> dict:
    """K2, K3w and K5 vs their plain versions: timed at k = 25 on a 2^21-row
    table pre-filled by a 4-batch seed pass; equality only at k = 16 and
    k = 31 on a 2^18-row table."""
    from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
        bucket_upsert_wide, bucket_upsert_wide_plain, sort_stream_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
        encode_keys_wide, encode_keys_wide_plain,
    )
    from nomalise_kmers_multi_large_torch.ops.segscan import (
        rank_cand_scan, rank_cand_scan_plain,
    )
    from nomalise_kmers_multi_large_torch.table.bucket import BucketTableWide

    reads, depth = BATCH_READS, 100
    batches = read_batches(rng, dev, 5)
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)
    out = {}
    for k in (25, 16, 31):
        timed = k == 25
        table = BucketTableWide(k, rows=TABLE_ROWS if timed else 1 << 18,
                                device=dev)
        state = table.init()
        scan_kw = dict(fp_bits=0, n_reads=reads, row_shift=table.row_shift)

        def stream(bases):
            words = encode_keys_wide(bases, lengths, k, False)
            sk1, sk2, srid = sort_stream_wide(
                words[0].reshape(-1), words[1].reshape(-1), words[0].shape[1])
            p2, p3 = rank_cand_scan(sk1, srid, skey2=sk2, **scan_kw)
            return words, (sk1, sk2, srid), (p2, p3)

        planes = (state.keys, state.keys2, state.counts)
        kw = dict(row_shift=table.row_shift, depth=depth, n_reads=reads)
        for bases in batches[:4]:  # seed pass: fill the table
            _, (sk1, sk2, _), (p2, p3) = stream(bases)
            bucket_upsert_wide(*planes, sk1, sk2, p2, p3, seed=True, **kw)
        bases = batches[4]
        words, (sk1, sk2, srid), scan = stream(bases)
        torch.cuda.synchronize()
        print(f"phase 2 (k={k}): table {table.rows:,} rows x {table.lanes} "
              f"lanes, {int((state.keys != 0).sum()):,} slots filled by a "
              f"4-batch seed pass; batch {reads:,} reads x 150 bp -> "
              f"{sk1.numel():,} windows")

        res = {"encode_keys_wide": max_abs_err(
            zip(words, encode_keys_wide_plain(bases, lengths, k, False)))}
        res["rank_cand_scan_wide"] = max_abs_err(zip(
            scan, rank_cand_scan_plain(sk1, srid, skey2=sk2, **scan_kw)))
        start = [None if x is None else x.clone() for x in planes]
        twins = [None if x is None else x.clone() for x in planes]

        def reset():
            for t, src in zip(planes + tuple(twins), start + start):
                if t is not None:
                    t.copy_(src)

        errs = []
        for seed in (True, False):
            reset()
            got = bucket_upsert_wide(*planes, sk1, sk2, *scan, seed=seed,
                                     **kw)
            want = bucket_upsert_wide_plain(*twins, sk1, sk2, *scan,
                                            seed=seed, **kw)
            errs.append(max_abs_err([
                *((a, b) for a, b in zip(planes, twins) if a is not None),
                *zip(got, want)]))
        res["bucket_batch_wide"] = max(errs)
        print(f"phase 2 (k={k}): bucket batch inserted {int(got[1][1]):,}, "
              f"dropped {int(got[1][0]):,}, high windows "
              f"{int(got[0].sum()):,}; max_abs_err {res}")
        if any(res.values()):
            raise AssertionError(f"k={k}: a wide kernel disagrees with its "
                                 f"plain version: {res}")
        if not timed:
            continue
        out = {name: dict(max_abs_err=err) for name, err in res.items()}
        out["encode_keys_wide"].update(
            ms=time_ms(lambda: encode_keys_wide(bases, lengths, k, False)),
            plain_ms=time_ms(lambda: encode_keys_wide_plain(
                bases, lengths, k, False), iters=5))
        out["rank_cand_scan_wide"].update(
            ms=time_ms(lambda: rank_cand_scan(sk1, srid, skey2=sk2,
                                              **scan_kw)),
            plain_ms=time_ms(lambda: rank_cand_scan_plain(
                sk1, srid, skey2=sk2, **scan_kw), iters=5))
        out["bucket_batch_wide"].update(
            ms=time_ms(lambda: bucket_upsert_wide(
                *planes, sk1, sk2, *scan, seed=False, **kw), setup=reset),
            plain_ms=time_ms(lambda: bucket_upsert_wide_plain(
                *planes, sk1, sk2, *scan, seed=False, **kw), setup=reset,
                iters=3))
        w1f, w2f, n_win = (words[0].reshape(-1), words[1].reshape(-1),
                           words[0].shape[1])
        print(f"phase 2 (k=25): sort_stream_wide (torch.sort, not a kernel "
              f"of the port) "
              f"{time_ms(lambda: sort_stream_wide(w1f, w2f, n_win)):.4f} ms")
        report(out, "phase 2 (k=25)")
        del state, planes, start, twins
        torch.cuda.empty_cache()
    del batches
    torch.cuda.empty_cache()
    return out


def phase_golden(k: int, case: str):
    from nomalise_kmers_multi_large_torch import cli

    out = os.path.join(WORK, f"golden_{case}")
    data = os.path.join(ROOT, "tests", "data")
    rc = cli.main(["-f", os.path.join(data, "a1.fasta"),
                   "-r", os.path.join(data, "b1.fasta"), "-t", "fa", "-o",
                   "fa", "-k", str(k), "-d", "4", "--device", "cuda",
                   "--out-dir", out])
    if rc != 0:
        raise AssertionError(f"golden CLI run exited {rc}")
    gold = os.path.join(ROOT, "tests", "golden", case)
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k{k}_norm4_thread0.fastq"
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(gold, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"golden mismatch: {case}/{name}")
    print(f"phase 3: golden {case} byte-identical on cuda")


def write_inputs(rng):
    f1, f2 = os.path.join(WORK, "r1.fq"), os.path.join(WORK, "r2.fq")
    t0 = time.perf_counter()
    write_pairs(rng, PAIRS, f1, f2)
    print(f"phase 4: wrote {PAIRS:,} pairs of 2 x 150 bp FASTQ "
          f"({os.path.getsize(f1) * 2 / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; size cuts: none")
    # the first pairs, for the CPU plain path
    sub = []
    for src, name in ((f1, "c1.fq"), (f2, "c2.fq")):
        dst = os.path.join(WORK, name)
        with open(src, "rb") as a, open(dst, "wb") as b:
            b.write(a.read(CHECK_PAIRS * 315))   # 315-byte records
        sub.append(dst)
    return (f1, f2), tuple(sub)


def phase_main(dev, k: int, files, check_files, label: str) -> dict:
    """The engine at -k `k` on the phase-4 files; returns the launches of
    the run."""
    from nomalise_kmers_multi_large_torch import backend
    from nomalise_kmers_multi_large_torch.cli import config_from_args
    from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer

    def run(sub, device, files):
        out = os.path.join(WORK, f"k{k}_{sub}")
        cfg, _ = config_from_args(["-f", files[0], "-r", files[1], "-k",
                                   str(k), "-d", "100", "-g", "0.9", "-p",
                                   "1", "--batch-reads", "8192", "-e",
                                   "--out-dir", out])
        norm = Normalizer(cfg, device)
        rows0 = norm.tables[0].rows
        rep = norm.run()
        return norm, rep, out, rows0

    backend.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    norm, rep, out, rows0 = run("main", dev, files)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = backend.launches()
    t = norm.tables[0]
    st = norm.states[0]
    slot_bytes = 12 if k > 16 else 8
    print(f"{label}: k={k}: {rep.total_processed:,} pairs in {wall:.2f} s = "
          f"{rep.total_processed / wall:,.0f} pairs/s "
          f"({2 * rep.total_processed / wall:,.0f} reads/s), seed pass "
          f"included; processed {rep.total_processed:,}, printed "
          f"{rep.total_printed:,}, skipped {rep.total_skipped:,}; "
          f"unique k-mers {rep.max_total_kmers:,}; table grew from "
          f"{rows0:,} to {t.rows:,} rows x {t.lanes} lanes = "
          f"{t.rows * t.lanes * slot_bytes:,} bytes of fingerprint and count "
          f"planes; launches {launches}")
    if rep.total_processed != PAIRS or \
            rep.total_printed + rep.total_skipped != PAIRS:
        raise AssertionError(f"{label} totals do not add up")
    if int(st.overflow) != 0 or rep.max_total_kmers <= 0:
        raise AssertionError(f"{label} table dropped inserts or is empty")
    if t.rows <= rows0:
        raise AssertionError(f"{label} table never grew from {rows0} rows")
    name = f"output_forward.k{k}_norm100_thread0.fastq"
    with open(os.path.join(out, name), "rb") as f:
        lines = sum(buf.count(b"\n") for buf in iter(lambda: f.read(1 << 24),
                                                      b""))
    if lines != 4 * rep.total_printed:
        raise AssertionError(f"{lines} output lines for "
                             f"{rep.total_printed} printed pairs")
    missing = [n for n in PATH_KERNELS[k] if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the k={k} path: "
                             f"{missing}")

    # the same engine on the CPU plain path, on the first pairs
    outs = [run(f"check_{d}", d, check_files)[2] for d in ("cuda", "cpu")]
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k{k}_norm100_thread0.fastq"
        a, b = (open(os.path.join(o, name), "rb").read() for o in outs)
        if a != b:
            raise AssertionError(f"cuda and cpu outputs differ: {name}")
    print(f"{label}: k={k}: first {CHECK_PAIRS:,} pairs: cuda and cpu plain "
          "path outputs byte-identical")
    for o in outs + [out]:
        shutil.rmtree(o)
    return {n: launches[n] for n in PATH_KERNELS[k]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from nomalise_kmers_multi_large_torch import backend

    dev = torch.device("cuda", 0)
    print(card_line())
    t0 = time.perf_counter()
    backend.build()
    print(f"phase 1: built {sorted(backend.KERNEL_SOURCES)} with nvcc "
          f"{' '.join(backend.NVCC_FLAGS)} in "
          f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        rng = np.random.default_rng(SEED)
        timing = phase_kernels(rng, dev)
        # its own generator, so phase 4's input stays as earlier versions
        # of this script wrote it
        timing.update(phase_kernels_wide(np.random.default_rng(SEED + 1),
                                         dev))
        phase_golden(15, "fasta_in_paired_k15")
        phase_golden(25, "fasta_in_paired_k25_jax")
        files, check_files = write_inputs(rng)
        launches = phase_main(dev, 15, files, check_files, "phase 4")
        launches.update(phase_main(dev, 25, files, check_files, "phase 5"))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"nomalise_kmers_multi_large_torch/csrc/{src}",
         "replaces": REPLACES[name], "launches": launches[name],
         **timing[name]}
        for name, src in backend.KERNEL_SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
