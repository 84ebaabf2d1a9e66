#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tendermint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--profile] [--out DIR]

Builds the port's CUDA kernels from the sources in this checkout, holds
every kernel against its plain PyTorch version, then drives the main
path through the entry points a user calls: crypto.gpu_verifier.install()
and types.validation.verify_commit on a 10,000-validator ed25519 Commit
(the north-star size), verify_commit_light on a 150-validator Commit, and
a 10,000-validator Commit with one bad signature that must be rejected at
that index. Keys, messages and timestamps come from --seed.

Before the main path, every kernel is held against its plain version at
the widest bucket, K2 also on the ZIP-215 corpus at buckets 128 and
12288 and at a width that no block of signatures divides.

Phases print one JSON line each. The line before the last two is the
card as nvidia-smi names it, with its power limit; the line before the
last is {"kernels": [...]} (launches on the main path, the kernel's and
its plain version's times, and the card's least time for the same work;
for K2 and K1 also one launch's time and bound at each width in
K2_WIDTHS / K1_WIDTHS; for every kernel its registers, stack frame and
spill bytes from ptxas -v);
the last line is {"ok": true, "device": {...}}. Any failed phase raises
and the script exits non-zero without that line. It exits non-zero at
once when CUDA is not available or when the package is not beside it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks: HBM bytes/s,
# and int32 instructions/s: 64 of each SM's 128 fp32 lanes run int32, so
# the 67 TFLOP/s fp32 FMA rate (2 flops each) over 4 -> 16.75e12
HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 67e12 / 4

# lower bounds on the int32 instructions of one item: the field
# multiplies and squarings the check needs (the kernels' formulas), at 4
# 32-bit multiplies per 64x64->128 limb product, 25 products per general
# multiply and 15 per squaring (5 diagonal + 10 doubled cross products).
# This counts what the check needs, whatever a kernel does: additions,
# carries, lane exchanges and loads are not counted, nor T coordinates
# that a kernel computes and never reads. Per signature (squarings,
# multiplies):
#   decompression of A: pow_p58 (251, 11) + 4 squarings, 8 multiplies;
#   decompression of R: the same less the T coordinate it never uses;
#   table of -A: 4 doublings with T (4, 4) + 3 additions with T (0, 8)
#     + 8 cached conversions (0, 1);
#   64 windows: 3 doublings without T (4, 3) + 1 with T (4, 4)
#     + an addition of -A's entry with T (0, 8) + of B's without T (0, 7);
#   cofactor: 3 doublings without T on each side; compare: 4 multiplies.
SQ_K2, MUL_K2 = 255 + 255 + 16 + 64 * 16 + 24, 19 + 18 + 48 + 64 * 28 + 22
SQ_K1, MUL_K1 = 16 + 64 * 16, 48 + 64 * 28  # the table and the windows
PRODUCTS_PER_SQ, PRODUCTS_PER_MUL, INSTR_PER_PRODUCT = 15, 25, 4


def field_instr(squarings: int, multiplies: int) -> int:
    """int32 multiply instructions of that many field squarings and
    multiplies."""
    products = squarings * PRODUCTS_PER_SQ + multiplies * PRODUCTS_PER_MUL
    return products * INSTR_PER_PRODUCT


# one SHA-512 compression: 80 rounds x ~30 32-bit instructions plus 64
# schedule steps x ~20 (64-bit rotates, adds and three-input logic ops)
INSTR_PER_SHA512_BLOCK = 80 * 30 + 64 * 20

# the widest bucket (config.DEFAULT_BUCKET_SIZES), the width the kernels
# are held against their plain versions at
WIDE = 12288
# the widths each ed25519 kernel is timed at, one launch each
K2_WIDTHS = (512, 2048, WIDE)
K1_WIDTHS = (2048, WIDE)

CHAIN_ID = "chip-smoke-chain"
HEIGHT = 1234
# the north-star commit (BASELINE.md config 5) and the timed repetitions
N_VALIDATORS = 10_000
REPS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    return out.strip().splitlines()[0]


def nvcc_version() -> str:
    from tendermint_tpu_torch.ops.build import nvcc_path

    out = subprocess.run(
        [nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout
    return out.strip().splitlines()[-1]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` runs after one
    warm-up, between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_resources(log: str) -> dict:
    """Registers of the source's entry kernels, and the largest stack
    frame and spill bytes over all of its functions, from `ptxas -v`."""
    regs, stack, st, ld = [], [0], [0], [0]
    for line in log.splitlines():
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(int(m.group(1)))
        m = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads",
            line,
        )
        if m:
            stack.append(int(m.group(1)))
            st.append(int(m.group(2)))
            ld.append(int(m.group(3)))
    return {
        "registers": max(regs) if regs else None,
        "stack_frame_bytes": max(stack),
        "spill_store_bytes": max(st),
        "spill_load_bytes": max(ld),
    }


def bound_ms(nbytes: float, instr: float):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = instr / INT32_INSTR_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def reset_launches() -> None:
    from tendermint_tpu_torch.ops import ed25519_cuda, sha512_kernel

    ed25519_cuda.reset_launches()
    sha512_kernel.reset_launches()


def launches() -> dict:
    from tendermint_tpu_torch.ops import ed25519_cuda, sha512_kernel

    return {**ed25519_cuda.LAUNCHES, **sha512_kernel.LAUNCHES}


# -- commits built with the port's own types --


def build_commit(n: int, seed: int):
    """(ValidatorSet, BlockID, Commit) of n equal-power ed25519
    validators that all signed, keys and timestamps from the seed. Vote
    timestamps spread over one second, as a real commit's do, so the
    sign-bytes come in several varint lengths."""
    from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from tendermint_tpu_torch.types.commit import Commit, CommitSig
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    from tendermint_tpu_torch.types.vote import Vote

    privs = [
        PrivKeyEd25519.from_seed(
            hashlib.sha256(b"chip-smoke-%d-%d" % (seed, i)).digest()
        )
        for i in range(n)
    ]
    by_addr = {p.pub_key().address(): p for p in privs}
    vals = ValidatorSet(
        [Validator(pub_key=p.pub_key(), voting_power=10) for p in privs]
    )
    block_id = BlockID(
        hashlib.sha256(b"block-%d" % seed).digest(),
        PartSetHeader(1, hashlib.sha256(b"parts-%d" % seed).digest()),
    )
    rng = np.random.default_rng(seed)
    base_ns = 1_760_000_000 * 1_000_000_000
    sigs = []
    for i, val in enumerate(vals.validators):
        ts = base_ns + int(rng.integers(0, 1_000_000_000))
        vote = Vote(
            type=PRECOMMIT_TYPE,
            height=HEIGHT,
            round=0,
            block_id=block_id,
            timestamp_ns=ts,
            validator_address=val.address,
            validator_index=i,
        )
        sig = by_addr[val.address].sign(vote.sign_bytes(CHAIN_ID))
        sigs.append(CommitSig.for_block(sig, val.address, ts))
    commit = Commit(height=HEIGHT, round=0, block_id=block_id, signatures=sigs)
    return vals, block_id, commit


def commit_triples(vals, commit):
    """(pubkeys, messages, signatures) of a commit, in index order."""
    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = commit.sign_bytes_batch(CHAIN_ID)
    sigs = [cs.signature for cs in commit.signatures]
    return pks, msgs, sigs


def time_commit(fn, reps: int):
    """Host-clock ms of fn() (which ends in a device sync through the
    verifier's gather): one warm-up, then p50 and p95 over reps."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50)), float(np.percentile(times, 95))


# -- phases --


def phase_report(torch, out_dir: str) -> None:
    from tendermint_tpu_torch.ops import build, sass_count

    t0 = time.perf_counter()
    build.kernels()
    seconds = time.perf_counter() - t0
    rep = build.build_report()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for stem, log in rep["ptxas"].items():
            f.write(f"== {stem}\n{log}\n")
    emit(
        {
            "phase": "report",
            "nvidia_smi": nvidia_smi_line(),
            "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "nvcc": nvcc_version(),
            "build_seconds": seconds,
            "libraries": sorted(rep["libraries"]),
            # one field multiply and squaring per radix considered
            "fe_sass": sass_count.count(),
        }
    )


def phase_sha512(torch, dev, seed: int) -> None:
    """X1 against its plain version and hashlib, across the 128-byte
    block boundaries, at the main-path bucket width."""
    from tendermint_tpu_torch.ops import sha512_kernel as S

    rng = np.random.default_rng(seed)
    n = WIDE
    for m in (0, 47, 48, 111, 112, 175, 176, 239):
        data = rng.integers(0, 256, (64 + m, n), dtype=np.uint8)
        rows = torch.from_numpy(data).to(dev)
        got = S.sha512_fixed(rows).cpu().numpy()
        plain = S.sha512_fixed_plain(rows).cpu().numpy()
        cols = np.ascontiguousarray(data.T)
        ref = np.stack(
            [
                np.frombuffer(
                    hashlib.sha512(cols[i].tobytes()).digest(), np.uint8
                )
                for i in range(n)
            ],
            axis=1,
        )
        if not (np.array_equal(got, plain) and np.array_equal(got, ref)):
            raise AssertionError(f"X1 digest mismatch at M={m}")
    emit({"phase": "x1_vs_plain_and_hashlib", "n": n, "ok": True})


def _decoded_points(torch, dev, n: int, seed: int):
    """(4, 20, n) extended points from decompressing seeded encodings
    with the plain decompression, keeping only those that decode."""
    from tendermint_tpu_torch.ops import ed25519_kernel as K
    from tendermint_tpu_torch.ops import edwards as E

    rng = np.random.default_rng(seed)
    enc = rng.integers(0, 256, (32, 3 * n), dtype=np.int32)
    b = torch.from_numpy(enc).to(dev)
    sign = b[31] >> 7
    b[31] &= 0x7F
    A, ok = E.decompress(K._fe_from_bytes_dev(b), sign)
    idx = torch.nonzero(ok).flatten()[:n]
    if idx.numel() < n:
        raise AssertionError("too few decodable points")
    return A[:, :, idx].contiguous()


def projective_err(torch, P, Q) -> int:
    """Largest limb difference between the canonical cross products
    X1 Z2, X2 Z1 (and the same for Y) of two (3, 20, N) stacks: 0 when
    the points are equal."""
    from tendermint_tpu_torch.ops import field25519 as F

    err = 0
    for c in (0, 1):
        lhs = F.canonical(F.mul(P[c], Q[2]))
        rhs = F.canonical(F.mul(Q[c], P[2]))
        err = max(err, int((lhs - rhs).abs().max().item()))
    return err


def phase_dual_mult(torch, dev, seed: int) -> None:
    """K1 against its plain version: seeded points and digit rows."""
    from tendermint_tpu_torch.ops import ed25519_cuda as C
    from tendermint_tpu_torch.ops import ed25519_kernel as K

    n = WIDE
    A = _decoded_points(torch, dev, n, seed)
    rng = np.random.default_rng(seed + 1)
    ds = torch.from_numpy(rng.integers(0, 16, (64, n), dtype=np.int32)).to(dev)
    dk = torch.from_numpy(rng.integers(0, 16, (64, n), dtype=np.int32)).to(dev)
    err = projective_err(
        torch, C.dual_mult(A, ds, dk), K.dual_mult_sb_minus_ka(A, ds, dk)
    )
    if err:
        raise AssertionError(f"K1 differs from its plain version: {err}")
    emit({"phase": "k1_vs_plain", "n": n, "max_abs_err": err, "ok": True})


def phase_verify_tile(torch, dev, seed: int) -> None:
    """K2 against its plain version and the host oracle on the ZIP-215
    corpus at buckets 128 and 12288; the hybrid program on the same."""
    from tendermint_tpu_torch.crypto import zip215_corpus
    from tendermint_tpu_torch.ops import ed25519_cuda as C
    from tendermint_tpu_torch.ops import ed25519_kernel as K

    triples = zip215_corpus.corpus(16, seed)
    want = np.array(zip215_corpus.expected(triples))
    reps = (WIDE - WIDE // 32) // len(triples)
    out = {}
    for count in (len(triples), reps * len(triples)):
        tr = (triples * (count // len(triples)))[:count]
        exp = np.tile(want, count // len(triples))
        pks, msgs, sigs = (list(x) for x in zip(*tr))
        verifier = K.Ed25519Verifier(bucket_sizes=[128, WIDE], device=dev)
        pk_b, sig_b, dig_b, size_ok = verifier.pack(pks, msgs, sigs)
        bucket = pk_b.shape[1]
        kern = C.verify_tile(pk_b, sig_b, dig_b).cpu().numpy()
        plain = K._verify_tile(pk_b, sig_b, dig_b).cpu().numpy()
        as_int32 = C.verify_tile(pk_b.int(), sig_b.int(), dig_b.int())
        as_int32 = as_int32.cpu().numpy()
        tile = verifier.verify(pks, msgs, sigs)
        hybrid = K.Ed25519Verifier(
            bucket_sizes=[128, WIDE], device=dev, program="hybrid"
        ).verify(pks, msgs, sigs)
        checks = {
            "kernel_eq_plain_all_lanes": np.array_equal(kern, plain),
            "int32_rows_eq_uint8": np.array_equal(kern, as_int32),
            "tile_eq_oracle": np.array_equal(tile, exp),
            "hybrid_eq_oracle": np.array_equal(hybrid, exp),
        }
        if not all(checks.values()):
            raise AssertionError(f"K2 corpus check at {bucket}: {checks}")
        out[str(bucket)] = {"n": count, "valid": int(exp.sum())}
    emit({"phase": "k2_vs_plain_and_oracle", "buckets": out, "ok": True})


# a K2 width that no block of signatures divides: RAGGED - PAD corpus
# lanes and PAD all-zero lanes
RAGGED, PAD = 2048 - 3, 5


def phase_ragged_width(torch, dev, seed: int) -> None:
    """K2 at a width that is not a multiple of a block's signatures,
    with zero padding lanes at the end: identical to its plain version
    and, on the corpus lanes, to the host oracle."""
    from tendermint_tpu_torch.crypto import zip215_corpus
    from tendermint_tpu_torch.ops import ed25519_cuda as C
    from tendermint_tpu_torch.ops import ed25519_kernel as K

    triples = zip215_corpus.corpus(16, seed + 2)
    count = RAGGED - PAD
    tr = (triples * (count // len(triples) + 1))[:count]
    want = np.array(zip215_corpus.expected(tr))
    pks, msgs, sigs = (list(x) for x in zip(*tr))
    verifier = K.Ed25519Verifier(bucket_sizes=[RAGGED], device=dev)
    pk_b, sig_b, dig_b, size_ok = verifier.pack(pks, msgs, sigs)
    if pk_b.shape[1] != RAGGED:
        raise AssertionError(f"packed width {pk_b.shape[1]} != {RAGGED}")
    kern = C.verify_tile(pk_b, sig_b, dig_b).cpu().numpy()
    plain = K._verify_tile(pk_b, sig_b, dig_b).cpu().numpy()
    checks = {
        "kernel_eq_plain_all_lanes": np.array_equal(kern, plain),
        "kernel_eq_oracle": np.array_equal(kern[:count] & size_ok, want),
    }
    if not all(checks.values()):
        raise AssertionError(f"K2 at width {RAGGED}: {checks}")
    emit(
        {
            "phase": "k2_ragged_width",
            "width": RAGGED,
            "padding_lanes": PAD,
            "valid": int(want.sum()),
            "ok": True,
        }
    )


def phase_main_path(torch, seed: int) -> dict:
    """The entry points a user calls, on the card, with launch counts
    zeroed just before each path and read just after."""
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.types.validation import (
        InvalidCommitError,
        verify_commit,
        verify_commit_light,
    )

    t0 = time.perf_counter()
    vals, bid, commit = build_commit(N_VALIDATORS, seed)
    vals150, bid150, commit150 = build_commit(150, seed + 1)
    lengths = sorted({len(m) for m in commit.sign_bytes_batch(CHAIN_ID)})
    if len(lengths) < 2:
        raise AssertionError("the commit's sign-bytes share one length")
    build_s = time.perf_counter() - t0

    # the 150-validator commit through the host oracle first: the
    # reference outcome the device path must reproduce
    verify_commit_light(CHAIN_ID, vals150, bid150, HEIGHT, commit150)

    gpu_verifier.install()
    try:
        reset_launches()
        p50, p95 = time_commit(
            lambda: verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit), REPS
        )
        l50, l95 = time_commit(
            lambda: verify_commit_light(
                CHAIN_ID, vals150, bid150, HEIGHT, commit150
            ),
            REPS,
        )
        bad_idx = N_VALIDATORS * 7 // 9
        good_sig = commit.signatures[bad_idx].signature
        commit.signatures[bad_idx].signature = (
            good_sig[:9] + bytes([good_sig[9] ^ 0x20]) + good_sig[10:]
        )
        try:
            verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)
        except InvalidCommitError as e:
            if f"wrong signature (#{bad_idx})" not in str(e):
                raise AssertionError(f"rejected at the wrong index: {e}")
        else:
            raise AssertionError("the corrupted commit verified")
        finally:
            commit.signatures[bad_idx].signature = good_sig
        main_launches = launches()
        for name in ("ed25519_verify_tile", "sha512_rows"):
            if main_launches[name] == 0:
                raise AssertionError(f"the main path never launched {name}")
        stats = gpu_verifier.stats()
    finally:
        gpu_verifier.uninstall()

    # the hybrid program: plain preparation and compare around kernel K1
    gpu_verifier.install(program="hybrid")
    try:
        reset_launches()
        verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)
        hybrid_launches = launches()
        if hybrid_launches["ed25519_dual_mult"] == 0:
            raise AssertionError("the hybrid path never launched K1")
    finally:
        gpu_verifier.uninstall()

    emit(
        {
            "phase": "main_path",
            "validators": N_VALIDATORS,
            "commit_build_s": build_s,
            "sign_bytes_lengths": lengths,
            "verify_commit_ms": {"p50": p50, "p95": p95, "reps": REPS},
            "verify_commit_light_150_ms": {
                "p50": l50,
                "p95": l95,
                "reps": REPS,
            },
            "rejected_bad_index": bad_idx,
            "launches_tile_program": main_launches,
            "launches_hybrid_program": hybrid_launches,
            "verifier_stats": stats,
            "ok": True,
        }
    )
    return {
        "vals": vals,
        "commit": commit,
        "tile": main_launches,
        "hybrid": hybrid_launches,
    }


def _digest_inputs(torch, dev, pks, msgs, sigs, sizes):
    """The (64 + M, bucket) rows X1 hashes for one dispatched batch: one
    launch per sign-bytes length group, as Ed25519Verifier does."""
    from tendermint_tpu_torch.ops import ed25519_kernel as K

    groups: dict = {}
    for i, m in enumerate(msgs):
        groups.setdefault(len(m), []).append(i)
    out = []
    for mlen, idxs in sorted(groups.items()):
        g = len(idxs)
        arr = K._join_cols(
            [sigs[i][:32] + pks[i] + msgs[i] for i in idxs],
            64 + mlen,
            K.bucket_for(g, sizes) - g,
        )
        out.append(torch.from_numpy(arr).to(dev))
    return out


def phase_kernels(torch, dev, main: dict, card: str, power: str) -> dict:
    """Each kernel on the inputs the main path gives it for one commit
    (the batch verifier streams it in STREAM_CHUNK windows, each one
    dispatch): its time and its plain version's on the same inputs, the
    largest difference between them, and the least time the card could
    take for the same work."""
    from tendermint_tpu_torch.config import DEFAULT_BUCKET_SIZES
    from tendermint_tpu_torch.crypto.gpu_verifier import (
        GpuEd25519BatchVerifier,
    )
    from tendermint_tpu_torch.ops import ed25519_cuda as C
    from tendermint_tpu_torch.ops import ed25519_kernel as K
    from tendermint_tpu_torch.ops import edwards as E
    from tendermint_tpu_torch.ops import sha512_kernel as S

    pks, msgs, sigs = commit_triples(main["vals"], main["commit"])
    sizes = sorted(DEFAULT_BUCKET_SIZES)
    step = GpuEd25519BatchVerifier.STREAM_CHUNK
    chunks = [
        (pks[i : i + step], msgs[i : i + step], sigs[i : i + step])
        for i in range(0, len(pks), step)
    ]
    verifier = K.Ed25519Verifier(device=dev)
    rows = []

    def row(
        name, source, replaces, launches, shape, err, fn, plain, nbytes, instr
    ):
        b_ms, b_by = bound_ms(nbytes, instr)
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "shape": shape,
            "max_abs_err": err,
            "ms": cuda_ms(torch, fn, 10),
            "plain_ms": cuda_ms(torch, plain, 1),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }

    # X1
    pre = [
        p for c in chunks for p in _digest_inputs(torch, dev, *c, sizes)
    ]
    x1 = lambda: [S.sha512_fixed(p) for p in pre]  # noqa: E731
    x1_plain = lambda: [S.sha512_fixed_plain(p) for p in pre]  # noqa: E731
    err = max(
        int((a.int() - b.int()).abs().max().item())
        for a, b in zip(x1(), x1_plain())
    )
    rows.append(
        row(
            "sha512_rows",
            "tendermint_tpu_torch/ops/csrc/sha512.cu",
            "tendermint_tpu/ops/sha512_kernel.py:190",
            main["tile"]["sha512_rows"],
            [list(p.shape) for p in pre],
            err,
            x1,
            x1_plain,
            sum(p.shape[0] * p.shape[1] + 64 * p.shape[1] for p in pre),
            sum(
                p.shape[1]
                * ((p.shape[0] + 17 + 127) // 128)
                * INSTR_PER_SHA512_BLOCK
                for p in pre
            ),
        )
    )

    # K2
    packed = [verifier.pack(*c) for c in chunks]
    k2 = lambda: [C.verify_tile(*p[:3]) for p in packed]  # noqa: E731
    k2_plain = lambda: [K._verify_tile(*p[:3]) for p in packed]  # noqa: E731
    got, plain = k2(), k2_plain()
    for c, g in zip(chunks, got):
        if not bool(g[: len(c[0])].all()):
            raise AssertionError("K2 rejected a valid signature of the commit")
    err = max(
        int((a.int() - b.int()).abs().max().item()) for a, b in zip(got, plain)
    )
    lanes = sum(p[0].shape[1] for p in packed)
    rows.append(
        row(
            "ed25519_verify_tile",
            "tendermint_tpu_torch/ops/csrc/ed25519_verify.cu",
            "tendermint_tpu/ops/ed25519_pallas.py:140",
            main["tile"]["ed25519_verify_tile"],
            [p[0].shape[1] for p in packed],
            err,
            k2,
            k2_plain,
            lanes * (32 + 64 + 64 + 1),
            lanes * field_instr(SQ_K2, MUL_K2),
        )
    )

    # K1 on the hybrid program's inputs for the same windows
    def k1_inputs(pk_b, sig_b, dig_b):
        pk = pk_b.int()
        topclear = K._col([0xFF] * 31 + [0x7F], dev)
        y = K._fe_from_bytes_dev(pk & topclear)
        A, _okA = E.decompress(y, pk[31] >> 7)
        ds = K._nibbles_dev(sig_b.int()[32:])
        dk = K._nibbles_dev(K._mod_l_dev(dig_b.int()))
        return A.contiguous(), ds.contiguous(), dk.contiguous()

    k1_in = [k1_inputs(*p[:3]) for p in packed]
    k1 = lambda: [C.dual_mult(*a) for a in k1_in]  # noqa: E731
    k1_plain = lambda: [  # noqa: E731
        K.dual_mult_sb_minus_ka(*a) for a in k1_in
    ]
    err = max(projective_err(torch, a, b) for a, b in zip(k1(), k1_plain()))
    rows.append(
        row(
            "ed25519_dual_mult",
            "tendermint_tpu_torch/ops/csrc/ed25519_dual_mult.cu",
            "tendermint_tpu/ops/ed25519_pallas.py:171",
            main["hybrid"]["ed25519_dual_mult"],
            [list(a[0].shape) for a in k1_in],
            err,
            k1,
            k1_plain,
            lanes * (4 * 20 * 4 + 2 * 64 * 4 + 3 * 20 * 4),
            lanes * field_instr(SQ_K1, MUL_K1),
        )
    )
    # one launch at each width that matters: 512 is the light commit's
    # bucket, 2048 the streaming window, 12288 the widest bucket (the
    # 10k commit's signatures, zero lanes after)
    def packed_at(w):
        return verifier.pack(pks[:w], msgs[:w], sigs[:w])[:3]

    k2_w = {w: packed_at(w) for w in K2_WIDTHS}
    k1_w = {w: k1_inputs(*k2_w[w]) for w in K1_WIDTHS}
    by_width = {
        "ed25519_verify_tile": {
            w: (
                lambda p=p: C.verify_tile(*p),
                w * (32 + 64 + 64 + 1),
                w * field_instr(SQ_K2, MUL_K2),
                p[0].shape[1],
            )
            for w, p in k2_w.items()
        },
        "ed25519_dual_mult": {
            w: (
                lambda a=a: C.dual_mult(*a),
                w * (4 * 20 * 4 + 2 * 64 * 4 + 3 * 20 * 4),
                w * field_instr(SQ_K1, MUL_K1),
                a[0].shape[-1],
            )
            for w, a in k1_w.items()
        },
    }
    from tendermint_tpu_torch.ops import build

    ptxas = build.build_report()["ptxas"]
    stems = {
        "sha512_rows": "sha512",
        "ed25519_verify_tile": "ed25519_verify",
        "ed25519_dual_mult": "ed25519_dual_mult",
    }
    for r in rows:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} differs from its plain version")
        r.update(ptxas_resources(ptxas[stems[r["name"]]]))
        widths = by_width.get(r["name"], {})
        for w, (fn, nbytes, instr, got_w) in widths.items():
            if got_w != w:
                raise AssertionError(f"{r['name']}: width {got_w} != {w}")
            r.setdefault("ms_by_width", {})[str(w)] = cuda_ms(torch, fn, 10)
            r.setdefault("bound_ms_by_width", {})[str(w)] = bound_ms(
                nbytes, instr
            )[0]
        r["card"] = card
        r["power_limit"] = power
    return {"kernels": rows}


def phase_profile(torch, main: dict, reps: int, out_dir: str) -> None:
    """Where one verify_commit's time goes (run with --profile): host
    clocks around its stages, and torch.profiler's device time by kernel
    over `reps` calls, with the chrome trace in out_dir."""
    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.batch import create_batch_verifier
    from tendermint_tpu_torch.types.validation import verify_commit

    vals, commit = main["vals"], main["commit"]
    bid = commit.block_id
    gpu_verifier.install()
    try:
        verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)  # warm
        stages = {"sign_bytes": [], "add": [], "verify": [], "total": []}
        for _ in range(reps):
            t0 = time.perf_counter()
            sbs = commit.sign_bytes_batch(CHAIN_ID)
            t1 = time.perf_counter()
            bv = create_batch_verifier(vals.validators[0].pub_key, len(sbs))
            for v, sb, cs in zip(vals.validators, sbs, commit.signatures):
                bv.add(v.pub_key, sb, cs.signature)
            t2 = time.perf_counter()
            ok, _bits = bv.verify()
            t3 = time.perf_counter()
            if not ok:
                raise AssertionError("the valid commit failed in the profile")
            for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
                stages[k].append(v * 1e3)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)
            wall = (time.perf_counter() - t0) * 1e3 / reps
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(out_dir, "verify_commit_trace.json")
        )
    finally:
        gpu_verifier.uninstall()
    kernels = {}  # device-side events only (kernels, copies), each once
    for evt in prof.key_averages():
        on_device = "cuda" in str(evt.device_type).lower()
        if on_device and evt.self_device_time_total > 0:
            kernels[evt.key] = evt.self_device_time_total / 1e3 / reps
    busy = sum(kernels.values())
    host_total = float(np.median(stages["total"]))
    emit(
        {
            "phase": "profile",
            "stage_ms_p50": {
                k: float(np.median(v)) for k, v in stages.items()
            },
            "profiled_wall_ms_per_commit": wall,
            "device_ms_per_commit": kernels,
            "device_busy_ms_per_commit": busy if kernels else None,
            # against the unprofiled wall (the profiler slows the host)
            "device_idle_share": (1 - busy / host_total) if kernels else None,
        }
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--profile",
        action="store_true",
        help="also break one verify_commit down by stage and by kernel",
    )
    ap.add_argument(
        "--out",
        default=os.path.join("build", "chip_smoke"),
        help="directory for the ptxas report and the profile trace",
    )
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tendermint_tpu_torch")):
        print(
            "chip_smoke: run from the root of the repository "
            "(tendermint_tpu_torch/ is not beside this script)",
            file=sys.stderr,
        )
        return 2
    sys.path.insert(0, here)
    os.chdir(here)
    dev = torch.device("cuda")

    smi = nvidia_smi_line()
    card, power = (s.strip() for s in smi.split(",", 1))
    phase_report(torch, args.out)
    phase_sha512(torch, dev, args.seed)
    phase_dual_mult(torch, dev, args.seed)
    phase_verify_tile(torch, dev, args.seed)
    phase_ragged_width(torch, dev, args.seed)
    main_run = phase_main_path(torch, args.seed)
    kernels = phase_kernels(torch, dev, main_run, card, power)
    if args.profile:
        phase_profile(torch, main_run, 5, args.out)
    torch.cuda.synchronize()
    print(smi, flush=True)
    emit(kernels)
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
