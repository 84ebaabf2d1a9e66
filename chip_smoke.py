#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tendermint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--profile] [--out DIR]

Builds the port's CUDA kernels from the sources in this checkout, holds
every kernel against its plain PyTorch version, then drives the main
paths through the entry points a user calls: the node's device seam,
node.device.install_device_plane(config.GPUConfig()), which installs
crypto.gpu_verifier and ops.merkle_kernel, and
types.validation.verify_commit on a 10,000-validator ed25519 Commit
(the north-star size), verify_commit_light on a 150-validator Commit,
and a 10,000-validator Commit with one bad signature that must be
rejected at that index; then the same on mixed Commits, 5,000 ed25519
and 5,000 sr25519 validators (75 + 75 for the light one), and the mixed
10k Commit once through the hybrid program; then phase host_path holds
the host path of a Commit against its references on the card's host:
the sign-bytes spliced in C against the Python splice on both 10k
Commits, the vector plans of types/validation.py against its scalar loop
(outcome, message and launches; clean, with a bad signature, a nil vote
and too little power) on both 10k Commits and both 150-validator ones,
and the merlin challenges of 5,000 sr25519 signatures in one C call
against a call a signature; then BASELINE.md config 5
whole (phase config5): with crypto.gpu_verifier and ops.merkle_kernel
installed, the merkle roots of the mixed 10k validator set, of its
Commit and of a block of 10,000 transactions (100-300 bytes), its
verify_commit, and the 10,000 transactions' inclusion proofs in one
crypto.merkle.verify_proofs_batch. Each of these phases fails when the
device plane contained a fault or sent a signature to the CPU. Then
phase min_batch times one device window against the native CPU batch at
1-512 signatures of each key type (the crossovers the default gate comes
from), and phase fault_containment injects a launch error, a gather hang
past a 2 s deadline, a short bitmap and a flipped lane into one
2048-signature window of each key type and checks each is contained
(the same bitmap, the batch marked, the breaker open, the next batch on
the CPU, the probe closing the breaker), checks that a window dispatched
on a side stream, its kernels held back by a sleep on that stream, is
gathered after them and not contained as a fault, then times the mixed
10k Commit on the CPU plane alone. Phase config4 drives BASELINE.md
config 4 through the light client with the device plane installed: a
fresh sequential client syncs a 1,024-header chain of 150 validators in
merged windows of 32 commits (windows, X1 and K2 launches counted for the
sync, for one merged window and for the sync a commit at a time; every
header stored, no fault), is timed as headers/s merged, a commit at a
time and at windows of 8 and 16, rejects a signature flipped in the
middle of its second window with that commit's own error and nothing
above it stored, and syncs a mixed 75 + 75 chain of 256 headers with X3
in merged windows. Phase vote_path drives the consensus vote path with
the device plane installed: one height's prevotes and precommits for
one block, at 150 ed25519 validators and at the 10k mixed set, as
VoteMessage wire bytes with a forged signature of each key type, a
63-byte signature, a vote of another height, an index past the set, a
duplicate and an equivocation mixed in, decoded and queued in bursts of
256 into a consensus.state.ConsensusState: every vote gets the JAX
package's outcome, +2/3 comes at the quorum's vote count, the cache
holds exactly the valid triples, each burst and key type with at least
32 signatures to verify launches one window (X1 and K2, or X3), the
commit of the precommits verifies; timed as votes/s, ms a burst by
stage, the device's busy time and idle share, and with the cache
disabled; the 150 set in bursts of 16 launches nothing; and X1, K2 and
X3 are held against their plain versions on the path's 128- and
512-wide windows (the kernels line's `vote_path`). Phase block_exec
drives block execution, state.execution.BlockExecutor.apply_block on the
kvstore app, with the device plane installed: three blocks of 10,000
kvstore transactions at the mixed 10k set, each LastCommit signed by
every validator, on a fresh node with SqliteKV stores; each block's
launches equal a rule computed from the block (X1 and K2, X3 windows for
the LastCommit, one X4 root a root of 512 leaves or more); a block whose
LastCommit has one sr25519 signature flipped is refused and leaves the
stores as they were; apply_block is timed at heights 2-3 over five
fresh replays, by stage, with the device's busy time and idle share;
and the same chain on the plane uninstalled gives the same app hash,
state, results hash and ABCI responses at every height, and the same
refusal (the kernels line's `block_exec`). Keys, key types, messages,
timestamps, signing witnesses, chains, votes and transactions come from
--seed (made by tendermint_tpu_torch.workloads).

Before the main paths, every kernel is held against its plain version:
K1 and X1 at the widest bucket, K2 also on the ZIP-215 corpus at buckets
128 and 12288 and at a width that no block of signatures divides, X1
also on rows of mixed lengths 0-300 at widths 2045 and 12288 (and
hashlib), X3 on the sr25519 corpus at buckets 128 and 2048, at width
2045 and at width 2049 with 18 zero columns (a whole block of them; and
the host oracle); X4 (SHA-256 rows) on rows of 0-200 bytes at widths
2045 and 16384 (and hashlib), its tree form on roots of 1-16,385 leaves
(against the host reduction and the level-by-level form), X5 (merkle
proofs) on all proofs of a 10,000-leaf tree, on a batch of mixed depths
and on corrupted proofs (and the host compute_root_hash).

Phases print one JSON line each. The line before the last two is the
card as nvidia-smi names it, with its power limit; the line before the
last is {"kernels": [...]} (launches in one call of the main path, the
kernel's and its plain version's times (CUDA events around the calls,
host gaps included, and the profiler's time of the kernel alone), and
the card's least time for the same work; for K2, K1 and X3 also one
launch's time and bound at each width in K2_WIDTHS / K1_WIDTHS /
X3_WIDTHS; for X1 its time per window, SASS instructions per
compression and the latency floor of one row; for X4 a root's tree launch
beside the level-by-level form's launches and the latency floor of one
thread's chain of inner hashes; for every kernel its registers, stack
frame and spill bytes from ptxas -v); the last line is {"ok": true,
"device": {...}}. Any failed phase raises and the script exits non-zero
without that line. It exits non-zero at once when CUDA is not available
or when the package is not beside it. With --profile, each 10k Commit's
verify_commit is broken down by stage and by kernel, on the vector plans
and then on the scalar loop (the phases named *_scalar).
"""

from __future__ import annotations

import argparse
import contextlib
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
# X3, per signature: two ristretto decodes of 257 squarings (pow_p58's
# 251, v^2, v3^2, r^2 in sqrt_ratio_m1, s^2, u1^2, u2^2) and 24
# multiplies (pow_p58's 11, v3, v7, r, v r^2, r sqrt(-1), and d u1^2,
# v u2^2, den_x, den_y (2), x, y, t; with u = 1, u v3, u v7 and
# -u sqrt(-1) cost nothing, though the kernel multiplies them), K1's
# table and windows, no cofactor, and 4 multiplies for the equality.
SQ_X3, MUL_X3 = 2 * 257 + SQ_K1, 2 * 24 + MUL_K1 + 4
PRODUCTS_PER_SQ, PRODUCTS_PER_MUL, INSTR_PER_PRODUCT = 15, 25, 4


def field_instr(squarings: int, multiplies: int) -> int:
    """int32 multiply instructions of that many field squarings and
    multiplies."""
    products = squarings * PRODUCTS_PER_SQ + multiplies * PRODUCTS_PER_MUL
    return products * INSTR_PER_PRODUCT


# one SHA-512 compression: 80 rounds x ~30 32-bit instructions plus 64
# schedule steps x ~20 (64-bit rotates, adds and three-input logic ops)
INSTR_PER_SHA512_BLOCK = 80 * 30 + 64 * 20
# one SHA-256 compression, every op on 32-bit words: 64 rounds of 14 (Sigma1
# and Sigma0 three funnel shifts and one three-input xor each, Ch and Maj
# one three-input logic op each, t1 two three-input adds, e and a one
# each), 48 schedule steps of 10 (sigma0 and sigma1 two funnel shifts, a
# shift and a three-input xor each, two three-input adds), and the 8 adds
# into the state. An inner hash is two compressions.
INSTR_PER_SHA256_BLOCK = 64 * 14 + 48 * 10 + 8
# the 48 schedule steps of an inner hash's second block, which X5 reads
# from its table (csrc/sha256_pad.cuh) instead
INSTR_SHA256_PAD_SCHEDULE = 48 * 10

# each wrapper's kernel as the profiler names it
KERNEL_NAMES = {
    "sha512_ram": "sha512_ram_kernel",
    "sha512_rows": "sha512_rows_kernel",
    "ed25519_verify_tile": "verify_tile_kernel",
    "ed25519_dual_mult": "dual_mult_kernel",
    "sr25519_verify": "sr25519_verify_kernel",
    "sha256_rows": "sha256_rows_kernel",
    "sha256_tree": "sha256_tree_kernel",
    "merkle_proofs": "merkle_proofs_kernel",
}

# the widest bucket (config.DEFAULT_BUCKET_SIZES), the width the kernels
# are held against their plain versions at
WIDE = 12288
# the widths each ed25519 kernel is timed at, one launch each
K2_WIDTHS = (128, 512, 2048, WIDE)
K1_WIDTHS = (2048, WIDE)
# X3's (and the buckets of its corpus check): the light commit's bucket
# and the streaming window
X3_WIDTHS = (128, 2048)
# an X3 width past a whole block (2049: the last block holds one
# signature), with its last 18 columns zero, a whole block of them
X3_PADDED, X3_ZEROS = 2049, 18

CHAIN_ID = "chip-smoke-chain"
HEIGHT = 1234
# the north-star commit (BASELINE.md config 5) and the timed repetitions
N_VALIDATORS = 10_000
# the light-client commit (BASELINE.md config 3)
LIGHT_VALIDATORS = 150
REPS = 20
# X4 against its plain version and hashlib: message lengths either side of
# the one/two-block edge behind a prefix byte (55/56), a 32-byte tx hash
# (33 with the leaf prefix), the inner node's 64 (65), three and four
# blocks; at a width no block of threads divides and at a 16k-leaf level
X4_LENGTHS = (0, 1, 31, 32, 33, 55, 56, 63, 64, 65, 119, 200)
X4_WIDTHS = (2045, 16384)
# tree sizes: 1 (no launch), small odd trees, both sides of the tree
# kernel's 128-leaf blocks, of 512 (the install gate), of 1024 and of
# 2^14, and 10,000 (config 5)
TREE_SIZES = (1, 2, 3, 5, 13, 127, 128, 129, 511, 512, 513, 1023, 1024,
              1025, 10_000, 16_383, 16_384, 16_385)
# config 5's block of transactions and their lengths in bytes
N_TXS = 10_000
TX_LENGTHS = (100, 300)
# repetitions of a host-only merkle reference (hashlib), for scale
HOST_REPS = 5


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


# profiler sessions device_ms takes at most: torch.profiler on an H100
# host has dropped kernel records at random (seen: 48 of 50 K2 records in
# one session, 4 and 0 of X5's 10 in two others, while every launch's
# cudaLaunchKernel was recorded)
PROFILER_SESSIONS = 3


def device_ms(torch, fn, reps: int, kernel: str, launches: int):
    """(device ms per call of fn, records seen per session) of the
    kernels whose name holds `kernel`, from torch.profiler over `reps`
    calls after one warm-up: the kernels' own time, without the host's
    gaps between launches that CUDA events around the calls include. fn
    launches the kernel `launches` times a call. The first session that
    holds every record gives the time; when none of PROFILER_SESSIONS
    does, the fullest one's mean time per record, times reps * launches.
    Raises when no session saw the kernel."""
    from torch.profiler import ProfilerActivity, profile

    want = reps * launches
    fn()
    torch.cuda.synchronize()
    seen, best = [], (0, 0.0)
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages() if kernel in e.key]
        n = sum(e.count for e in mine)
        seen.append(n)
        best = max(best, (n, sum(e.self_device_time_total for e in mine)))
        if n == want:
            break
    n, total_us = best
    if n == 0:
        raise AssertionError(f"the profiler saw no {kernel} on the card")
    return total_us / n * want / 1e3 / reps, seen


def ptxas_resources(log: str, entry: str = "") -> dict:
    """Registers of the source's entry kernels, and the largest stack
    frame and spill bytes over all of its functions, from `ptxas -v`;
    only those of the entry kernels whose name holds `entry`."""
    regs, stack, st, ld = [], [0], [0], [0]
    sections = re.split(r"(?=ptxas info\s+: Compiling entry function)", log)
    picked = [sec for sec in sections if entry in sec.split("\n", 1)[0]]
    if entry and not picked:
        raise AssertionError(f"ptxas -v reports no entry kernel {entry}")
    for line in "\n".join(picked).splitlines():
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


def _counted_modules():
    from tendermint_tpu_torch.ops import ed25519_cuda, merkle_kernel
    from tendermint_tpu_torch.ops import sha256_kernel, sha512_kernel
    from tendermint_tpu_torch.ops import sr25519_cuda

    return (
        ed25519_cuda,
        sha512_kernel,
        sr25519_cuda,
        sha256_kernel,
        merkle_kernel,
    )


def reset_launches() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def launches() -> dict:
    out = {}
    for mod in _counted_modules():
        out.update(mod.LAUNCHES)
    return out


# -- commits built with the port's own types --


def build_commit(n: int, seed: int, n_sr: int = 0, timings=None):
    """workloads.build_commit at this script's chain and height."""
    from tendermint_tpu_torch.workloads import build_commit as build

    return build(n, seed, CHAIN_ID, HEIGHT, n_sr, timings)


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


def phase_report(torch, out_dir: str) -> dict:
    """Build the kernels and report the toolchain; returns the SASS
    counts of the probes."""
    from tendermint_tpu_torch.ops import build, sass_count

    t0 = time.perf_counter()
    build.kernels()
    seconds = time.perf_counter() - t0
    rep = build.build_report()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for stem, log in rep["ptxas"].items():
            f.write(f"== {stem}\n{log}\n")
    # one field multiply and squaring per radix considered, one SHA-512
    # compression as X1 has it and as it had it, one SHA-256 compression
    # and inner hash as X4 and X5 have them
    sass = sass_count.count()
    emit(
        {
            "phase": "report",
            "nvidia_smi": nvidia_smi_line(),
            "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "nvcc": nvcc_version(),
            "build_seconds": seconds,
            "libraries": sorted(rep["libraries"]),
            "sass": sass,
        }
    )
    return sass


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


def ragged_rows(torch, dev, n: int, max_len: int, seed: int):
    """Seeded sig (64, n) and pk (32, n) rows and n messages of lengths
    0..max_len, as sha512_ragged takes them: the flat buffer starts the
    first message 3 bytes past its 16-byte aligned start. Returns the
    device tensors and the host messages."""
    rng = np.random.default_rng(seed)
    sig = rng.integers(0, 256, (64, n), dtype=np.uint8)
    pk = rng.integers(0, 256, (32, n), dtype=np.uint8)
    lens = rng.integers(0, max_len + 1, n)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32) + 3
    flat = rng.integers(0, 256, -(-(int(off[-1]) + 1) // 16) * 16, np.uint8)
    msgs = [flat[off[i] : off[i + 1]].tobytes() for i in range(n)]
    tensors = [torch.from_numpy(a).to(dev) for a in (sig, pk, flat, off)]
    return tensors, msgs


def hashlib_ram(sig, pk, msgs) -> np.ndarray:
    """(64, n) SHA-512(R || A || M) of host (64, n) / (32, n) rows."""
    cols = [
        hashlib.sha512(sig[:32, i].tobytes() + pk[:, i].tobytes() + m).digest()
        for i, m in enumerate(msgs)
    ]
    return np.frombuffer(b"".join(cols), np.uint8).reshape(-1, 64).T


def phase_x1_ragged(torch, dev, seed: int) -> None:
    """X1's ragged entry against its plain version and hashlib: mixed
    message lengths 0-300 in one launch, at a width no block of rows
    divides and at the widest bucket."""
    from tendermint_tpu_torch.ops import sha512_kernel as S

    out = {}
    for n in (RAGGED, WIDE):
        (sig, pk, flat, off), msgs = ragged_rows(torch, dev, n, 300, seed + n)
        got = S.sha512_ragged(sig, pk, flat, off, 300).cpu().numpy()
        plain = S.sha512_ragged_plain(sig, pk, flat, off).cpu().numpy()
        ref = hashlib_ram(sig.cpu().numpy(), pk.cpu().numpy(), msgs)
        if not (np.array_equal(got, plain) and np.array_equal(got, ref)):
            raise AssertionError(f"X1 ragged digests differ at width {n}")
        out[str(n)] = {"lengths": len({len(m) for m in msgs})}
    emit({"phase": "x1_ragged_vs_plain_and_hashlib", "widths": out, "ok": True})


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


def phase_sr25519_tile(torch, dev, seed: int) -> None:
    """X3 against its plain version and the host oracle, bit for bit, on
    the sr25519 corpus at buckets 128 and 2048, at the width RAGGED that
    no block divides (PAD zero lanes at its end) and at X3_PADDED (its
    last X3_ZEROS columns zero: every lane of a whole block, and of the
    last block's one signature, runs on padding): the kernel on uint8 and
    on int32 rows, the plain version on every lane, the tile and hybrid
    programs' bitmaps against the oracle's."""
    from tendermint_tpu_torch.crypto import sr25519_corpus
    from tendermint_tpu_torch.ops import sr25519_cuda as X
    from tendermint_tpu_torch.ops import sr25519_kernel as SK

    triples = sr25519_corpus.corpus(seed + 3)
    want = np.array(sr25519_corpus.expected(triples))
    out = {}
    for sizes, count in [([w], w - w // 16) for w in X3_WIDTHS] + [
        ([RAGGED], RAGGED - PAD),
        ([X3_PADDED], X3_PADDED - X3_ZEROS),
    ]:
        reps = -(-count // len(triples))
        tr = (triples * reps)[:count]
        exp = np.tile(want, reps)[:count]
        pks, msgs, sigs = (list(x) for x in zip(*tr))
        verifier = SK.Sr25519Verifier(bucket_sizes=sizes, device=dev)
        w = verifier.upload(pks, msgs, sigs)
        width = w.pk_b.shape[1]
        if width != sizes[0]:
            raise AssertionError(f"packed width {width} != {sizes[0]}")
        rows = (w.pk_b, w.sig_b, w.k_b)
        kern = X.verify_sr(*rows).cpu().numpy()
        as_int32 = X.verify_sr(*(r.int() for r in rows)).cpu().numpy()
        plain = SK._verify_tile_sr(*rows).cpu().numpy()
        hybrid = SK.Sr25519Verifier(
            bucket_sizes=sizes, device=dev, program="hybrid"
        ).verify(pks, msgs, sigs)
        checks = {
            "kernel_eq_plain_all_lanes": np.array_equal(kern, plain),
            "int32_rows_eq_uint8": np.array_equal(kern, as_int32),
            "kernel_eq_oracle": np.array_equal(kern[:count] & w.size_ok, exp),
            "tile_eq_oracle": np.array_equal(
                verifier.verify(pks, msgs, sigs), exp
            ),
            "hybrid_eq_oracle": np.array_equal(hybrid, exp),
            "padding_lanes_false": not kern[count:].any(),
        }
        if not all(checks.values()):
            raise AssertionError(f"X3 corpus check at {width}: {checks}")
        out[str(width)] = {
            "n": count,
            "valid": int(exp.sum()),
            "malformed": int((~w.size_ok).sum()),
        }
    emit(
        {
            "phase": "sr25519_tile",
            "corpus": len(triples),
            "widths": out,
            "ok": True,
        }
    )


def settle_probes(timeout_s: float = 60.0) -> None:
    """Wait until no breaker probe is in flight. install() warms the
    sr25519 single route off its own thread; until that probe reports,
    its breaker state (and, under min_batch 1, its device verify) may
    land in whichever call is counted next."""
    from tendermint_tpu_torch.crypto import breaker, gpu_verifier

    deadline = time.monotonic() + timeout_s
    for route in gpu_verifier.ROUTES:
        b = breaker.breaker_for(route)
        while b.probe_in_flight():
            if time.monotonic() > deadline:
                raise AssertionError(f"the {route} probe is still in flight")
            time.sleep(0.001)


def assert_no_fault(before: dict, after: dict, where: str) -> None:
    """A main path contains no device fault and sends nothing to the
    CPU: a fault the plane contained there would hide in its numbers."""
    for key in ("faults", "rerouted_sigs"):
        if after[key] != before[key]:
            raise AssertionError(
                f"{where}: {key} rose by {after[key] - before[key]}"
            )


def count_one_call(fn, expect: dict, outside: dict = None) -> dict:
    """Launch counts of one call of fn, zeroed just before it and read
    just after, in all and per key type. For the call each verifier
    class's dispatch() is wrapped to read the counters before and after
    it (the wrapper only reads them), so a launch is charged to the key
    type whose window made it. expect: {key type: (windows the call must
    dispatch, {kernel: launches that key type's dispatches must make})};
    every other kernel must not launch in a dispatch, and outside the
    dispatches each kernel must launch exactly outside.get(kernel, 0)
    times (the merkle roots of a block's execution)."""
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
    from tendermint_tpu_torch.ops.sr25519_kernel import Sr25519Verifier

    by_type: dict = {}

    def charged(dispatch, key_type):
        def wrapper(self, *args):
            before = launches()
            handle = dispatch(self, *args)
            mine = by_type.setdefault(key_type, dict.fromkeys(before, 0))
            for name, n in launches().items():
                mine[name] += n - before[name]
            return handle

        return wrapper

    classes = {Ed25519Verifier: "ed25519", Sr25519Verifier: "sr25519"}
    originals = {cls: cls.__dict__["dispatch"] for cls in classes}
    before = gpu_verifier.stats()
    for cls, key_type in classes.items():
        cls.dispatch = charged(originals[cls], key_type)
    try:
        reset_launches()
        fn()
        counts = launches()
    finally:
        for cls, dispatch in originals.items():
            cls.dispatch = dispatch
    after = gpu_verifier.stats()
    assert_no_fault(before, after, "one counted call")
    for key_type, (want, _kernels) in expect.items():
        got = after[f"batches_{key_type}"] - before[f"batches_{key_type}"]
        if got != want:
            raise AssertionError(f"{got} {key_type} windows, not {want}")
    for key_type in set(by_type) | set(expect):
        want = expect.get(key_type, (0, {}))[1]
        for name, got in by_type.get(key_type, {}).items():
            if got != want.get(name, 0):
                raise AssertionError(
                    f"{key_type} windows launched {name} {got} times, "
                    f"not {want.get(name, 0)}"
                )
    for name, got in counts.items():
        charged_sum = sum(t.get(name, 0) for t in by_type.values())
        if got - charged_sum != (outside or {}).get(name, 0):
            raise AssertionError(
                f"{name}: {got - charged_sum} launches outside a dispatch, "
                f"not {(outside or {}).get(name, 0)}"
            )
    return {**counts, "by_key_type": by_type}


def phase_x1_latency() -> dict:
    """The latency floor of an X1 launch at the streaming window: SM
    cycles and nanoseconds of one row's two compressions, from clock64
    and %globaltimer stamps in a copy of the kernel."""
    from tendermint_tpu_torch.crypto.gpu_verifier import (
        GpuEd25519BatchVerifier,
    )
    from tendermint_tpu_torch.ops import x1_latency

    floor = x1_latency.measure(GpuEd25519BatchVerifier.STREAM_CHUNK)
    emit({"phase": "x1_latency_floor", **floor})
    return floor


def phase_x4_latency() -> dict:
    """The latency floor of a 10,000-leaf root: SM cycles and nanoseconds
    of one thread's chain of its tree_levels(N_TXS) dependent inner
    hashes, alone on the card, the least of x4_latency's reads."""
    from tendermint_tpu_torch.ops import x4_latency

    floor = x4_latency.measure(tree_levels(N_TXS))
    emit({"phase": "x4_latency_floor", **floor})
    return floor


def phase_x5_latency() -> dict:
    """The latency floor of X5 on the block's proofs: one thread's chain
    of tree_levels(N_TXS) dependent sha256_inner_pad hashes (the deepest
    proof's walk), alone on the card, the least of x4_latency's reads."""
    from tendermint_tpu_torch.ops import x4_latency

    floor = x4_latency.measure(tree_levels(N_TXS), pad=True)
    emit({"phase": "x5_latency_floor", **floor})
    return floor


def phase_main_path(torch, seed: int) -> dict:
    """The entry points a user calls, on the card, with launch counts
    zeroed just before each path and read just after."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.node.device import (
        install_device_plane,
        uninstall_device_plane,
    )
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.gpu_verifier import (
        GpuEd25519BatchVerifier,
    )
    from tendermint_tpu_torch.types.validation import (
        InvalidCommitError,
        verify_commit,
        verify_commit_light,
    )

    t0 = time.perf_counter()
    vals, bid, commit = build_commit(N_VALIDATORS, seed)
    vals150, bid150, commit150 = build_commit(LIGHT_VALIDATORS, seed + 1)
    lengths = sorted({len(m) for m in commit.sign_bytes_batch(CHAIN_ID)})
    if len(lengths) < 2:
        raise AssertionError("the commit's sign-bytes share one length")
    build_s = time.perf_counter() - t0
    step = GpuEd25519BatchVerifier.STREAM_CHUNK
    windows = -(-N_VALIDATORS // step)

    # the 150-validator commit through the host oracle first: the
    # reference outcome the device path must reproduce
    verify_commit_light(CHAIN_ID, vals150, bid150, HEIGHT, commit150)

    def full():
        verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)

    def light():
        verify_commit_light(CHAIN_ID, vals150, bid150, HEIGHT, commit150)

    # the light commit verifies the first > 2/3 of its equal-power
    # validators: one window when that reaches the gate
    cfg = GPUConfig()
    light_w = int(2 * LIGHT_VALIDATORS // 3 + 1 >= cfg.min_batch_size)
    start = gpu_verifier.stats()
    install_device_plane(cfg)
    settle_probes()
    try:
        # one call each, counted: X1 and K2 once per dispatched window
        def tile(w):
            return {"sha512_ram": w, "ed25519_verify_tile": w}

        per_call = count_one_call(full, {"ed25519": (windows, tile(windows))})
        per_call_light = count_one_call(light, {"ed25519": (light_w, tile(light_w))})
        p50, p95 = time_commit(full, REPS)
        l50, l95 = time_commit(light, REPS)
        bad_idx = N_VALIDATORS * 7 // 9
        good_sig = commit.signatures[bad_idx].signature
        commit.signatures[bad_idx].signature = (
            good_sig[:9] + bytes([good_sig[9] ^ 0x20]) + good_sig[10:]
        )
        try:
            full()
        except InvalidCommitError as e:
            if f"wrong signature (#{bad_idx})" not in str(e):
                raise AssertionError(f"rejected at the wrong index: {e}")
        else:
            raise AssertionError("the corrupted commit verified")
        finally:
            commit.signatures[bad_idx].signature = good_sig
        stats = gpu_verifier.stats()
        assert_no_fault(start, stats, "main_path")
    finally:
        uninstall_device_plane()

    # the hybrid program: plain preparation and compare around kernel K1
    gpu_verifier.install(program="hybrid")
    settle_probes()
    try:
        hybrid = count_one_call(
            full,
            {
                "ed25519": (
                    windows,
                    {"sha512_ram": windows, "ed25519_dual_mult": windows},
                )
            },
        )
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
            "launches_per_verify_commit": per_call,
            "launches_per_verify_commit_light": per_call_light,
            "launches_per_hybrid_verify_commit": hybrid,
            "verifier_stats": stats,
            "ok": True,
        }
    )
    return {
        "vals": vals,
        "commit": commit,
        "tile": per_call,
        "hybrid": hybrid,
        "keys": (N_VALIDATORS, seed, 0),
        "light": (vals150, commit150),
        "light_keys": (LIGHT_VALIDATORS, seed + 1, 0),
    }


def phase_sr25519_main_path(torch, seed: int) -> dict:
    """The same entry points on mixed commits (BASELINE.md config 5's
    shape): 5,000 ed25519 and 5,000 sr25519 validators, each key type
    one batch verifier streaming its own windows, and 75 + 75 for the
    light commit; launch counts zeroed just before each path and read
    just after."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.node.device import (
        install_device_plane,
        uninstall_device_plane,
    )
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.gpu_verifier import (
        GpuSr25519BatchVerifier,
    )
    from tendermint_tpu_torch.types.validation import (
        InvalidCommitError,
        verify_commit,
        verify_commit_light,
    )

    n_sr = N_VALIDATORS // 2
    t0 = time.perf_counter()
    timings = {}
    vals, bid, commit = build_commit(N_VALIDATORS, seed, n_sr, timings)
    vals150, bid150, commit150 = build_commit(
        LIGHT_VALIDATORS, seed + 1, LIGHT_VALIDATORS // 2
    )
    build_s = time.perf_counter() - t0
    kinds = [v.pub_key.type() for v in vals.validators]
    if kinds.count("sr25519") != n_sr:
        raise AssertionError(f"{kinds.count('sr25519')} sr25519 validators")
    step = GpuSr25519BatchVerifier.STREAM_CHUNK
    w_sr = -(-n_sr // step)
    w_ed = -(-(N_VALIDATORS - n_sr) // step)

    # the light commit through the host oracles first: the reference
    # outcome the device path must reproduce
    verify_commit_light(CHAIN_ID, vals150, bid150, HEIGHT, commit150)

    def full():
        verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)

    def light():
        verify_commit_light(CHAIN_ID, vals150, bid150, HEIGHT, commit150)

    def tile(ed, sr):
        return {
            "ed25519": (ed, {"sha512_ram": ed, "ed25519_verify_tile": ed}),
            "sr25519": (sr, {"sr25519_verify": sr}),
        }

    # the light commit verifies the first > 2/3 of its equal-power
    # validators; a key type's share goes to the card as one window when
    # it reaches the gate, else to the native CPU plane
    cfg = GPUConfig()
    first = [v.pub_key.type() for v in vals150.validators][: 2 * LIGHT_VALIDATORS // 3 + 1]
    light_w = {
        kt: int(first.count(kt) >= cfg.min_batch_size) for kt in gpu_verifier.KEY_TYPES
    }
    start = gpu_verifier.stats()
    install_device_plane(cfg)
    settle_probes()
    try:
        per_call = count_one_call(full, tile(w_ed, w_sr))
        per_call_light = count_one_call(light, tile(light_w["ed25519"], light_w["sr25519"]))
        p50, p95 = time_commit(full, REPS)
        l50, l95 = time_commit(light, REPS)
        # one bad sr25519 signature: the reference error at its index
        bad_idx = next(
            i
            for i in range(N_VALIDATORS * 5 // 9, N_VALIDATORS)
            if kinds[i] == "sr25519"
        )
        good_sig = commit.signatures[bad_idx].signature
        bad_sig = good_sig[:9] + bytes([good_sig[9] ^ 0x20]) + good_sig[10:]
        commit.signatures[bad_idx].signature = bad_sig
        want = f"wrong signature (#{bad_idx}): {bad_sig.hex()}"
        try:
            full()
        except InvalidCommitError as e:
            if str(e) != want:
                raise AssertionError(f"not the reference error: {e}")
        else:
            raise AssertionError("the corrupted mixed commit verified")
        finally:
            commit.signatures[bad_idx].signature = good_sig
        stats = gpu_verifier.stats()
        assert_no_fault(start, stats, "sr25519_main_path")
    finally:
        uninstall_device_plane()

    # the hybrid program: plain decode and compare around kernel K1 for
    # both key types
    gpu_verifier.install(program="hybrid")
    settle_probes()
    try:
        hybrid = count_one_call(
            full,
            {
                "ed25519": (
                    w_ed,
                    {"sha512_ram": w_ed, "ed25519_dual_mult": w_ed},
                ),
                "sr25519": (w_sr, {"ed25519_dual_mult": w_sr}),
            },
        )
    finally:
        gpu_verifier.uninstall()

    emit(
        {
            "phase": "sr25519_main_path",
            "validators": {"ed25519": N_VALIDATORS - n_sr, "sr25519": n_sr},
            "commit_build_s": build_s,
            "commit_build_10k_s": timings,
            "verify_commit_ms": {"p50": p50, "p95": p95, "reps": REPS},
            "verify_commit_light_150_ms": {
                "p50": l50,
                "p95": l95,
                "reps": REPS,
            },
            "rejected_bad_sr25519_index": bad_idx,
            "launches_per_verify_commit": per_call,
            "launches_per_verify_commit_light": per_call_light,
            "light_signatures_by_key_type": {kt: first.count(kt) for kt in gpu_verifier.KEY_TYPES},
            "light_windows_by_key_type": light_w,
            "launches_per_hybrid_verify_commit": hybrid,
            "verifier_stats": stats,
            "ok": True,
        }
    )
    return {
        "vals": vals,
        "commit": commit,
        "tile": per_call,
        "hybrid": hybrid,
        "p50": p50,
        "keys": (N_VALIDATORS, seed, n_sr),
        "light": (vals150, commit150),
        "light_keys": (LIGHT_VALIDATORS, seed + 1, LIGHT_VALIDATORS // 2),
    }


# -- the host path of a Commit: C sign-bytes, the vector plans, the
# merlin challenges of a window --

# repetitions of each host-only timing in phase host_path (median)
HOST_PATH_REPS = 7
# where phase host_path makes a signature bad and plants a nil vote: in
# a light commit both inside the first > 2/3 of its votes that the light
# plans visit; in a 10k one the bad signature past them (verify_commit
# alone meets it)
LIGHT_BAD, LIGHT_NIL = 20, 10
WIDE_BAD, WIDE_NIL = N_VALIDATORS * 7 // 9, N_VALIDATORS // 3


def outcome(fn) -> tuple:
    """("ok", "") after fn(), or the type and message of what it raised."""
    try:
        fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", ""


@contextlib.contextmanager
def scalar_route():
    """types/validation.py's scalar reference loop for the block, reached
    the way a commit whose BlockIDFlags do not fit uint8 reaches it:
    Commit.block_id_flags_array() returns None."""
    from tendermint_tpu_torch.types.commit import Commit

    real = Commit.block_id_flags_array
    Commit.block_id_flags_array = lambda self: None
    try:
        yield
    finally:
        Commit.block_id_flags_array = real


def python_sign_bytes(commit) -> list:
    """Commit.sign_bytes_batch through the Python splice, which the port
    takes only for timestamps outside int64."""
    sigs = commit.signatures
    out = [None] * len(sigs)
    for for_block in (True, False):
        idxs = [
            i
            for i, cs in enumerate(sigs)
            if not cs.is_absent() and cs.is_for_block() == for_block
        ]
        tpl = commit._template(CHAIN_ID, for_block)
        rows = tpl._sign_bytes_python([sigs[i].timestamp_ns for i in idxs])
        for i, row in zip(idxs, rows):
            out[i] = row
    return out


def host_ms(fn, reps: int = HOST_PATH_REPS) -> float:
    """Median host-clock ms of fn() over reps calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def reference_plan(vals, commit, entry: str, bad: int):
    """(outcome, {key type: windows}) an entry point must give, from the
    reference's rule written out here apart from the port's plans:
    verify_commit verifies every non-absent vote and counts the for-block
    ones; the light and trusting checks (the trusted set being the
    commit's own here) verify the for-block votes in index order until
    the tally first exceeds 2/3 (1/3) of the power. A tally that never
    does raises before any signature is checked; else the bad signature
    fails if it was verified. Each key type's verified signatures go to
    the card in STREAM_CHUNK windows when they reach the min-batch gate."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto.gpu_verifier import _GpuBatchVerifier

    total = sum(v.voting_power for v in vals.validators)
    needed = total * (1 if entry == "trusting" else 2) // 3
    tally, picked = 0, []
    for i, cs in enumerate(commit.signatures):
        if entry == "verify_commit":
            if cs.is_absent():
                continue
            picked.append(i)
            tally += vals.validators[i].voting_power if cs.is_for_block() else 0
            continue
        if not cs.is_for_block():
            continue
        picked.append(i)
        tally += vals.validators[i].voting_power
        if tally > needed:
            break
    if tally <= needed:
        return (
            (
                "NotEnoughVotingPowerError",
                f"invalid commit -- insufficient voting power: got {tally}, "
                f"needed more than {needed}",
            ),
            {},
        )
    gate, step = GPUConfig().min_batch_size, _GpuBatchVerifier.STREAM_CHUNK
    counts: dict = {}
    for i in picked:
        kt = vals.validators[i].pub_key.type()
        counts[kt] = counts.get(kt, 0) + 1
    windows = {kt: -(-c // step) if c >= gate else 0 for kt, c in counts.items()}
    if bad in picked:
        sig = commit.signatures[bad].signature
        return ("InvalidCommitError", f"wrong signature (#{bad}): {sig.hex()}"), windows
    return ("ok", ""), windows


@contextlib.contextmanager
def commit_variant(commit, keys, at: tuple, name: str, seed: int):
    """The commit as it is ("clean"), with the signature at at[0] made
    bad, with the for-block vote at at[1] replaced by a nil vote its
    validator signed, or with the first third of its votes absent (too
    little power), for the block; yields the bad signature's index (or
    -1), then restores the commit. keys: seeded_keys' arguments."""
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from tendermint_tpu_torch.types.commit import CommitSig
    from tendermint_tpu_torch.types.vote import Vote
    from tendermint_tpu_torch.workloads import seeded_keys

    sigs = commit.signatures
    n = len(sigs)
    saved = list(sigs)
    bad = -1
    if name == "bad_signature":
        bad = at[0]
        good = sigs[bad]
        flipped = good.signature[:9] + bytes([good.signature[9] ^ 0x20]) + good.signature[10:]
        sigs[bad] = CommitSig.for_block(flipped, good.validator_address, good.timestamp_ns)
    elif name == "nil_vote":
        i = at[1]
        cs = sigs[i]
        privs = {p.pub_key().address(): p for p in seeded_keys(*keys)}
        priv = privs[cs.validator_address]
        vote = Vote(
            type=PRECOMMIT_TYPE,
            height=commit.height,
            round=commit.round,
            block_id=BlockID(),
            timestamp_ns=cs.timestamp_ns,
            validator_address=cs.validator_address,
            validator_index=i,
        )
        msg = vote.sign_bytes(CHAIN_ID)
        if priv.type() == "sr25519":
            sig = priv.sign(msg, rng=np.random.default_rng([seed, i]).bytes)
        else:
            sig = priv.sign(msg)
        sigs[i] = CommitSig.for_nil(sig, cs.validator_address, cs.timestamp_ns)
    elif name == "too_little_power":
        for i in range(n // 3 + 1):
            sigs[i] = CommitSig.absent()
    try:
        yield bad
    finally:
        sigs[:] = saved


HOST_PATH_VARIANTS = ("clean", "bad_signature", "nil_vote", "too_little_power")


def phase_host_path(torch, seed: int, main: dict, mixed: dict) -> dict:
    """The host path of a Commit on the card's host: the C sign-bytes
    (native/signbytes.c) against the Python splice, byte for byte, on both
    10k commits; the vector plans of types/validation.py against its
    scalar loop on the 10k ed25519 and mixed commits and on the
    150-validator (config 3) ones, each clean, with a bad signature, a nil
    vote and too little power, through verify_commit, verify_commit_light
    and verify_commit_light_trusting with the device plane installed:
    the same outcome and message as the reference rule gives, on both
    routes, and the launches each route makes counted against the
    windows that rule gives; and the merlin challenges of the mixed
    commit's 5,000 sr25519 signatures in one C call against a call a
    signature. Host ms of each pair are medians of HOST_PATH_REPS; the
    collect stage of a config-4 header (collect_commit_light on the
    150-validator ed25519 commit) on both routes too."""
    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, sr25519
    from tendermint_tpu_torch.node.device import (
        install_device_plane,
        uninstall_device_plane,
    )
    from tendermint_tpu_torch.types import validation as V

    t_phase = time.perf_counter()
    sign_bytes = {}
    for name, run in (("ed25519_10k", main), ("mixed_10k", mixed)):
        commit = run["commit"]
        rows = commit.sign_bytes_batch(CHAIN_ID)
        if rows != python_sign_bytes(commit) or None in rows:
            raise AssertionError(f"{name}: the C sign-bytes differ from the Python splice")
        sign_bytes[name] = {
            "rows": len(rows),
            "c_ms": host_ms(lambda: commit.sign_bytes_batch(CHAIN_ID)),
            "python_ms": host_ms(lambda: python_sign_bytes(commit)),
        }

    vals, commit = mixed["vals"], mixed["commit"]
    rows = commit.sign_bytes_batch(CHAIN_ID)
    sr = [i for i, v in enumerate(vals.validators) if v.pub_key.type() == "sr25519"]
    pks = [vals.validators[i].pub_key.bytes() for i in sr]
    msgs = [rows[i] for i in sr]
    rs = [commit.signatures[i].signature[:32] for i in sr]

    def singles():
        return [native.sr25519_challenge(pk, r, m) for pk, m, r in zip(pks, msgs, rs)]

    window = sr25519.challenge_rows(pks, msgs, rs)
    if [row.tobytes() for row in window] != singles():
        raise AssertionError("the window's challenges differ from single calls")
    challenges = {
        "signatures": len(sr),
        "window_ms": host_ms(lambda: sr25519.challenge_rows(pks, msgs, rs)),
        "singles_ms": host_ms(singles),
    }

    def tile(kt, w):
        if kt == "ed25519":
            return {"sha512_ram": w, "ed25519_verify_tile": w}
        return {"sr25519_verify": w}

    entries = {
        "verify_commit": lambda v, c: V.verify_commit(CHAIN_ID, v, c.block_id, HEIGHT, c),
        "verify_commit_light": lambda v, c: V.verify_commit_light(
            CHAIN_ID, v, c.block_id, HEIGHT, c
        ),
        "trusting": lambda v, c: V.verify_commit_light_trusting(
            CHAIN_ID, v, c, V.Fraction(1, 3)
        ),
    }
    wide, light = (WIDE_BAD, WIDE_NIL), (LIGHT_BAD, LIGHT_NIL)
    commits = {
        "ed25519_10k": (main["vals"], main["commit"], main["keys"], wide),
        "mixed_10k": (mixed["vals"], mixed["commit"], mixed["keys"], wide),
        "ed25519_150": (*main["light"], main["light_keys"], light),
        "mixed_150": (*mixed["light"], mixed["light_keys"], light),
    }
    plans = {}
    start = gpu_verifier.stats()
    install_device_plane(GPUConfig())
    settle_probes()
    try:
        for cname, (vals, commit, keys, at) in commits.items():
            for variant in HOST_PATH_VARIANTS:
                with commit_variant(commit, keys, at, variant, seed) as bad:
                    for ename, entry in entries.items():
                        want, windows = reference_plan(vals, commit, ename, bad)
                        expect = {
                            kt: (windows.get(kt, 0), tile(kt, windows.get(kt, 0)))
                            for kt in gpu_verifier.KEY_TYPES
                        }
                        for route in ("vector", "scalar"):
                            got = []
                            ctx = scalar_route() if route == "scalar" else contextlib.nullcontext()
                            with ctx:
                                count_one_call(
                                    lambda: got.append(outcome(lambda: entry(vals, commit))),
                                    expect,
                                )
                            if got[0] != want:
                                raise AssertionError(
                                    f"{cname} {variant} {ename} {route}: {got[0]}, not {want}"
                                )
                        plans[f"{cname}/{variant}/{ename}"] = {
                            "outcome": want[0],
                            "windows": windows,
                        }
        vals150, commit150 = main["light"]
        bid150 = commit150.block_id

        def collect():
            V.collect_commit_light(CHAIN_ID, vals150, bid150, HEIGHT, commit150)

        collect_ms = {"vector": host_ms(collect, 50)}
        with scalar_route():
            collect_ms["scalar"] = host_ms(collect, 50)
        stats = gpu_verifier.stats()
        assert_no_fault(start, stats, "host_path")
    finally:
        uninstall_device_plane()
    emit(
        {
            "phase": "host_path",
            "sign_bytes": sign_bytes,
            "challenges": challenges,
            "plans_checked": len(plans) * 2,
            "plans": plans,
            "collect_150_ms": collect_ms,
            "phase_s": time.perf_counter() - t_phase,
            "ok": True,
        }
    )
    return {"sign_bytes": sign_bytes, "challenges": challenges, "collect": collect_ms}


def count_merkle_call(fn, expect: dict):
    """fn's result and the launches of one call of it, zeroed just before
    and read just after: each kernel in expect launched exactly that many
    times, every other kernel none, and no signature window dispatched."""
    from tendermint_tpu_torch.crypto import gpu_verifier

    before = gpu_verifier.stats()
    reset_launches()
    out = fn()
    counts = launches()
    if gpu_verifier.stats() != before:
        raise AssertionError("a merkle call dispatched a signature window")
    for name, got in counts.items():
        if got != expect.get(name, 0):
            raise AssertionError(
                f"{name} launched {got} times, not {expect.get(name, 0)}"
            )
    return out, {k: v for k, v in counts.items() if v}


def tree_levels(n: int) -> int:
    """Levels of an n-leaf root: X4's level-by-level launches."""
    return (n - 1).bit_length()


def tree_launches(n: int) -> dict:
    """X4's launches of an n-leaf tree_root: one tree launch, none for one
    leaf."""
    return {"sha256_tree": 1} if n > 1 else {}


def level_loop(S, leaves):
    """The root of (n, 32) leaf hashes on the card, one launch of X4's
    level form a level: what the tree form is held against and timed
    beside."""
    level = leaves
    while level.shape[0] > 1:
        level = S.sha256_level(level)
    return level


def phase_merkle_kernels(torch, dev, seed: int) -> None:
    """X4 against its plain version and hashlib (X4_LENGTHS at X4_WIDTHS,
    with no prefix and behind 0x00 and 0x01), tree_root at TREE_SIZES (one
    tree launch, no row launch) against the host reduction and the level
    form's root (the 16,385-leaf tree's levels, odd at every level,
    against the plain version too); X5 against its plain
    version and the host compute_root_hash on all proofs of a
    10,000-leaf tree, on proofs of 3- and 64-leaf trees in one batch, and
    on corrupted proofs, each False at its own index."""
    import copy

    from tendermint_tpu_torch.crypto import merkle
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.ops import sha256_kernel as S

    rng = np.random.default_rng([seed, 256])
    for width in X4_WIDTHS:
        for length in X4_LENGTHS:
            host = rng.integers(0, 256, (width, length), dtype=np.uint8)
            rows = torch.from_numpy(host).to(dev)
            for prefix in (None, 0, 1):
                got = S.sha256_rows(rows, prefix)
                if not torch.equal(got, S.sha256_rows_plain(rows, prefix)):
                    raise AssertionError(f"X4 != plain: L={length} {prefix}")
                head = b"" if prefix is None else bytes([prefix])
                ref = b"".join(
                    hashlib.sha256(head + r.tobytes()).digest() for r in host
                )
                if got.cpu().numpy().tobytes() != ref:
                    raise AssertionError(f"X4 != hashlib: L={length} {prefix}")
    trees, by_size = {}, {}
    for n in TREE_SIZES:
        leaf_hashes = by_size[n] = [rng.bytes(32) for _ in range(n)]
        got, counts = count_merkle_call(
            lambda lh=leaf_hashes: MK.tree_root(lh, dev), tree_launches(n)
        )
        if got != merkle._reduce(leaf_hashes):
            raise AssertionError(f"tree root differs from the host's, n={n}")
        flat = bytearray(b"".join(leaf_hashes))
        leaves = torch.frombuffer(flat, dtype=torch.uint8).view(n, 32)
        by_levels = level_loop(S, leaves.to(dev))
        if by_levels.cpu().numpy().tobytes() != got:
            raise AssertionError(f"tree root differs from the level form's, n={n}")
        trees[str(n)] = counts.get("sha256_tree", 0)
    widest = b"".join(by_size[max(TREE_SIZES)])
    level = torch.frombuffer(bytearray(widest), dtype=torch.uint8)
    level = level.view(-1, 32).to(dev)
    while level.shape[0] > 1:
        nxt = S.sha256_level(level)
        if not torch.equal(nxt, S.sha256_level_plain(level)):
            raise AssertionError(f"X4 level of {level.shape[0]} != plain")
        level = nxt

    def check_x5(proofs, root, want_ok, name):
        batch = MK.pack_proofs(proofs, root)
        views = batch.to(dev)
        (roots, ok), counts = count_merkle_call(
            lambda: MK.merkle_proofs(*views), {"merkle_proofs": 1}
        )
        p_roots, p_ok = MK.verify_program_plain(*views)
        if not (torch.equal(roots, p_roots) and torch.equal(ok, p_ok)):
            raise AssertionError(f"X5 differs from its plain version: {name}")
        ok = ok.cpu().numpy()
        if ok.tolist() != list(want_ok):
            bad = np.flatnonzero(ok != np.asarray(want_ok)).tolist()
            raise AssertionError(f"X5 bitmap wrong at {bad[:8]}: {name}")
        host = roots.cpu().numpy()
        for i, p in enumerate(proofs):
            if batch.ok[i] and host[i].tobytes() != p.compute_root_hash():
                raise AssertionError(f"X5 root {i} != compute_root_hash: {name}")
        bitmap = MK.verify_proofs(proofs, root, dev)
        if bitmap.tolist() != list(want_ok):
            raise AssertionError(f"verify_proofs differs: {name}")
        return int(batch.n_aunts)

    items = [rng.bytes(int(rng.integers(1, 80))) for _ in range(N_TXS)]
    root, proofs = merkle.proofs_from_byte_slices(items)
    aunts = check_x5(proofs, root, [True] * N_TXS, "10k tree")
    root_a, pa = merkle.proofs_from_byte_slices([b"a%d" % i for i in range(3)])
    root_b, pb = merkle.proofs_from_byte_slices([b"b%d" % i for i in range(64)])
    check_x5(pa + pb, root_b, [False] * 3 + [True] * 64, "3 and 64 leaves")
    check_x5(pa + pb, root_a, [True] * 3 + [False] * 64, "3 and 64 leaves")
    bad = {}
    faults = (
        ("aunt_zeroed", lambda p: p.aunts.__setitem__(3, bytes(32))),
        ("leaf_zeroed", lambda p: setattr(p, "leaf_hash", bytes(32))),
        ("index_moved", lambda p: setattr(p, "index", p.index + 1)),
        ("aunt_dropped", lambda p: p.aunts.pop()),
        ("total_zero", lambda p: setattr(p, "total", 0)),
    )
    corrupted = list(proofs)
    for j, (name, fault) in enumerate(faults):
        i = N_TXS * (j + 1) // 7
        corrupted[i] = copy.deepcopy(proofs[i])
        fault(corrupted[i])
        bad[name] = i
    want = [i not in bad.values() for i in range(N_TXS)]
    check_x5(corrupted, root, want, "corrupted")
    emit(
        {
            "phase": "merkle_kernels",
            "x4": {
                "lengths": list(X4_LENGTHS),
                "widths": list(X4_WIDTHS),
                "prefixes": [None, 0, 1],
                "tree_sizes": list(TREE_SIZES),
                "tree_launches": trees,
            },
            "x5": {"proofs": N_TXS, "aunts": aunts, "corrupted_at": bad},
            "ok": True,
        }
    )


def block_txs(seed: int):
    """N_TXS transactions, lengths in TX_LENGTHS and bytes from the seed."""
    from tendermint_tpu_torch.workloads import block_txs as txs

    return txs(seed, N_TXS, TX_LENGTHS)


def set_root(vals) -> bytes:
    """A validator set's root as ValidatorSet.hash() computes it on a new
    set (its memo would answer a second call from the host)."""
    from tendermint_tpu_torch.crypto import merkle

    return merkle.hash_from_byte_slices([v.hash_bytes() for v in vals.validators])


def phase_config5(torch, dev, seed: int, mixed: dict) -> dict:
    """BASELINE.md config 5 through the entry points a user calls, with
    the device plane installed from its config (node/device.py
    install_device_plane(GPUConfig()): gpu_verifier and merkle_kernel):
    the roots of the mixed
    10,000-validator set, of its Commit and of a 10,000-transaction
    block, verify_commit, and all 10,000 inclusion proofs of the block's
    transactions in one verify_proofs_batch. Roots against the host
    oracle's; the bitmap all True, and False at exactly one index with
    one aunt corrupted; launches counted per call (X4's tree kernel once
    a root above the gate and never below it, X5 once a batch, no other
    kernel); no call above its gate reaches the host reduction. Host
    times of each call (p50/p95 over REPS), of the proof batch's packing
    alone, and of hashlib's root and batch on this host for scale."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.node.device import (
        install_device_plane,
        uninstall_device_plane,
    )
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle
    from tendermint_tpu_torch.crypto.gpu_verifier import (
        GpuSr25519BatchVerifier,
    )
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.types.tx import tx_hash, txs_hash, txs_proofs
    from tendermint_tpu_torch.types.validation import verify_commit
    from tendermint_tpu_torch.types.validator import ValidatorSet

    vals, commit = mixed["vals"], mixed["commit"]
    bid = commit.block_id
    small = ValidatorSet(vals.validators[:LIGHT_VALIDATORS])
    txs = block_txs(seed)
    leaves = [tx_hash(t) for t in txs]
    # the host oracle, hooks not installed
    if merkle._device_root_hook is not None:
        raise AssertionError("a merkle hook is installed before config5")
    want = {
        "validator_set": vals.hash(),
        "commit": commit.hash(),
        "data": txs_hash(txs),
        "small_set": small.hash(),
    }
    data_hash = want["data"]
    t0 = time.perf_counter()
    proofs = txs_proofs(txs)
    txs_proofs_host_ms = (time.perf_counter() - t0) * 1e3
    tx_leaf_hashes = [merkle.leaf_hash(x) for x in leaves]
    host_root = time_commit(lambda: merkle._reduce(tx_leaf_hashes), HOST_REPS)
    host_batch = time_commit(
        lambda: merkle.verify_proofs_batch(proofs, data_hash, leaves),
        HOST_REPS,
    )

    n_sr = sum(v.pub_key.type() == "sr25519" for v in vals.validators)
    step = GpuSr25519BatchVerifier.STREAM_CHUNK
    w_sr, w_ed = -(-n_sr // step), -(-(len(vals.validators) - n_sr) // step)
    n_vals, n_sigs = len(vals.validators), len(commit.signatures)
    # the host paths the hooks replace, counted while they are installed
    host_calls = {"reduce": 0, "compute_root_hash": 0}

    def counting(fn, key):
        def wrapper(*args, **kwargs):
            host_calls[key] += 1
            return fn(*args, **kwargs)

        return wrapper

    calls = {
        "validator_set_hash": (lambda: set_root(vals), tree_launches(n_vals)),
        "commit_hash": (commit.hash, tree_launches(n_sigs)),
        "txs_hash": (lambda: txs_hash(txs), tree_launches(N_TXS)),
        "verify_proofs_batch": (
            lambda: merkle.verify_proofs_batch(proofs, data_hash, leaves),
            {"merkle_proofs": 1},
        ),
    }
    start = gpu_verifier.stats()
    install_device_plane(GPUConfig())
    settle_probes()
    reduce, compute = merkle._reduce, merkle.Proof.compute_root_hash
    merkle._reduce = counting(reduce, "reduce")
    merkle.Proof.compute_root_hash = counting(compute, "compute_root_hash")
    try:
        per_call, got = {}, {}
        for name, (fn, expect) in calls.items():
            got[name], per_call[name] = count_merkle_call(fn, expect)
        if host_calls != {"reduce": 0, "compute_root_hash": 0}:
            raise AssertionError(f"a device call ran the host path: {host_calls}")
        got_small, per_call["small_set_hash"] = count_merkle_call(
            lambda: set_root(small), {}
        )
        # the host reduction recurses through the wrapped name
        small_reduces = host_calls["reduce"]
        if not small_reduces:
            raise AssertionError("the small set's root did not stay on the host")
        per_call["txs_proofs"] = count_merkle_call(
            lambda: txs_proofs(txs), tree_launches(N_TXS)
        )[1]
        per_call["verify_commit"] = count_one_call(
            lambda: verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit),
            {
                "ed25519": (w_ed, {"sha512_ram": w_ed, "ed25519_verify_tile": w_ed}),
                "sr25519": (w_sr, {"sr25519_verify": w_sr}),
            },
        )
        roots = {
            "validator_set": got["validator_set_hash"],
            "commit": got["commit_hash"],
            "data": got["txs_hash"],
            "small_set": got_small,
        }
        if roots != want:
            raise AssertionError(f"roots differ from the host's: {roots}")
        if not got["verify_proofs_batch"].all():
            raise AssertionError("a valid tx proof was rejected")
        bad_idx = N_TXS * 5 // 11
        bad_proofs = list(proofs)
        bad_proofs[bad_idx] = merkle.Proof(
            total=proofs[bad_idx].total,
            index=proofs[bad_idx].index,
            leaf_hash=proofs[bad_idx].leaf_hash,
            aunts=list(proofs[bad_idx].aunts),
        )
        aunt = bad_proofs[bad_idx].aunts[5]
        bad_proofs[bad_idx].aunts[5] = aunt[:7] + bytes([aunt[7] ^ 1]) + aunt[8:]
        bitmap = merkle.verify_proofs_batch(bad_proofs, data_hash, leaves)
        if np.flatnonzero(~bitmap).tolist() != [bad_idx]:
            raise AssertionError("the corrupted aunt was not caught alone")
        timings = {}
        for name, (fn, _expect) in calls.items():
            timings[name] = time_commit(fn, REPS)
        timings["verify_commit"] = time_commit(
            lambda: verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit), REPS
        )
        timings["pack_proofs"] = time_commit(
            lambda: MK.pack_proofs(proofs, data_hash), REPS
        )
        batch = MK.pack_proofs(proofs, data_hash)

        def upload():
            batch.to(dev)
            torch.cuda.synchronize()

        timings["pack_upload"] = time_commit(upload, REPS)
        if host_calls != {"reduce": small_reduces, "compute_root_hash": 0}:
            raise AssertionError(f"a device call ran the host path: {host_calls}")
        mk_stats = MK.stats()
        assert_no_fault(start, gpu_verifier.stats(), "config5")
    finally:
        merkle._reduce, merkle.Proof.compute_root_hash = reduce, compute
        uninstall_device_plane()

    def pct(t):
        return {"p50": t[0], "p95": t[1]}

    emit(
        {
            "phase": "config5",
            "validators": {
                "ed25519": len(vals.validators) - n_sr,
                "sr25519": n_sr,
            },
            "txs": N_TXS,
            "tx_bytes": sum(map(len, txs)),
            "proofs": len(proofs),
            "proof_aunts": sum(len(p.aunts) for p in proofs),
            "roots_equal_host": True,
            "rejected_bad_proof_index": bad_idx,
            "launches_per_call": per_call,
            "ms": {k: {**pct(v), "reps": REPS} for k, v in timings.items()},
            "host_hashlib_ms": {
                "root": {**pct(host_root), "reps": HOST_REPS},
                "verify_proofs_batch": {**pct(host_batch), "reps": HOST_REPS},
                "txs_proofs_once": txs_proofs_host_ms,
            },
            "merkle_stats": mk_stats,
            "ok": True,
        }
    )
    return {
        "leaf_hashes": tx_leaf_hashes,
        "proofs": proofs,
        "data_hash": data_hash,
        "launches": per_call,
    }


# the batch sizes the min-batch crossover is measured at, and its reps
MIN_BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
MIN_BATCH_REPS = 15
# fault containment: one main-path window a key type, the deadline the
# hang meets, the hang itself, the rules' seed; the all-CPU mixed commit
FAULT_WINDOW = 2048
FAULT_DEADLINE_S = 2.0
FAULT_HANG_S = 4.0
FAULT_SEED = 11
FALLBACK_REPS = 3
# the side-stream gather: the sleep enqueued before the window's check
# kernel (~25 ms at the H100's clock), far longer than a gather's path
# from verify() to its copy
SIDE_STREAM_SLEEP_CYCLES = 50_000_000


def key_triples(vals, commit, key_type: str, n: int):
    """The first n (PubKey, sign-bytes, signature) of a key type in a
    commit, index order."""
    msgs = commit.sign_bytes_batch(CHAIN_ID)
    out = [
        (v.pub_key, msgs[i], commit.signatures[i].signature)
        for i, v in enumerate(vals.validators)
        if v.pub_key.type() == key_type
    ]
    if len(out) < n:
        raise AssertionError(f"{len(out)} {key_type} signatures, not {n}")
    return out[:n]


def phase_min_batch(torch, main: dict, mixed: dict) -> dict:
    """Where one device window starts to beat the native CPU batch: for
    each key type and n in MIN_BATCH_SIZES, host ms (median of
    MIN_BATCH_REPS after a warm-up) of n valid signatures of the main
    paths' commits through the device batch verifier (install's gate at
    1, so every n is one window: upload, kernels, gather) and through
    the CPU default (the C batch equation). The crossover is the least n
    from which the device is faster at every larger n measured."""
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.batch import create_batch_verifier, cpu_factory

    sources = {"ed25519": main, "sr25519": mixed}
    out = {}
    gpu_verifier.install(min_batch=1)
    settle_probes()
    try:
        for kt, src in sources.items():
            triples = key_triples(src["vals"], src["commit"], kt, max(MIN_BATCH_SIZES))

            def run(make, items):
                bv = make()
                for t in items:
                    bv.add(*t)
                ok, bits = bv.verify()
                if not ok or len(bits) != len(items):
                    raise AssertionError(f"min_batch: a valid {kt} batch failed")

            rows = {}
            for n in MIN_BATCH_SIZES:
                items = triples[:n]

                def device(items=items):
                    bv = create_batch_verifier(items[0][0], len(items))
                    if not isinstance(bv, gpu_verifier._GpuBatchVerifier):
                        raise AssertionError("min_batch: the gate kept a batch off")
                    return bv

                ms = {}
                for path, make in (("device", device), ("cpu", cpu_factory(kt))):
                    run(make, items)  # warm-up
                    times = []
                    for _ in range(MIN_BATCH_REPS):
                        t0 = time.perf_counter()
                        run(make, items)
                        times.append((time.perf_counter() - t0) * 1e3)
                    ms[path] = float(np.median(times))
                rows[str(n)] = ms
            wins = [rows[str(n)]["device"] < rows[str(n)]["cpu"] for n in MIN_BATCH_SIZES]
            crossover = next(
                (n for i, n in enumerate(MIN_BATCH_SIZES) if all(wins[i:])), None
            )
            out[kt] = {"ms": rows, "crossover": crossover}
        stats = gpu_verifier.stats()
    finally:
        gpu_verifier.uninstall()
    emit(
        {
            "phase": "min_batch",
            "sizes": list(MIN_BATCH_SIZES),
            "reps": MIN_BATCH_REPS,
            **out,
            "default_min_batch": gpu_verifier.DEFAULT_MIN_BATCH,
            "verifier_stats": stats,
            "ok": True,
        }
    )
    return out


def phase_fault_containment(torch, main: dict, mixed: dict) -> dict:
    """Device faults injected through crypto/faults.py into one
    FAULT_WINDOW window of each key type (one bad signature in it), one
    at a time: a dispatch that raises, a gather that hangs FAULT_HANG_S
    past a FAULT_DEADLINE_S deadline, a bitmap one lane short, a flipped
    lane. For each: the bitmap equals the clean device bitmap, the batch
    is `faulted`, faults rose by one and the key type's breaker opened;
    the next batch went to the CPU (no device window, its signatures
    counted as rerouted) with the same bitmap; probe_now() closed the
    breaker with one device verify (one launch of each kernel of the
    key type). Before the faults, the same window verified inside a
    side stream with a sleep kernel enqueued ahead of its check kernel
    (K2 or X3): the gather, on a watchdog thread, must copy the bitmap
    after them on that stream, so the clean bitmap and no fault. Then
    the mixed 10k commit verified with both breakers held open, all on
    the native CPU plane (the counterpart of the JAX package's
    bench.py:454 bench_commit_fallback), beside its device p50."""
    import random

    from tendermint_tpu_torch.crypto import faults, gpu_verifier
    from tendermint_tpu_torch.crypto.batch import create_batch_verifier
    from tendermint_tpu_torch.crypto import breaker
    from tendermint_tpu_torch.ops import ed25519_cuda, sr25519_cuda
    from tendermint_tpu_torch.types.validation import verify_commit

    n = FAULT_WINDOW
    flip = random.Random(FAULT_SEED).randrange(n)  # the lane bitflip hits
    bad = (flip + n // 2) % n
    kernels_of = {
        "ed25519": {"sha512_ram": 1, "ed25519_verify_tile": 1},
        "sr25519": {"sr25519_verify": 1},
    }
    modes = (
        ("dispatch_raise", "gpu.dispatch", "raise"),
        ("gather_hang", "gpu.gather", "hang"),
        ("misshape", "gpu.gather", "misshape"),
        ("bitflip", "gpu.gather", "bitflip"),
    )
    results = {}
    gpu_verifier.install(gather_deadline_s=FAULT_DEADLINE_S)  # the default gate
    settle_probes()
    try:
        for kt, src in (("ed25519", main), ("sr25519", mixed)):
            items = list(key_triples(src["vals"], src["commit"], kt, n))
            pk, msg, sig = items[bad]
            items[bad] = (pk, msg, sig[:9] + bytes([sig[9] ^ 0x20]) + sig[10:])
            want = [i != bad for i in range(n)]

            def verify_batch():
                bv = create_batch_verifier(items[0][0], n)
                for t in items:
                    bv.add(*t)
                return bv, bv.verify()

            bv, (ok, clean) = verify_batch()
            if not isinstance(bv, gpu_verifier._GpuBatchVerifier) or bv.faulted:
                raise AssertionError(f"the clean {kt} window did not run on the card")
            if ok or clean != want:
                raise AssertionError(f"the clean {kt} bitmap is wrong")
            mod, fn_name = (
                (ed25519_cuda, "verify_tile") if kt == "ed25519" else (sr25519_cuda, "verify_sr")
            )
            check = getattr(mod, fn_name)

            def held_back(*args, check=check):
                torch.cuda._sleep(SIDE_STREAM_SLEEP_CYCLES)
                return check(*args)

            s0 = gpu_verifier.stats()
            side = torch.cuda.Stream()
            setattr(mod, fn_name, held_back)
            try:
                with torch.cuda.stream(side):
                    bv, (_ok, bits) = verify_batch()
            finally:
                setattr(mod, fn_name, check)
            s1 = gpu_verifier.stats()
            if bits != clean or bv.faulted or s1["faults"] != s0["faults"]:
                raise AssertionError(f"a {kt} window on a side stream was gathered early")
            results[f"{kt}.side_stream"] = {
                "bitmap_unchanged": True,
                "faults": s1["faults"] - s0["faults"],
                "sleep_cycles": SIDE_STREAM_SLEEP_CYCLES,
            }
            for name, point, mode in modes:
                s0 = gpu_verifier.stats()
                t0 = time.perf_counter()
                with faults.inject(
                    point, mode, times=1, seed=FAULT_SEED, hang_s=FAULT_HANG_S, key=kt
                ) as rule:
                    bv, (_ok, bits) = verify_batch()
                contained_ms = (time.perf_counter() - t0) * 1e3
                s1 = gpu_verifier.stats()
                checks = {
                    "fired": rule.fired == 1,
                    "device_verifier": isinstance(bv, gpu_verifier._GpuBatchVerifier),
                    "bitmap_unchanged": bits == clean,
                    "faulted": bv.faulted,
                    "faults_plus_one": s1["faults"] - s0["faults"] == 1,
                    "breaker_open": s1[f"breaker_{kt}"] == breaker.STATE_CODE[breaker.OPEN],
                }
                nxt, (_ok, bits2) = verify_batch()
                s2 = gpu_verifier.stats()
                checks["next_batch_on_cpu"] = (
                    not isinstance(nxt, gpu_verifier._GpuBatchVerifier)
                    and bits2 == clean
                    and s2[f"batches_{kt}"] == s1[f"batches_{kt}"]
                    and s2["rerouted_sigs"] - s1["rerouted_sigs"] == n
                )
                reset_launches()
                closed = gpu_verifier.probe_now(kt)
                probe_launches = {k: v for k, v in launches().items() if v}
                checks["probe_closed"] = (
                    closed
                    and gpu_verifier.stats()[f"breaker_{kt}"] == 0
                    and probe_launches == kernels_of[kt]
                )
                failed = [k for k, v in checks.items() if not v]
                if failed:
                    raise AssertionError(f"fault {name} on {kt}: {failed}")
                results[f"{kt}.{name}"] = {
                    "contained_ms": contained_ms,
                    "rerouted_sigs": s2["rerouted_sigs"] - s0["rerouted_sigs"],
                    "probe_launches": probe_launches,
                }
        # the mixed 10k commit with both breakers held open: all CPU
        vals, commit = mixed["vals"], mixed["commit"]
        for kt in gpu_verifier.KEY_TYPES:
            breaker.breaker_for(kt).open_now()
        s0 = gpu_verifier.stats()
        cpu50, cpu95 = time_commit(
            lambda: verify_commit(CHAIN_ID, vals, commit.block_id, HEIGHT, commit),
            FALLBACK_REPS,
        )
        s1 = gpu_verifier.stats()
        if s1["batches"] != s0["batches"] or s1["faults"] != s0["faults"]:
            raise AssertionError("an open breaker let a window through")
        rerouted = s1["rerouted_sigs"] - s0["rerouted_sigs"]
        if rerouted != (FALLBACK_REPS + 1) * len(commit.signatures):
            raise AssertionError(f"{rerouted} signatures rerouted")
    finally:
        faults.reset()
        gpu_verifier.uninstall()
    fallback = {
        "cpu_p50_ms": cpu50,
        "cpu_p95_ms": cpu95,
        "reps": FALLBACK_REPS,
        "device_p50_ms": mixed["p50"],
        "device_batches_during": 0,
    }
    emit(
        {
            "phase": "fault_containment",
            "window": n,
            "bad_index": bad,
            "deadline_s": FAULT_DEADLINE_S,
            "hang_s": FAULT_HANG_S,
            "cases": results,
            "mixed_10k_commit_on_cpu": fallback,
            "ok": True,
        }
    )
    return {"cases": results, "fallback": fallback}


# BASELINE.md config 4: a light client's sequential sync at 150
# validators, 1,024 headers (32 merged windows) and a mixed 75 + 75 chain
# of 256 headers; window sizes timed besides the default's
CONFIG4_CHAIN_ID = "chip-smoke-light"
CONFIG4_HEADERS = 1024
CONFIG4_MIXED_HEADERS = 256
CONFIG4_WINDOWS = (8, 16)


def light_windows(hops: int, per_commit: int, window: int, gate: int) -> int:
    """Device windows of one key type in a sequential sync of `hops` hops
    merged `window` at a time, `per_commit` signatures a commit: each
    merged batch streams STREAM_CHUNK windows, and one below the gate
    stays on the CPU."""
    from tendermint_tpu_torch.crypto.gpu_verifier import _GpuBatchVerifier

    step = _GpuBatchVerifier.STREAM_CHUNK
    total = 0
    for first in range(0, hops, window):
        n = min(window, hops - first) * per_commit
        if n >= gate:
            total += -(-n // step)
    return total


def phase_config4(torch, seed: int) -> dict:
    """BASELINE.md config 4 through the light client a user calls, with
    the device plane installed from its config: a chain of
    CONFIG4_HEADERS + 1 heights of LIGHT_VALIDATORS equal-power ed25519
    validators from the seed, synced by a fresh sequential client from
    height 1. The sync is counted (ed25519 windows, X1 and K2 launches
    of the whole sync and of one merged window alone, and of the sync a
    commit at a time), stores every header and contains no fault; then
    it is timed as headers/s merged (window 32), a commit at a time and
    at CONFIG4_WINDOWS, twice each in turns (the mean and the readings),
    and once more merged with its host stages timed
    and the device time of X1 and K2 read by the profiler. A signature flipped in the middle of the second
    window raises InvalidHeaderError with that commit's own message,
    every header below it stored and none above. A mixed 75 + 75 chain
    of CONFIG4_MIXED_HEADERS runs the same sync with each key type's
    windows and launches counted (X3 for sr25519)."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.light.client import SEQUENTIAL_BATCH_HOPS
    from tendermint_tpu_torch.light import verifier
    from tendermint_tpu_torch.light.errors import InvalidHeaderError
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.light.verifier import verify_adjacent_batch
    from tendermint_tpu_torch.node.device import (
        install_device_plane,
        uninstall_device_plane,
    )
    from tendermint_tpu_torch.types.commit import CommitSig
    from tendermint_tpu_torch.types.light import LightBlock
    from tendermint_tpu_torch.types import validation
    from tendermint_tpu_torch.types.validation import verify_commit_light
    from tendermint_tpu_torch.workloads import (
        build_light_chain,
        light_client,
        light_sync,
    )

    t_phase = time.perf_counter()
    hops, mixed_hops = CONFIG4_HEADERS, CONFIG4_MIXED_HEADERS
    t0 = time.perf_counter()
    chain = build_light_chain(CONFIG4_CHAIN_ID, hops + 1, LIGHT_VALIDATORS, seed)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mixed = build_light_chain(
        CONFIG4_CHAIN_ID, mixed_hops + 1, LIGHT_VALIDATORS, seed + 1,
        LIGHT_VALIDATORS // 2,
    )
    mixed_build_s = time.perf_counter() - t0
    # the bad chain: one signature flipped in the middle of window 2
    bad_h = 2 + SEQUENTIAL_BATCH_HOPS + SEQUENTIAL_BATCH_HOPS // 2
    bad = dict(chain)
    bad_block = LightBlock.from_proto(chain[bad_h].to_proto())
    sigs = bad_block.signed_header.commit.signatures
    s0 = sigs[0]
    sigs[0] = CommitSig.for_block(
        s0.signature[:9] + bytes([s0.signature[9] ^ 0x20]) + s0.signature[10:],
        s0.validator_address,
        s0.timestamp_ns,
    )
    bad[bad_h] = bad_block
    # the host oracle first: the error the device path must reproduce
    sh = bad_block.signed_header
    try:
        verify_commit_light(
            CONFIG4_CHAIN_ID, bad_block.validator_set, sh.commit.block_id,
            bad_h, sh.commit,
        )
    except ValueError as e:
        want_err = str(e)
    else:
        raise AssertionError("the flipped commit verified on the host")
    if not want_err.startswith("wrong signature (#0): "):
        raise AssertionError(f"host oracle: {want_err}")

    cfg = GPUConfig()
    gate = cfg.min_batch_size
    per_commit = 2 * LIGHT_VALIDATORS // 3 + 1  # the first > 2/3 of equal powers
    first = mixed[1].validator_set.validators[:per_commit]
    n_sr = sum(v.pub_key.type() == "sr25519" for v in first)
    n_ed = per_commit - n_sr

    def tile(w):
        return {"sha512_ram": w, "ed25519_verify_tile": w}

    def merged(hops_, per, window=SEQUENTIAL_BATCH_HOPS):
        return light_windows(hops_, per, window, gate)

    out = {}
    start = gpu_verifier.stats()
    install_device_plane(cfg)
    settle_probes()
    try:
        synced = {}

        def sync(blocks, affinity, key):
            # a store that keeps every header of the chain
            synced[key] = light_client(blocks, CONFIG4_CHAIN_ID, len(blocks))
            light_sync(synced[key], affinity)

        w_merged = merged(hops, per_commit)
        out["launches_per_sync"] = count_one_call(
            lambda: sync(chain, SEQUENTIAL_BATCH_HOPS, "merged"),
            {"ed25519": (w_merged, tile(w_merged))},
        )
        if synced["merged"].store.size() != hops + 1:
            raise AssertionError(
                f"{synced['merged'].store.size()} headers stored, not {hops + 1}"
            )
        w_one = merged(SEQUENTIAL_BATCH_HOPS, per_commit)

        def one_window():
            verify_adjacent_batch(
                CONFIG4_CHAIN_ID,
                chain[1].signed_header,
                [chain[h] for h in range(2, 2 + SEQUENTIAL_BATCH_HOPS)],
                10**18,
                chain[hops + 1].signed_header.header.time_ns,
            )

        out["launches_per_merged_window"] = count_one_call(
            one_window, {"ed25519": (w_one, tile(w_one))}
        )
        w_single = merged(hops, per_commit, 1)
        out["launches_per_sync_per_commit"] = count_one_call(
            lambda: sync(chain, 1, "per_commit"),
            {"ed25519": (w_single, tile(w_single))},
        )
        # each window size twice, in turns and then in reverse order, so
        # drift of the host hits them alike
        sizes = {
            "merged": SEQUENTIAL_BATCH_HOPS,
            "per_commit": 1,
            **{f"window_{w}": w for w in CONFIG4_WINDOWS},
        }
        readings = {name: [] for name in sizes}
        for name in [*sizes, *reversed(sizes)]:
            seconds = light_sync(light_client(chain, CONFIG4_CHAIN_ID), sizes[name])
            readings[name].append(hops / seconds)
        out["headers_per_s"] = {k: float(np.mean(v)) for k, v in readings.items()}
        out["headers_per_s_readings"] = readings

        # where a merged sync's host time goes (each stage's calls timed
        # on the host clock; collect holds the sign-bytes, verify the
        # device batch), and the card's busy share: X1's and K2's device
        # time of one merged window, from the profiler
        stages = {
            "validate_basic": (LightBlock, "validate_basic"),
            "header_checks": (verifier, "adjacent_header_checks"),
            "collect": (validation, "collect_commit_light"),
            "verify": (validation, "verify_triples_grouped"),
            "store": (LightStore, "save_light_block"),
        }
        spent = {name: [] for name in stages}
        with contextlib.ExitStack() as stack:
            for name, (owner, attr) in stages.items():
                stack.enter_context(timed(owner, attr, spent[name]))
            seconds = light_sync(
                light_client(chain, CONFIG4_CHAIN_ID), SEQUENTIAL_BATCH_HOPS
            )
        busy = sum(
            device_ms(torch, one_window, 5, KERNEL_NAMES[k], w_one)[0]
            for k in ("sha512_ram", "ed25519_verify_tile")
        ) * (w_merged / w_one)
        out["merged_ms_per_header"] = {
            "total": seconds * 1e3 / hops,
            **{name: sum(v) / hops for name, v in spent.items()},
            "device_x1_k2": busy / hops,
        }
        out["merged_device_idle_share"] = 1 - busy / (seconds * 1e3)

        before = gpu_verifier.stats()
        client = light_client(bad, CONFIG4_CHAIN_ID, len(bad))
        try:
            light_sync(client, SEQUENTIAL_BATCH_HOPS)
        except InvalidHeaderError as e:
            got_err = str(e)
        else:
            raise AssertionError("the chain with a flipped signature synced")
        assert_no_fault(before, gpu_verifier.stats(), "config4 bad signature")
        if got_err != want_err:
            raise AssertionError(f"rejected with {got_err!r}, not {want_err!r}")
        stored = sorted(client.store._heights())
        if stored != list(range(1, bad_h)):
            raise AssertionError(
                f"after the bad signature at {bad_h} the store holds "
                f"{stored[0]}..{stored[-1]} ({len(stored)} headers)"
            )
        out["bad_signature_height"] = bad_h

        w_ed, w_sr = merged(mixed_hops, n_ed), merged(mixed_hops, n_sr)
        out["mixed_launches_per_sync"] = count_one_call(
            lambda: sync(mixed, SEQUENTIAL_BATCH_HOPS, "mixed"),
            {
                "ed25519": (w_ed, tile(w_ed)),
                "sr25519": (w_sr, {"sr25519_verify": w_sr}),
            },
        )
        if synced["mixed"].store.size() != mixed_hops + 1:
            raise AssertionError("a mixed header was not stored")
        seconds = light_sync(
            light_client(mixed, CONFIG4_CHAIN_ID), SEQUENTIAL_BATCH_HOPS
        )
        out["mixed_headers_per_s_merged"] = mixed_hops / seconds
        stats = gpu_verifier.stats()
        assert_no_fault(start, stats, "config4")
    finally:
        uninstall_device_plane()
    emit(
        {
            "phase": "config4",
            "headers": hops,
            "validators": LIGHT_VALIDATORS,
            "window": SEQUENTIAL_BATCH_HOPS,
            "chain_build_s": build_s,
            "mixed_headers": mixed_hops,
            "mixed_chain_build_s": mixed_build_s,
            "mixed_signatures_per_commit": {"ed25519": n_ed, "sr25519": n_sr},
            **out,
            "phase_s": time.perf_counter() - t_phase,
            "ok": True,
        }
    )
    return out


# the consensus vote path: the flood of one height's prevotes and
# precommits at 150 ed25519 validators and at the 10k mixed set, queued
# in bursts of consensus.state.PEER_DRAIN (one pre-verify a burst), and
# the 150-validator set once more in bursts below the min-batch gate; the
# window widths the flood gives the kernels, held against their plain
# versions on the windows the path dispatched
VOTE_SIZES = (("150", LIGHT_VALIDATORS, 0), ("10k", N_VALIDATORS, N_VALIDATORS // 2))
VOTE_TRICKLE_BURST = 16
VOTE_WIDTHS = (128, 512)
VOTE_TIMED_RUNS = 2
# each bad vote's outcome, the JAX package's text word for word
# (tendermint_tpu/types/vote.py:84, types/vote_set.py:35,143; a vote of
# another height is refused without an error, consensus/state.py:1131)
INVALID_SIGNATURE = ("err", "ValueError", "invalid signature")


def vote_flood(t, n: int, seed: int):
    """The flood of VoteTraffic t with the bad cases mixed in from the
    seed: a forged signature for each key type and a 63-byte signature,
    each ahead of its validator's real vote; a vote of another height; a
    validator index past the set; a duplicate of a prevote after it; and
    an equivocation, a second precommit for another block after the
    validator's real one. Returns (votes in order, the outcome each must
    get, the triples the cache must hold after it)."""
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader

    rng = np.random.default_rng([seed, 21])
    votes = list(t.votes)
    want = [("ok", True)] * len(votes)
    kind = [t.privs[v.validator_index].type() for v in votes]

    def resign(v):
        priv = t.privs[v.validator_index]
        msg = v.sign_bytes(CHAIN_ID)
        if priv.type() == "sr25519":
            v.signature = priv.sign(msg, rng=np.random.default_rng([seed, 22]).bytes)
        else:
            v.signature = priv.sign(msg)
        return v

    def put(at: int, vote, outcome) -> None:
        votes.insert(at, vote)
        want.insert(at, outcome)
        kind.insert(at, None)

    def pick(kt=None, lo=0):
        idx = [i for i in range(lo, len(votes)) if kind[i] and (kt is None or kind[i] == kt)]
        return idx[int(rng.integers(len(idx)))]

    for kt in sorted(set(k for k in kind if k)):
        i = pick(kt)
        forged = votes[i].copy()
        sig = bytearray(forged.signature)
        sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        forged.signature = bytes(sig)
        put(i, forged, INVALID_SIGNATURE)
    i = pick("ed25519")
    short = votes[i].copy()
    short.signature = short.signature[:63]
    put(i, short, INVALID_SIGNATURE)
    foreign = votes[pick()].copy()
    foreign.height = HEIGHT + 5
    put(int(rng.integers(len(votes))), resign(foreign), ("ok", False))
    bad_index = votes[pick()].copy()
    bad_index.validator_index = n + 3
    put(
        int(rng.integers(len(votes))),
        bad_index,
        ("err", "ValueError", f"cannot find validator {n + 3} in valSet of size {n}"),
    )
    prevotes = [i for i in range(len(votes)) if kind[i] and votes[i].type == 1]
    i = prevotes[int(rng.integers(len(prevotes)))]
    put(int(rng.integers(i + 1, len(votes) + 1)), votes[i].copy(), ("ok", False))
    i = pick(lo=next(j for j in range(len(votes)) if kind[j] and votes[j].type == 2))
    other = votes[i].copy()
    other.block_id = BlockID(b"\xee" * 32, PartSetHeader(1, b"\xef" * 32))
    addr = other.validator_address.hex()
    put(
        int(rng.integers(i + 1, len(votes) + 1)),
        resign(other),
        ("err", "ConflictingVoteError", f"conflicting votes from validator {addr}"),
    )
    valid = {
        triple(t, v) for v, k in zip(votes, kind) if k
    } | {triple(t, other)}
    return votes, want, valid


def triple(t, v) -> tuple:
    """The verified-signature cache's key of vote v of traffic t."""
    return (t.vals.validators[v.validator_index].pub_key.bytes(), v.sign_bytes(CHAIN_ID), v.signature)


def vote_windows(t, votes, burst: int, gate: int, valid: set) -> dict:
    """The device windows each key type's pre-verify must dispatch for
    `votes` in bursts of `burst`, by the reference rule: a burst's
    candidates (this height, a 64-byte signature, an index in the set
    and its address) of one key type not proven by an earlier burst go
    to the card when at least `gate` (and 2) of them, as one window (a
    burst is far below the streaming window); every valid candidate is
    proven after its burst."""
    vals = t.vals.validators
    proven: set = set()
    windows = {"ed25519": 0, "sr25519": 0}
    for first in range(0, len(votes), burst):
        groups: dict = {}
        for v in votes[first : first + burst]:
            i = v.validator_index
            if v.height != HEIGHT or len(v.signature) != 64 or not 0 <= i < len(vals):
                continue
            if vals[i].address != v.validator_address:
                continue
            key = triple(t, v)
            if key not in proven:
                groups.setdefault(vals[i].pub_key.type(), []).append(key)
        for kt, keys in groups.items():
            windows[kt] += int(len(keys) >= max(gate, 2))
            proven |= {k for k in keys if k in valid}
    return windows


def ingest_outcomes(cs):
    """Wrap cs._add_vote to record each vote's outcome and, for round 0,
    the count of votes of each type added when that type reached +2/3."""
    seen = []
    maj23_at = {}
    added = {1: 0, 2: 0}
    inner = cs._add_vote

    async def add_vote(vote, peer_id):
        try:
            got = await inner(vote, peer_id)
        except Exception as e:
            seen.append(("err", type(e).__name__, str(e)))
            raise
        seen.append(("ok", got))
        if got and vote.height == HEIGHT and vote.round == 0:
            added[vote.type] += 1
            vs = cs.rs.votes._get(0, vote.type)
            if vote.type not in maj23_at and vs.maj23 is not None:
                maj23_at[vote.type] = added[vote.type]
        return got

    cs._add_vote = add_vote
    return seen, maj23_at


def clock_async(owner, attr: str, into: list) -> None:
    """owner.attr (a coroutine function) appends each call's host ms to
    `into`; set on an instance made for one run."""
    inner = getattr(owner, attr)

    async def wrapper(*args):
        t0 = time.perf_counter()
        try:
            return await inner(*args)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)

    setattr(owner, attr, wrapper)


@contextlib.contextmanager
def captured_windows(into: dict):
    """For the block, every dispatch of the ops verifiers records its
    (pubkeys, messages, signatures) in into[key type]."""
    from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
    from tendermint_tpu_torch.ops.sr25519_kernel import Sr25519Verifier

    classes = {Ed25519Verifier: "ed25519", Sr25519Verifier: "sr25519"}
    originals = {cls: cls.__dict__["dispatch"] for cls in classes}

    def capture(dispatch, key_type):
        def wrapper(self, pubkeys, msgs, sigs):
            into.setdefault(key_type, []).append((list(pubkeys), list(msgs), list(sigs)))
            return dispatch(self, pubkeys, msgs, sigs)

        return wrapper

    for cls, key_type in classes.items():
        cls.dispatch = capture(originals[cls], key_type)
    try:
        yield
    finally:
        for cls, dispatch in originals.items():
            cls.dispatch = dispatch


def vote_kernels(torch, dev, windows: dict, valid: set) -> dict:
    """X1 and K2 (ed25519) and X3 (sr25519) on one window the vote path
    dispatched at each of VOTE_WIDTHS, against their plain versions:
    the largest difference, each bitmap against the valid triples, and
    the kernel's and the plain version's ms (CUDA events)."""
    from tendermint_tpu_torch.ops import ed25519_cuda as C
    from tendermint_tpu_torch.ops import ed25519_kernel as K
    from tendermint_tpu_torch.ops import sha512_kernel as S
    from tendermint_tpu_torch.ops import sr25519_cuda as X
    from tendermint_tpu_torch.ops import sr25519_kernel as SK

    ed = K.Ed25519Verifier(device=dev)
    sr = SK.Sr25519Verifier(device=dev)
    out: dict = {}

    def held(name, width, fn, plain, want_bits=None):
        got, ref = fn(), plain()
        err = int((got.int() - ref.int()).abs().max().item())
        if err:
            raise AssertionError(f"{name} differs from its plain version at {width}")
        if want_bits is not None and got[: len(want_bits)].cpu().tolist() != want_bits:
            raise AssertionError(f"{name}'s bitmap at {width} differs from the valid votes")
        out.setdefault(name, {})[str(width)] = {
            "max_abs_err": err,
            "ms": cuda_ms(torch, fn, 10),
            "plain_ms": cuda_ms(torch, plain, 1),
        }

    for kt, verifier in (("ed25519", ed), ("sr25519", sr)):
        for width in VOTE_WIDTHS:
            args = next(
                (a for a in windows.get(kt, ()) if K.bucket_for(len(a[0]), verifier.bucket_sizes) == width),
                None,
            )
            if args is None:
                raise AssertionError(f"the vote path dispatched no {kt} window of width {width}")
            pks, msgs, sigs = args
            want_bits = [(p, m, s) in valid for p, m, s in zip(pks, msgs, sigs)]
            if kt == "ed25519":
                w = ed.upload(pks, msgs, sigs)
                dig = S.sha512_ragged(w.sig_b, w.pk_b, w.msg, w.offsets, w.max_len)
                held(
                    "sha512_ram",
                    width,
                    lambda w=w: S.sha512_ragged(w.sig_b, w.pk_b, w.msg, w.offsets, w.max_len),
                    lambda w=w: S.sha512_ragged_plain(w.sig_b, w.pk_b, w.msg, w.offsets),
                )
                held(
                    "ed25519_verify_tile",
                    width,
                    lambda w=w, d=dig: C.verify_tile(w.pk_b, w.sig_b, d),
                    lambda w=w, d=dig: K._verify_tile(w.pk_b, w.sig_b, d),
                    want_bits,
                )
            else:
                u = sr.upload(pks, msgs, sigs)
                held(
                    "sr25519_verify",
                    width,
                    lambda u=u: X.verify_sr(u.pk_b, u.sig_b, u.k_b),
                    lambda u=u: SK._verify_tile_sr(u.pk_b, u.sig_b, u.k_b),
                    want_bits,
                )
    return out


def device_busy_ms(torch, fn, launched: dict) -> tuple:
    """(device ms of one call of fn by kernel, records the profiler kept
    by kernel): each kernel's mean time a record times the launches the
    counted run made, so a dropped record does not shorten the sum."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms, kept = {}, {}
    for name, n in launched.items():
        if not n:
            continue
        mine = [e for e in prof.key_averages() if KERNEL_NAMES[name] in e.key]
        seen = sum(e.count for e in mine)
        kept[name] = seen
        if seen == 0:
            raise AssertionError(f"the profiler saw no {name} in the vote ingest")
        ms[name] = sum(e.self_device_time_total for e in mine) / seen * n / 1e3
    return ms, kept


def phase_vote_path(torch, dev, seed: int) -> dict:
    """The consensus vote path a node runs, with the device plane
    installed from its config: for each of VOTE_SIZES, the prevotes then
    the precommits of one height and round for one block as VoteMessage
    wire bytes (workloads.build_vote_traffic) with the bad cases of
    vote_flood mixed in, decoded and queued into a fresh
    consensus.state.ConsensusState in bursts of PEER_DRAIN
    (workloads.ingest). The counted run must give every vote its outcome
    (each valid one added once, each bad one its JAX error), reach +2/3
    of each type at the quorum's vote count, leave exactly the valid
    triples in the cache and launch, per key type, one window a burst
    and group of at least GPUConfig.min_batch_size (vote_windows): X1
    and K2 for ed25519, X3 for sr25519; the commit of its precommits
    verifies through verify_commit on the card. Then the flood is timed
    (VOTE_TIMED_RUNS runs: votes/s), profiled (device busy ms and idle
    share) and timed with the cache disabled (every vote verified alone
    on the CPU); the counted run's stages give ms a burst (pre-verify,
    its sign-bytes, the add loop, the decoding of the wire bytes). The 150-validator set once more, in
    bursts of VOTE_TRICKLE_BURST at the next height, must launch
    nothing. X1, K2 and X3 are held against their plain versions on
    windows the flood dispatched, at VOTE_WIDTHS."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.consensus.msgs import VoteMessage, encode_msg
    from tendermint_tpu_torch.consensus.state import PEER_DRAIN
    from tendermint_tpu_torch.crypto import gpu_verifier, sigcache
    from tendermint_tpu_torch.node.device import (
        install_device_plane,
        uninstall_device_plane,
    )
    from tendermint_tpu_torch.types import vote as vote_module
    from tendermint_tpu_torch.types.validation import verify_commit
    from tendermint_tpu_torch import workloads
    from tendermint_tpu_torch.workloads import build_vote_traffic, ingest, vote_state

    cfg = GPUConfig()
    results, launches_by_size, windows = {}, {}, {}
    valid_all: set = set()
    start = gpu_verifier.stats()
    install_device_plane(cfg)
    settle_probes()
    try:
        for name, n, n_sr in VOTE_SIZES:
            t0 = time.perf_counter()
            t = build_vote_traffic(CHAIN_ID, HEIGHT, n, seed, n_sr)
            votes, want, valid = vote_flood(t, n, seed)
            wires = [encode_msg(VoteMessage(v)) for v in votes]
            build_s = time.perf_counter() - t0
            valid_all |= valid
            bursts = -(-len(votes) // PEER_DRAIN)
            expect_w = vote_windows(t, votes, PEER_DRAIN, cfg.min_batch_size, valid)
            expect = {
                "ed25519": (
                    expect_w["ed25519"],
                    {"sha512_ram": expect_w["ed25519"], "ed25519_verify_tile": expect_w["ed25519"]},
                ),
                "sr25519": (expect_w["sr25519"], {"sr25519_verify": expect_w["sr25519"]}),
            }

            # the counted run, its stages timed
            sigcache.reset()
            cs = vote_state(CHAIN_ID, t.vals, HEIGHT)
            seen, maj23_at = ingest_outcomes(cs)
            pre, adds, sign_bytes, decode = [], [], [], []
            with timed(cs, "_preverify_votes", pre), timed(
                vote_module, "vote_sign_bytes", sign_bytes
            ), timed(workloads, "decode_msg", decode):
                clock_async(cs, "_handle_msg", adds)
                s0 = gpu_verifier.stats()
                t0 = time.perf_counter()
                with captured_windows(windows):
                    counts = count_one_call(lambda: ingest(cs, wires, PEER_DRAIN), expect)
                counted_s = time.perf_counter() - t0
                s1 = gpu_verifier.stats()
            if seen != want:
                bad = next(i for i, (a, b) in enumerate(zip(seen, want)) if a != b)
                raise AssertionError(
                    f"vote {bad} of {len(want)} at {name}: {seen[bad]}, not {want[bad]}"
                    if len(seen) == len(want)
                    else f"{len(seen)} outcomes for {len(want)} votes"
                )
            quorum = -(-(t.vals.total_voting_power() * 2 // 3 + 1) // 10)
            if maj23_at != {1: quorum, 2: quorum}:
                raise AssertionError(f"+2/3 at {maj23_at}, not at {quorum} votes of each type")
            if sigcache.entries() != len(valid) or sigcache.seen_keys_bulk(valid) != valid:
                raise AssertionError("the cache does not hold exactly the valid triples")
            precommits = cs.rs.votes.precommits(0)
            if not (precommits.has_all() and cs.rs.votes.prevotes(0).has_all()):
                raise AssertionError("a valid vote was not added")
            commit = precommits.make_commit()
            verify_commit(CHAIN_ID, t.vals, t.block_id, HEIGHT, commit)
            launches_by_size[name] = counts

            def once():
                sigcache.reset()
                ingest(vote_state(CHAIN_ID, t.vals, HEIGHT), wires, PEER_DRAIN)

            timed_s = []
            for _ in range(VOTE_TIMED_RUNS):
                t0 = time.perf_counter()
                once()
                timed_s.append(time.perf_counter() - t0)
            busy, kept = device_busy_ms(
                torch, once, {k: v for k, v in counts.items() if k != "by_key_type"}
            )
            sigcache.reset()
            with sigcache.disabled():
                t0 = time.perf_counter()
                ingest(vote_state(CHAIN_ID, t.vals, HEIGHT), wires, PEER_DRAIN)
                cold_s = time.perf_counter() - t0
            wall = float(np.mean(timed_s))
            lanes = s1["sigs"] - s0["sigs"]
            results[name] = {
                "validators": {"ed25519": n - n_sr, "sr25519": n_sr},
                "votes": len(votes),
                "bursts": bursts,
                "build_s": build_s,
                "votes_per_s": len(votes) / wall,
                "votes_per_s_readings": [len(votes) / x for x in timed_s],
                "votes_per_s_counted_run": len(votes) / counted_s,
                "ms_per_burst": {
                    "total": wall * 1e3 / bursts,
                    "counted_run_total": counted_s * 1e3 / bursts,
                    "preverify": sum(pre) / bursts,
                    "sign_bytes_inside_preverify": sum(sign_bytes) / bursts,
                    "add_loop": sum(adds) / bursts,
                    "decode": sum(decode) / bursts,
                },
                "windows": {kt: s1[f"batches_{kt}"] - s0[f"batches_{kt}"] for kt in ("ed25519", "sr25519")},
                "windows_per_burst": (s1["batches"] - s0["batches"]) / bursts,
                "signatures_on_device": lanes,
                "pad_waste": s1["pad_waste"] - s0["pad_waste"],
                "pad_share": (s1["pad_waste"] - s0["pad_waste"])
                / max(1, lanes + s1["pad_waste"] - s0["pad_waste"]),
                "device_busy_ms": busy,
                "device_records_kept": kept,
                "device_idle_share": 1 - sum(busy.values()) / (wall * 1e3),
                "maj23_at_votes": quorum,
                "cache_entries": len(valid),
                "cache_off_votes_per_s": len(votes) / cold_s,
                "launches": counts,
            }
            emit({"phase": "vote_path", "size": name, **results[name]})

        # the trickle: the 150-validator set at the next height, bursts
        # of VOTE_TRICKLE_BURST, every group below the gate
        t = build_vote_traffic(CHAIN_ID, HEIGHT + 1, LIGHT_VALIDATORS, seed)
        wires = t.wires
        sigcache.reset()
        cs = vote_state(CHAIN_ID, t.vals, HEIGHT + 1)
        t0 = time.perf_counter()
        trickle = count_one_call(
            lambda: ingest(cs, wires, VOTE_TRICKLE_BURST),
            {"ed25519": (0, {}), "sr25519": (0, {})},
        )
        trickle_s = time.perf_counter() - t0
        if not (cs.rs.votes.prevotes(0).has_all() and cs.rs.votes.precommits(0).has_all()):
            raise AssertionError("a trickled vote was not added")
        if any(v for k, v in trickle.items() if k != "by_key_type"):
            raise AssertionError(f"the trickle launched a kernel: {trickle}")
        held = vote_kernels(torch, dev, windows, valid_all)
        assert_no_fault(start, gpu_verifier.stats(), "vote_path")
    finally:
        uninstall_device_plane()
        sigcache.reset()
    out = {
        "phase": "vote_path_checks",
        "trickle": {
            "validators": LIGHT_VALIDATORS,
            "votes": len(wires),
            "burst": VOTE_TRICKLE_BURST,
            "votes_per_s": len(wires) / trickle_s,
            "launches": trickle,
        },
        "kernels_at_widths": held,
        "ok": True,
    }
    emit(out)
    return {"sizes": results, "launches": launches_by_size, "kernels": held}


# block execution at config 5's set: heights, timed replays
BLOCK_EXEC_HEIGHTS = 3
BLOCK_EXEC_REPS = 5


def block_exec_rule(state, block, app_keys: int, gate: int, step: int, min_batch: int) -> tuple:
    """The launches one apply_block of `block` on `state` must make: for
    the LastCommit, the windows of each key type at `step` signatures
    (X1 and K2 a window for ed25519, X3 for sr25519), none for a key type
    of fewer than `min_batch` signatures; outside them, one
    X4 launch a root of at least `gate` leaves: the data hash, the
    LastCommit hash, a validator set whose root is not memoized yet (a
    set keeps it across copies), the results hash and the kvstore app's
    hash over its `app_keys` entries. The header's 14 fields and the
    part-set proofs are never roots that large."""
    n_sigs = len(block.last_commit.signatures)
    expect = {"ed25519": (0, {}), "sr25519": (0, {})}
    if block.header.height > state.initial_height:
        vals = state.last_validators.validators
        n_sr = sum(v.pub_key.type() == "sr25519" for v in vals)
        w_sr, w_ed = (-(-n // step) if n >= min_batch else 0 for n in (n_sr, len(vals) - n_sr))
        expect = {
            "ed25519": (w_ed, {"sha512_ram": w_ed, "ed25519_verify_tile": w_ed}),
            "sr25519": (w_sr, {"sr25519_verify": w_sr}),
        }
    roots = [len(block.txs), len(block.txs), app_keys]
    if block.header.height > state.initial_height:
        roots.append(n_sigs)
    for vals in (state.validators, state.next_validators):
        if vals._hash is None:
            roots.append(len(vals))
    return expect, {"sha256_tree": sum(n >= gate for n in roots)}


def phase_block_exec(torch, seed: int) -> dict:
    """Block execution (state/execution.py BlockExecutor.apply_block) on
    the kvstore app at config 5's set, with the device plane installed
    from its config: BLOCK_EXEC_HEIGHTS blocks of N_TXS kvstore
    transactions (TX_LENGTHS bytes) made by State.make_block from a
    genesis of the N_VALIDATORS mixed validators (half sr25519), each
    LastCommit signed by every validator (workloads.build_block_chain,
    on the CPU plane). The chain is applied on a fresh node (the kvstore
    app, state and block stores on SqliteKV in a temporary directory),
    each apply_block counted against block_exec_rule, and at height 3 a
    block whose LastCommit has one sr25519 signature flipped is refused
    first, the stores left as they were. Then BLOCK_EXEC_REPS fresh
    replays time apply_block at heights 2-3, by stage; the device's
    busy time at height 2 under the profiler gives its idle share. Last,
    the same chain on the plane uninstalled (the host reference): the
    app hash, state bytes, results hash and ABCI responses must be equal
    at every height, and the forged block refused with the same
    message. No fault and no reroute."""
    import asyncio
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle
    from tendermint_tpu_torch.crypto.gpu_verifier import GpuSr25519BatchVerifier
    from tendermint_tpu_torch.node.device import (
        install_device_plane,
        uninstall_device_plane,
    )
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.types.commit import Commit
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.workloads import (
        block_exec_node,
        build_block_chain,
        kv_genesis,
        kv_txs,
        seeded_keys,
    )

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before block_exec")
    t0 = time.perf_counter()
    privs = seeded_keys(N_VALIDATORS, seed, N_VALIDATORS // 2)
    genesis = kv_genesis(CHAIN_ID, privs)
    txs = [kv_txs(seed, h, N_TXS, TX_LENGTHS) for h in range(1, BLOCK_EXEC_HEIGHTS + 1)]
    chain = build_block_chain(genesis, privs, txs, seed)
    build_s = time.perf_counter() - t0
    keys_after, seen = [], set()
    for block_txs_ in txs:
        seen.update(t.partition(b"=")[0] for t in block_txs_)
        keys_after.append(len(seen))
    # the forged height: one sr25519 signature of its LastCommit flipped
    last = chain[-1].block
    key_type = {p.pub_key().address(): p.type() for p in privs}
    sr_at = [
        i for i, cs in enumerate(last.last_commit.signatures)
        if key_type[cs.validator_address] == "sr25519"
    ]
    forged_idx = sr_at[int(np.random.default_rng([seed, 12]).integers(0, len(sr_at)))]
    forged_commit = Commit.from_proto(last.last_commit.to_proto())
    sig = bytearray(forged_commit.signatures[forged_idx].signature)
    sig[0] ^= 0x01
    forged_commit.signatures[forged_idx].signature = bytes(sig)

    def apply(node, state, block_id, block):
        return asyncio.run(node.executor.apply_block(state, block_id, block))

    def replay(db_dir, counted: bool, forged: dict) -> dict:
        """Apply the chain on a fresh node; before the last height, the
        forged block (made by its State.make_block the first time)."""
        node = block_exec_node(genesis, db_dir)
        state, records, counts, rules = node.state, [], {}, {}
        for h, cb in enumerate(chain, start=1):
            if h == len(chain):
                if "block" not in forged:
                    block, parts = state.make_block(
                        h, list(cb.block.txs), forged_commit, [],
                        cb.block.header.proposer_address,
                    )
                    forged["block"] = block
                    forged["id"] = BlockID(hash=block.hash(), part_set_header=parts.header())
                kept = (node.state_store.load().to_proto(), node.app.app_hash, node.app.height)
                forged.setdefault("outcomes", []).append(
                    outcome(lambda: apply(node, state, forged["id"], forged["block"]))
                )
                after = (node.state_store.load().to_proto(), node.app.app_hash, node.app.height)
                if after != kept or node.state_store.load_abci_responses(h) is not None:
                    raise AssertionError("the forged block changed the stores")
            node.block_store.save_block(cb.block, cb.parts, cb.seen_commit)
            out = []
            if counted:
                expect, outside = block_exec_rule(
                    state, cb.block, keys_after[h - 1], MK.installed(),
                    GpuSr25519BatchVerifier.STREAM_CHUNK, gpu_verifier.installed(),
                )
                counts[h] = count_one_call(
                    lambda: out.append(apply(node, state, cb.block_id, cb.block)),
                    expect, outside,
                )
                rules[h] = {"windows": {k: v[0] for k, v in expect.items()}, **outside}
                state = out[0]
            else:
                state = apply(node, state, cb.block_id, cb.block)
            records.append(
                {
                    "app_hash": node.app.app_hash,
                    "state": node.state_store.load().to_proto(),
                    "results_hash": state.last_results_hash,
                    "abci_responses": node.state_store.load_abci_responses(h).to_proto(),
                }
            )
        node.close()
        return {"records": records, "counts": counts, "rules": rules}

    forged: dict = {}
    start = gpu_verifier.stats()
    stage_names = ("validate_block", "verify_commit", "exec_block", "saves", "update_state", "commit")
    with tempfile.TemporaryDirectory(prefix="block-exec-") as tmp:
        install_device_plane(GPUConfig())
        settle_probes()
        try:
            run = replay(os.path.join(tmp, "counted"), True, forged)
            # each stage's calls, and their sums per timed apply_block
            applies, calls = [], {k: [] for k in stage_names}
            per_apply = {k: [] for k in stage_names}
            with contextlib.ExitStack() as hooks:
                for owner, attr, into in (
                    (execution, "validate_block", "validate_block"),
                    (execution, "verify_commit", "verify_commit"),
                    (StateStore, "save_abci_responses", "saves"),
                    (StateStore, "save", "saves"),
                    (execution, "update_state", "update_state"),
                ):
                    hooks.enter_context(timed(owner, attr, calls[into]))
                for rep in range(BLOCK_EXEC_REPS):
                    node = block_exec_node(genesis, os.path.join(tmp, f"rep{rep}"))
                    clock_async(node.executor, "_exec_block", calls["exec_block"])
                    clock_async(node.executor, "_commit", calls["commit"])
                    state = node.state
                    for h, cb in enumerate(chain, start=1):
                        node.block_store.save_block(cb.block, cb.parts, cb.seen_commit)
                        marks = {k: len(v) for k, v in calls.items()}
                        t0 = time.perf_counter()
                        state = apply(node, state, cb.block_id, cb.block)
                        ms = (time.perf_counter() - t0) * 1e3
                        if h >= 2:
                            applies.append(ms)
                            for k, v in calls.items():
                                per_apply[k].append(sum(v[marks[k]:]))
                    node.close()
            # the device's busy time in one apply_block at height 2, by
            # kernel: its mean time a record times the launches the
            # counted run made; up to PROFILER_SESSIONS fresh nodes while
            # the profiler drops every record of a kernel
            launched = {k: v for k, v in run["counts"][2].items() if k != "by_key_type" and v}
            busy, kept = {}, {}
            for session in range(PROFILER_SESSIONS):
                node = block_exec_node(genesis, os.path.join(tmp, f"profiled{session}"))
                node.block_store.save_block(chain[0].block, chain[0].parts, chain[0].seen_commit)
                state1 = apply(node, node.state, chain[0].block_id, chain[0].block)
                node.block_store.save_block(chain[1].block, chain[1].parts, chain[1].seen_commit)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    apply(node, state1, chain[1].block_id, chain[1].block)
                    torch.cuda.synchronize()
                node.close()
                events = prof.key_averages()
                for name, n in launched.items():
                    mine = [e for e in events if KERNEL_NAMES[name] in e.key]
                    seen = sum(e.count for e in mine)
                    kept.setdefault(name, []).append(seen)
                    if seen and name not in busy:
                        busy[name] = sum(e.self_device_time_total for e in mine) / seen * n / 1e3
                if len(busy) == len(launched):
                    break
            assert_no_fault(start, gpu_verifier.stats(), "block_exec")
        finally:
            uninstall_device_plane()
        ref = replay(os.path.join(tmp, "reference"), False, forged)
    for h, (got, want) in enumerate(zip(run["records"], ref["records"]), start=1):
        for key in want:
            if got[key] != want[key]:
                raise AssertionError(f"height {h}: {key} differs from the host reference")
    device_out, host_out = forged["outcomes"]
    if device_out != host_out or device_out[0] == "ok":
        raise AssertionError(f"the forged block: {device_out} on the card, {host_out} on the host")
    p50 = float(np.percentile(applies, 50))
    stage_ms = {k: float(np.percentile(per_apply[k], 50)) for k in stage_names}
    stage_ms["validate_block_less_verify_commit"] = float(
        np.percentile(np.subtract(per_apply["validate_block"], per_apply["verify_commit"]), 50)
    )
    launches_per_block = {
        str(h): {k: v for k, v in c.items() if k != "by_key_type" and v}
        for h, c in run["counts"].items()
    }
    out = {
        "phase": "block_exec",
        "validators": {"ed25519": N_VALIDATORS - N_VALIDATORS // 2, "sr25519": N_VALIDATORS // 2},
        "heights": len(chain),
        "txs_per_block": N_TXS,
        "tx_bytes_per_block": [sum(map(len, t)) for t in txs],
        "block_bytes": [cb.block.size() for cb in chain],
        "app_entries_after": keys_after,
        "build_s": build_s,
        "launches_per_block": launches_per_block,
        "rule_per_block": {str(h): r for h, r in run["rules"].items()},
        "apply_block_ms": {
            "p50": p50,
            "p95": float(np.percentile(applies, 95)),
            "samples": applies,
            "heights": [2, 3],
            "reps": BLOCK_EXEC_REPS,
        },
        "stage_ms_p50": stage_ms,
        "verify_commit_share_of_apply_p50": stage_ms["verify_commit"] / p50,
        "device_busy_ms_height2": busy,
        "device_records_kept_per_session": kept,
        "device_kernels_not_measured": sorted(set(launched) - set(busy)),
        "device_idle_share": 1 - sum(busy.values()) / p50,
        "forged": {"height": len(chain), "index": forged_idx, "outcome": list(device_out)},
        "equal_to_host_reference": ["app_hash", "state", "results_hash", "abci_responses"],
        "ok": True,
    }
    emit(out)
    return {"launches": launches_per_block}


def phase_kernels(
    torch,
    dev,
    main: dict,
    mixed: dict,
    config5: dict,
    card: str,
    power: str,
    x5_old_build,
) -> dict:
    """Each kernel on the inputs the main path gives it for one commit
    (the batch verifier streams it in STREAM_CHUNK windows, each one
    dispatch; X3 on the mixed commit's sr25519 windows; X4 on the 10,000
    transactions' root, X5 on their 10,000 proofs): its time and its
    plain version's on the same inputs, the largest difference between
    them, and the least time the card could take for the same work."""
    from tendermint_tpu_torch.crypto.gpu_verifier import (
        GpuEd25519BatchVerifier,
    )
    from tendermint_tpu_torch.ops import ed25519_cuda as C
    from tendermint_tpu_torch.ops import ed25519_kernel as K
    from tendermint_tpu_torch.ops import edwards as E
    from tendermint_tpu_torch.ops import sha512_kernel as S

    pks, msgs, sigs = commit_triples(main["vals"], main["commit"])
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
        d_ms, records = device_ms(torch, fn, 10, KERNEL_NAMES[name], launches)
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "shape": shape,
            "max_abs_err": err,
            "ms": cuda_ms(torch, fn, 10),
            "device_ms": d_ms,
            # kernel records the profiler kept per session, of 10 * launches
            "device_records": records,
            "plain_ms": cuda_ms(torch, plain, 1),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }

    # X1 on the commit's windows as the main path launches it: one
    # ragged launch per window, R and A from the uploaded rows
    wins = [verifier.upload(*c) for c in chunks]
    x1 = lambda: [  # noqa: E731
        S.sha512_ragged(w.sig_b, w.pk_b, w.msg, w.offsets, w.max_len)
        for w in wins
    ]
    x1_plain = lambda: [  # noqa: E731
        S.sha512_ragged_plain(w.sig_b, w.pk_b, w.msg, w.offsets) for w in wins
    ]
    got = x1()
    err = max(
        int((a.int() - b.int()).abs().max().item())
        for a, b in zip(got, x1_plain())
    )
    for (c_pks, c_msgs, c_sigs), g in zip(chunks, got):
        ref = b"".join(
            hashlib.sha512(s[:32] + p + m).digest()
            for p, m, s in zip(c_pks, c_msgs, c_sigs)
        )
        if g[:, : len(c_pks)].t().cpu().numpy().tobytes() != ref:
            raise AssertionError("X1 differs from hashlib on the commit")
    # what the check needs: each signature's R, A, message, offset and
    # digest once, and its message's compressions
    rows.append(
        row(
            "sha512_ram",
            "tendermint_tpu_torch/ops/csrc/sha512.cu",
            "tendermint_tpu/ops/sha512_kernel.py:190",
            main["tile"]["sha512_ram"],
            [w.sig_b.shape[1] for w in wins],
            err,
            x1,
            x1_plain,
            sum(64 + len(m) + 4 + 64 for m in msgs),
            sum(
                (64 + len(m) + 17 + 127) // 128 * INSTR_PER_SHA512_BLOCK
                for m in msgs
            ),
        )
    )
    rows[-1]["device_ms_per_window"] = rows[-1]["device_ms"] / len(wins)
    rows[-1]["bound_ms_per_window"] = rows[-1]["bound_ms"] / len(wins)

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
    rows[-1]["launches_mixed_hybrid"] = mixed["hybrid"]["ed25519_dual_mult"]
    rows[-1]["launches_sr25519_hybrid"] = mixed["hybrid"]["by_key_type"][
        "sr25519"
    ]["ed25519_dual_mult"]

    # X3 on the mixed commit's sr25519 windows as the main path uploads
    # them (pk, sig and the host's challenges in one copy)
    from tendermint_tpu_torch.ops import sr25519_cuda as X
    from tendermint_tpu_torch.ops import sr25519_kernel as SK

    sr = [
        t
        for t, v in zip(
            zip(*commit_triples(mixed["vals"], mixed["commit"])),
            mixed["vals"].validators,
        )
        if v.pub_key.type() == "sr25519"
    ]
    sr_verifier = SK.Sr25519Verifier(device=dev)
    sr_wins = [
        sr_verifier.upload(*(list(x) for x in zip(*sr[i : i + step])))
        for i in range(0, len(sr), step)
    ]
    x3 = lambda: [  # noqa: E731
        X.verify_sr(w.pk_b, w.sig_b, w.k_b) for w in sr_wins
    ]
    x3_plain = lambda: [  # noqa: E731
        SK._verify_tile_sr(w.pk_b, w.sig_b, w.k_b) for w in sr_wins
    ]
    got, plain = x3(), x3_plain()
    lane = 0
    for w, g in zip(sr_wins, got):
        if not bool(g[: len(w.size_ok)].all()):
            raise AssertionError("X3 rejected a valid signature of the commit")
        lane += len(w.size_ok)
    err = max(
        int((a.int() - b.int()).abs().max().item()) for a, b in zip(got, plain)
    )
    # what the check needs: each signature's pk, sig and challenge read
    # and its bit written once, and its field operations (no padding lanes)
    rows.append(
        row(
            "sr25519_verify",
            "tendermint_tpu_torch/ops/csrc/sr25519_verify.cu",
            "tendermint_tpu/ops/sr25519_kernel.py:150",
            mixed["tile"]["sr25519_verify"],
            [w.pk_b.shape[1] for w in sr_wins],
            err,
            x3,
            x3_plain,
            lane * (32 + 64 + 32 + 1),
            lane * field_instr(SQ_X3, MUL_X3),
        )
    )

    # one launch at each width that matters: 128 is the light commit's
    # bucket (it adds 101 signatures, then 2/3 of the power is reached),
    # 512 a mid-size batch, 2048 the streaming window, 12288 the widest
    # bucket (the 10k commit's signatures, zero lanes after)
    def packed_at(w):
        return verifier.pack(pks[:w], msgs[:w], sigs[:w])[:3]

    def sr_at(w):
        return sr_verifier.upload(*(list(x) for x in zip(*sr[:w])))

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
        "sr25519_verify": {
            w: (
                lambda u=u: X.verify_sr(u.pk_b, u.sig_b, u.k_b),
                w * (32 + 64 + 32 + 1),
                w * field_instr(SQ_X3, MUL_X3),
                u.pk_b.shape[1],
            )
            for w, u in ((w, sr_at(w)) for w in X3_WIDTHS)
        },
    }
    # X4 on the block's leaf hashes as tree_root uploads them and launches
    # its tree kernel, once a root; and X5 on the block's proofs as
    # verify_proofs uploads them
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.ops import sha256_kernel as S256

    n = len(config5["leaf_hashes"])
    leaves = torch.frombuffer(
        bytearray(b"".join(config5["leaf_hashes"])), dtype=torch.uint8
    )
    leaves = leaves.view(n, 32).to(dev)
    x4 = lambda: S256.sha256_tree(leaves)  # noqa: E731
    x4_plain = lambda: S256.sha256_tree_plain(leaves)  # noqa: E731
    got = x4()
    if got.cpu().numpy().tobytes() != config5["data_hash"]:
        raise AssertionError("X4's root differs from the block's data hash")
    err = int((got.int() - x4_plain().int()).abs().max().item())
    rows.append(
        row(
            "sha256_tree",
            "tendermint_tpu_torch/ops/csrc/sha256.cu",
            "tendermint_tpu/ops/sha256_kernel.py:173",
            config5["launches"]["txs_hash"]["sha256_tree"],
            [n],
            err,
            x4,
            x4_plain,
            32 * n + 32,
            (n - 1) * 2 * INSTR_PER_SHA256_BLOCK,
        )
    )
    rows[-1]["replaces_also"] = [
        "tendermint_tpu/ops/sha256_kernel.py:125",
        "tendermint_tpu/ops/sha256_kernel.py:182",
        "tendermint_tpu/ops/merkle_kernel.py:49",
    ]
    # the level form on the same leaves: one launch of X4's row kernel a
    # level, as tree_root ran before the tree kernel
    by_levels = lambda: level_loop(S256, leaves)  # noqa: E731
    reset_launches()
    if not torch.equal(by_levels()[0], got):
        raise AssertionError("X4's tree and level forms differ")
    level_launches = launches()["sha256_rows"]
    lv_ms, lv_records = device_ms(
        torch, by_levels, 10, KERNEL_NAMES["sha256_rows"], level_launches
    )
    rows[-1]["level_form"] = {
        "kernel": KERNEL_NAMES["sha256_rows"],
        "launches_per_root": level_launches,
        "ms": cuda_ms(torch, by_levels, 10),
        "device_ms": lv_ms,
        "device_records": lv_records,
    }
    batch = MK.pack_proofs(config5["proofs"], config5["data_hash"])
    views = batch.to(dev)
    x5 = lambda: MK.merkle_proofs(*views)  # noqa: E731
    x5_plain = lambda: MK.verify_program_plain(*views)  # noqa: E731
    (r_k, ok_k), (r_p, ok_p) = x5(), x5_plain()
    if not bool(ok_k.all()):
        raise AssertionError("X5 rejected a valid proof of the block")
    err = max(
        int((r_k.int() - r_p.int()).abs().max().item()),
        int((ok_k.int() - ok_p.int()).abs().max().item()),
    )
    k, a = batch.k, batch.n_aunts
    rows.append(
        row(
            "merkle_proofs",
            "tendermint_tpu_torch/ops/csrc/merkle_proofs.cu",
            "tendermint_tpu/ops/merkle_kernel.py:125",
            config5["launches"]["verify_proofs_batch"]["merkle_proofs"],
            [k, a],
            err,
            x5,
            x5_plain,
            # leaves, aunts, offsets, side words, root and host checks
            # read once; roots and bitmap written once
            32 * k + 32 * a + 4 * (k + 1) + 8 * k + 32 + k + 32 * k + k,
            a * (2 * INSTR_PER_SHA256_BLOCK - INSTR_SHA256_PAD_SCHEDULE),
        )
    )
    rows[-1]["bytes_moved"] = 32 * k + 32 * a + 4 * (k + 1) + 8 * k + 32 + k + 32 * k + k
    for r in rows[-2:]:
        r["library"] = "none: no PyTorch call computes SHA-256"
    # X5's earlier design (PR 5's walk, ops/x5_variants.py "word") on the
    # same batch, its events and device times beside the shipped one's
    from tendermint_tpu_torch.ops import x5_variants

    old_fn, old_ptxas = x5_variants.load_variant("word", *x5_old_build)
    old_launch, old_roots, old_ok = x5_variants.make_launcher(old_fn, views, "word")
    old_launch()
    if not (torch.equal(old_roots, r_k) and torch.equal(old_ok, ok_k)):
        raise AssertionError("X5's earlier design differs from the shipped one")
    old_ms, old_records = device_ms(torch, old_launch, 10, KERNEL_NAMES["merkle_proofs"], 1)
    rows[-1]["earlier_design"] = {
        "design": "word: sha256_inner_words, the aunt loaded at each step",
        "ms": cuda_ms(torch, old_launch, 10),
        "device_ms": old_ms,
        "device_records": old_records,
        **old_ptxas,
    }
    # the bound counts what the shipped design needs: the second block's
    # 48 schedule steps come from the table
    rows[-1]["bound_ms_without_table"] = bound_ms(
        rows[-1]["bytes_moved"], a * 2 * INSTR_PER_SHA256_BLOCK
    )[0]

    from tendermint_tpu_torch.ops import build

    ptxas = build.build_report()["ptxas"]
    # (source, entry kernel) of each row
    stems = {
        "sha512_ram": ("sha512", "sha512_ram_kernel"),
        "ed25519_verify_tile": ("ed25519_verify", ""),
        "ed25519_dual_mult": ("ed25519_dual_mult", ""),
        "sr25519_verify": ("sr25519_verify", ""),
        "sha256_tree": ("sha256", "sha256_tree_kernel"),
        "merkle_proofs": ("merkle_proofs", "merkle_proofs_kernel"),
    }
    for r in rows:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} differs from its plain version")
        stem, entry = stems[r["name"]]
        r.update(ptxas_resources(ptxas[stem], entry))
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
    x4_row = next(r for r in rows if r["name"] == "sha256_tree")
    x4_row["level_form"].update(
        ptxas_resources(ptxas["sha256"], KERNEL_NAMES["sha256_rows"])
    )
    x3_row = next(r for r in rows if r["name"] == "sr25519_verify")
    x3_row["earlier_design"] = (
        "four lanes a signature: its times are in PERF.md, and "
        "python -m tendermint_tpu_torch.ops.x3_variants re-times it"
    )
    return {"kernels": rows}


@contextlib.contextmanager
def timed(owner, attr: str, into: list):
    """For the block, owner.attr is wrapped to append each call's host
    milliseconds to `into`; the call itself is unchanged."""
    own = attr in vars(owner)
    orig = getattr(owner, attr)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)

    setattr(owner, attr, wrapper)
    try:
        yield
    finally:
        if own:
            setattr(owner, attr, orig)
        else:
            delattr(owner, attr)


def phase_profile(torch, main: dict, reps: int, out_dir: str, name: str):
    """Where one verify_commit's time goes (run with --profile): host
    clocks around the stages of the real call, and torch.profiler's
    device time by kernel over `reps` calls, with the chrome trace in
    out_dir. The stages are timed by wrapping the functions
    verify_commit calls: sign_bytes (Commit.sign_bytes_batch), drain
    (validation._drain_pending: each key type's add loop, full windows
    dispatched from add(), and its verify()), verify (the batch
    verifiers' verify(): the last windows and the gathers); add is drain
    less verify, scan the rest (the plan: the vector tally or, in a
    phase named *_scalar, run inside scalar_route(), the scalar loop's
    per-vote predicates and tally). "merlin_in_add_and_verify" is the
    time inside challenge_rows, the host part of the sr25519 windows
    that computes their challenges, one C call a window. The signatures
    per key type are what the verifiers counted."""
    if name.endswith("_scalar"):
        with scalar_route():
            return _profile(torch, main, reps, out_dir, name)
    return _profile(torch, main, reps, out_dir, name)


def _profile(torch, main: dict, reps: int, out_dir: str, name: str):
    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto import sr25519 as sr_mod
    from tendermint_tpu_torch.types import validation
    from tendermint_tpu_torch.types.validation import verify_commit

    vals, commit = main["vals"], main["commit"]
    bid = commit.block_id
    gpu_verifier.install()
    settle_probes()
    try:
        verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)  # warm
        stages = {"sign_bytes": [], "drain": [], "verify": [], "merlin": []}
        per_rep = {k: [] for k in ("sign_bytes", "drain", "verify", "total")}
        per_rep["merlin"] = []
        before = gpu_verifier.stats()
        with contextlib.ExitStack() as hooks:
            for owner, attr, into in (
                (type(commit), "sign_bytes_batch", "sign_bytes"),
                (validation, "_drain_pending", "drain"),
                (gpu_verifier._GpuBatchVerifier, "verify", "verify"),
                (sr_mod, "challenge_rows", "merlin"),
            ):
                hooks.enter_context(timed(owner, attr, stages[into]))
            for _ in range(reps):
                for v in stages.values():
                    v.clear()
                t0 = time.perf_counter()
                verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)
                per_rep["total"].append((time.perf_counter() - t0) * 1e3)
                for k, v in stages.items():
                    per_rep[k].append(sum(v))
        after = gpu_verifier.stats()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        reset_launches()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)
            wall = (time.perf_counter() - t0) * 1e3 / reps
        launched = launches()
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    finally:
        gpu_verifier.uninstall()
    signatures = {
        k[len("sigs_") :]: (after[k] - before[k]) // reps
        for k in after
        if k.startswith("sigs_") and after[k] != before[k]
    }
    if sum(signatures.values()) != len(commit.signatures):
        raise AssertionError(f"the profiled calls verified {signatures}")
    # the kernel records the profiler kept against the launches counted
    # (it drops some at random, see device_ms): device_ms_per_commit sums
    # the records kept
    events = prof.key_averages()
    records = {
        name: [sum(e.count for e in events if KERNEL_NAMES[name] in e.key), n]
        for name, n in launched.items()
        if n
    }
    kernels = {}  # device-side events only (kernels, copies), each once
    for evt in prof.key_averages():
        on_device = "cuda" in str(evt.device_type).lower()
        if on_device and evt.self_device_time_total > 0:
            kernels[evt.key] = evt.self_device_time_total / 1e3 / reps
    busy = sum(kernels.values())
    med = {k: float(np.median(v)) for k, v in per_rep.items()}
    adds = np.subtract(per_rep["drain"], per_rep["verify"])
    scans = np.subtract(
        per_rep["total"], np.add(per_rep["sign_bytes"], per_rep["drain"])
    )
    stage_ms = {
        "sign_bytes": med["sign_bytes"],
        "scan": float(np.median(scans)),
        "add": float(np.median(adds)),
        "verify": med["verify"],
        "total": med["total"],
    }
    if signatures.get("sr25519"):
        stage_ms["merlin_in_add_and_verify"] = med["merlin"]
    emit(
        {
            "phase": name,
            "signatures": signatures,
            "stage_ms_p50": stage_ms,
            "profiled_wall_ms_per_commit": wall,
            "device_ms_per_commit": kernels,
            "device_busy_ms_per_commit": busy if kernels else None,
            "kernel_records_seen_launched": records,
            # against the unprofiled wall (the profiler slows the host)
            "device_idle_share": (
                (1 - busy / med["total"]) if kernels else None
            ),
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
    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    card, power = (s.strip() for s in smi.split(",", 1))
    sass = phase_report(torch, args.out)
    # X5's earlier design, built beside the rest for its row's times
    from tendermint_tpu_torch.ops import x5_variants

    x5_old_build = x5_variants.build_variant("word")
    try:
        return _run(torch, args, smi, dev, card, power, sass, x5_old_build)
    finally:
        if x5_old_build[1].poll() is None:
            x5_old_build[1].kill()
            x5_old_build[1].wait()


def _run(torch, args, smi, dev, card, power, sass, x5_old_build) -> int:
    phase_sha512(torch, dev, args.seed)
    phase_x1_ragged(torch, dev, args.seed)
    floor = phase_x1_latency()
    x4_floor = phase_x4_latency()
    x5_floor = phase_x5_latency()
    phase_dual_mult(torch, dev, args.seed)
    phase_verify_tile(torch, dev, args.seed)
    phase_ragged_width(torch, dev, args.seed)
    phase_sr25519_tile(torch, dev, args.seed)
    phase_merkle_kernels(torch, dev, args.seed)
    main_run = phase_main_path(torch, args.seed)
    mixed_run = phase_sr25519_main_path(torch, args.seed)
    phase_host_path(torch, args.seed, main_run, mixed_run)
    config5 = phase_config5(torch, dev, args.seed, mixed_run)
    phase_min_batch(torch, main_run, mixed_run)
    phase_fault_containment(torch, main_run, mixed_run)
    phase_config4(torch, args.seed)
    votes = phase_vote_path(torch, dev, args.seed)
    block_exec = phase_block_exec(torch, args.seed)
    kernels = phase_kernels(
        torch, dev, main_run, mixed_run, config5, card, power, x5_old_build
    )
    # every kernel's launches in each apply_block of phase block_exec
    for r in kernels["kernels"]:
        r["block_exec"] = {
            "launches_per_block": {
                h: c.get(r["name"], 0) for h, c in block_exec["launches"].items()
            }
        }
    # the vote path's launches per height at each size, and each kernel
    # against its plain version on the path's windows at VOTE_WIDTHS
    for r in kernels["kernels"]:
        if r["name"] in votes["kernels"]:
            r["vote_path"] = {
                "launches_per_height": {
                    size: c[r["name"]] for size, c in votes["launches"].items()
                },
                "at_widths": votes["kernels"][r["name"]],
            }
    x1 = next(r for r in kernels["kernels"] if r["name"] == "sha512_ram")
    if x1["spill_store_bytes"] or x1["spill_load_bytes"]:
        raise AssertionError("X1 spills registers")
    x1["sass_per_compression"] = {
        "now": sass["probe_sha512_compress"],
        "before": sass["probe_sha512_compress_before"],
    }
    x1["latency_floor_ms_per_window"] = floor["row_ns"] / 1e6
    x1["latency_floor_cycles"] = floor["row_cycles"]
    for name in ("sha256_tree", "merkle_proofs"):
        r = next(r for r in kernels["kernels"] if r["name"] == name)
        r["sass_per_compression"] = sass["probe_sha256_compress"]
        r["sass_per_inner_hash"] = sass["probe_sha256_inner"]
    x4 = next(r for r in kernels["kernels"] if r["name"] == "sha256_tree")
    x4["latency_floor_ms_per_root"] = x4_floor["ns"] / 1e6
    x4["latency_floor_cycles"] = x4_floor["cycles"]
    x5 = next(r for r in kernels["kernels"] if r["name"] == "merkle_proofs")
    x5["sass_per_inner_hash"] = sass["probe_sha256_inner_pad"]
    x5["earlier_design"]["sass_per_inner_hash"] = sass["probe_sha256_inner"]
    x5["latency_floor_ms_per_batch"] = x5_floor["ns"] / 1e6
    x5["latency_floor_cycles"] = x5_floor["cycles"]
    if args.profile:
        # the vector plans and the scalar loop on the same commits, in
        # turns, so that both meet the same host
        for run, name in ((main_run, "profile"), (mixed_run, "sr25519_profile")):
            phase_profile(torch, run, 5, args.out, name)
            phase_profile(torch, run, 5, args.out, f"{name}_scalar")
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
