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
10k Commit on the CPU plane alone. Phase sharding runs X6, the batch
split over several cards (parallel/sharding.py), on 1, 2, 4 and 8
virtual shards of this card: the ZIP-215 and sr25519 corpora with a
signature spoiled at every shard boundary and the mixed 10k Commit give
the unsharded verifier's, the plain version's and the oracle's bitmaps,
X1, K2, X3 (and K1 in the hybrid) launch once a shard on streams of their
own, verify_commit through a plane installed over the mesh launches k
times a window, one 10k window is timed at each k, `[gpu] devices = 0`
installs the unsharded plane and `devices = 2` is refused; phase
compile_probe compiles the compile probe's segments
(ops/compile_probe.py) alone for sm_90a and reports their ptxas -v
beside the sources' from the build. Phase secp256k1 verifies the JAX
bench's three-class 10k Commit (3,334 ed25519, 3,333 sr25519 and 3,333
secp256k1 validators) through the device plane: the ed25519 and sr25519
thirds launch X1 + K2 and X3 by the rule, the secp256k1 third is
verified on the host and launches nothing, and each call's wall time is
split into the host's secp256k1 ms and the rest; then a 1k three-class
Commit spoiled at one index of each class, and on the scalar route, gets
the CPU plane's error texts. Phase config4 drives BASELINE.md
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
refusal (the kernels line's `block_exec`). Phase consensus_heights
drives the step machine, consensus.state.ConsensusState, of one node
whose validator (an ed25519 member signing through FilePV) commits
heights from genesis with its WAL, evidence pool and event bus on
SqliteKV stores, the device plane installed: three heights of 10,000
kvstore transactions at the mixed 10k set and five at 150 ed25519
validators (one proposed by the node itself), each reaching it as a
proposal and its parts, then the other validators' prevotes and
precommits as wire bytes in bursts of 256. Every height commits in
round 0 with the launches of a rule computed from its traffic (the vote
bursts' windows, four LastCommit verify_commit calls a height, the X4
roots), a forged proposal is ignored, an equivocating precommit leaves
DuplicateVoteEvidence pending, a light-client attack against the 10k
set verifies on the card and its forged copy is refused with the JAX
message, and the blocks, seen commits, state, app hash and WAL EndHeight
records equal the same run on the native CPU plane (its first two 10k
heights); timed a height and
by stage, with the device's idle share (the kernels line's
`consensus_heights`). Phase mempool_proposer drives the mempool and its
gossip: a full node's TxMempool admits 10,000 kvstore transactions
(with resubmissions and malformed validator txs, refused with the JAX
messages) and its mempool reactor gossips them over a MemoryNetwork
router to a validator of the mixed 10k set, which proposes the height
whose proposer it is by reaping its own TxMempool (the block's data and
LastCommit roots, then its own validate_block, on the card) and commits
it from the other validators' votes; every height in round 0 with the
launches of a rule, the block exactly the gossiped txs in order, nothing
sent back, the committed txs gone from the pool, and every byte equal to
the same run on the native CPU plane (its first height); also 256
txs over TCP through
SecretConnection (the kernels line's `mempool_proposer`). Phase
consensus_gossip drives consensus gossip: three validators of the mixed
10k set, each a step machine with FilePV, WAL, evidence pool, event bus
and TxMempool on a router with the consensus, mempool and evidence
reactors, and a harness peer that signs for the other 9,997 validators,
all on one MemoryNetwork; each of the harness's votes goes to one node
and the rest travels by the nodes' gossip; three heights, the last
proposed by one of the nodes from the txs another's pool gossiped, and
one node doubling its prevote at height 2 (the Byzantine plane), whose
DuplicateVoteEvidence that last block carries; round 0 at every node,
the same blocks, launches a pre-verify burst and a LastCommit check as
their rules say, and height 1 equal to the CPU plane's (the kernels
line's `consensus_gossip`). Phases block_sync and state_sync drive a
fresh node's catch-up from three peers serving a chain of 8 blocks of
10,000 kvstore txs at the mixed 10k set, on one MemoryNetwork: block
sync from the genesis (each block checked with the next one's
LastCommit, a forged one refused and its peers banned), and state sync
of the app's snapshot at height 4 through the embedded light client,
the backfill of the headers below it (a forged light block passed over)
and block sync to the tip; every commit check's launches as its rule
says, the fresh node's chain equal to the served one and block sync's
first heights to the CPU plane's (the kernels line's `block_sync` and
`state_sync`). Phase rpc serves config 4's chain (150 ed25519
validators, 256 hops) over JSON-RPC on 127.0.0.1: a light client syncs
it over HTTP with the launches of the same client in process, and a
lying witness's conflicting header is reported as evidence the primary
accepts; then the catch-up chain's routes: 10k light blocks checked on
the card, tx proofs, searches on a KV and an SQL sink, and broadcasts
(the kernels line's `rpc`). Phase node_start starts a node as an
operator does: a home written by the CLI's `init` with the catch-up
chain's genesis, make_node from its config.toml (the device plane from
its [gpu]), block sync from the three peers with block_sync's launches
block by block; then a staged crash before apply and a restart whose
ABCI handshake replays the chain into a fresh app and applies the last
block on the card at block_exec's rule; then four `start` processes of
a `testnet` over TCP to height 3, each exiting 0 on SIGTERM (the kernels
line's `node_start`); the first node and each process serve Prometheus
on /metrics and /healthz, scraped over HTTP and held against
gpu_verifier.stats() and the node's stores. Keys, key types, messages,
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


# the script's start, for the timeline emit() writes to stderr
_T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    if isinstance(obj, dict) and "phase" in obj:
        # where the script's time limit goes: each phase's end, in
        # seconds from the start
        print(f"chip_smoke: phase {obj['phase']} ended at {time.perf_counter() - _T0:.1f} s",
              file=sys.stderr, flush=True)


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


# the plain versions' times of phase_kernels and vote_kernels, by
# function: plain_once times the one call whose result the kernel is
# held against, and the row takes it from here
_PLAIN_MS: dict = {}


def plain_once(torch, plain):
    """plain()'s result; its milliseconds between two CUDA events kept
    as the row's plain_ms (one call, no warm-up: a plain version takes
    1.5-18 s a call on the card, and its comparison needs the call
    anyway)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = plain()
    end.record()
    torch.cuda.synchronize()
    _PLAIN_MS[plain] = start.elapsed_time(end)
    return out


# profiler sessions device_ms and device_busy_ms take at most:
# torch.profiler on an H100 host has dropped kernel records at random
# (seen: 48 of 50 K2 records in one session, 4 and 0 of X5's 10 in two
# others, and 0 of the earlier X5 design's 10 in three sessions in a
# row, while every launch's cudaLaunchKernel was recorded)
PROFILER_SESSIONS = 3


def device_ms(torch, fn, reps: int, kernel: str, launches: int):
    """(device ms per call of fn, records seen per session) of the
    kernels whose name holds `kernel`, from torch.profiler over `reps`
    calls after one warm-up: the kernels' own time, without the host's
    gaps between launches that CUDA events around the calls include. fn
    launches the kernel `launches` times a call. The first session that
    holds every record gives the time; when none of PROFILER_SESSIONS
    does, the fullest one's mean time per record, times reps * launches.
    When no session kept a record of the kernel, the time is fn's
    between two CUDA events (cuda_ms), host gaps included, and every
    count in the records is 0."""
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
        print(
            f"chip_smoke: the profiler kept no record of {kernel} in "
            f"{PROFILER_SESSIONS} sessions; timed between CUDA events",
            file=sys.stderr,
            flush=True,
        )
        return cuda_ms(torch, fn, reps), seen
    return total_us / n * want / 1e3 / reps, seen


def ptxas_resources(log: str, entry: str = "") -> dict:
    """Registers, stack frame and spill bytes from `ptxas -v`
    (ops/compile_probe.ptxas_resources)."""
    from tendermint_tpu_torch.ops.compile_probe import ptxas_resources as parse

    return parse(log, entry)


def bound_ms(nbytes: float, instr: float):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = instr / INT32_INSTR_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def reset_launches() -> None:
    from tendermint_tpu_torch.node.device import reset_launch_counts

    reset_launch_counts()


def launches() -> dict:
    from tendermint_tpu_torch.node.device import launch_counts

    return launch_counts()


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
    """X1's ragged entry against hashlib, mixed message lengths 0-300 in
    one launch, at a width no block of rows divides (and there against
    its plain version too) and at the widest bucket. The plain version
    takes ~40 s a width on the card (a call per length group, 301 of
    them), so the widest bucket is held against hashlib alone (the
    script's time, PERF.md §4)."""
    from tendermint_tpu_torch.ops import sha512_kernel as S

    out = {}
    for n in (RAGGED, WIDE):
        (sig, pk, flat, off), msgs = ragged_rows(torch, dev, n, 300, seed + n)
        got = S.sha512_ragged(sig, pk, flat, off, 300).cpu().numpy()
        ref = hashlib_ram(sig.cpu().numpy(), pk.cpu().numpy(), msgs)
        held = ["hashlib"]
        if n == RAGGED:
            held.append("plain")
            if not np.array_equal(got, S.sha512_ragged_plain(sig, pk, flat, off).cpu().numpy()):
                raise AssertionError(f"X1 ragged digests differ from the plain version at width {n}")
        if not np.array_equal(got, ref):
            raise AssertionError(f"X1 ragged digests differ from hashlib at width {n}")
        out[str(n)] = {"lengths": len({len(m) for m in msgs}), "held_against": held}
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


@contextlib.contextmanager
def charged_dispatches(by_type: dict):
    """For the block each verifier class's dispatch() is wrapped to read
    the launch counters before and after it (the wrapper only reads
    them) and add the difference to by_type[key type][kernel], so a
    launch is charged to the key type whose window made it."""
    from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
    from tendermint_tpu_torch.ops.sr25519_kernel import Sr25519Verifier

    def charged(dispatch, key_type):
        def wrapper(self, *args, **kwargs):
            before = launches()
            handle = dispatch(self, *args, **kwargs)
            mine = by_type.setdefault(key_type, dict.fromkeys(before, 0))
            for name, n in launches().items():
                mine[name] += n - before[name]
            return handle

        return wrapper

    classes = {Ed25519Verifier: "ed25519", Sr25519Verifier: "sr25519"}
    originals = {cls: cls.__dict__["dispatch"] for cls in classes}
    for cls, key_type in classes.items():
        cls.dispatch = charged(originals[cls], key_type)
    try:
        yield by_type
    finally:
        for cls, dispatch in originals.items():
            cls.dispatch = dispatch


def check_counts(before: dict, after: dict, by_type: dict, counts: dict,
                 expect: dict, outside: dict = None, where: str = "one counted call") -> dict:
    """The checks of count_one_call on one span's stats() before and
    after, the launches charged to each key type and all the launches."""
    assert_no_fault(before, after, where)
    for key_type, (want, _kernels) in expect.items():
        got = after[f"batches_{key_type}"] - before[f"batches_{key_type}"]
        if got != want:
            raise AssertionError(f"{where}: {got} {key_type} windows, not {want}")
    for key_type in set(by_type) | set(expect):
        want = expect.get(key_type, (0, {}))[1]
        for name, got in by_type.get(key_type, {}).items():
            if got != want.get(name, 0):
                raise AssertionError(
                    f"{where}: {key_type} windows launched {name} {got} times, "
                    f"not {want.get(name, 0)}"
                )
    for name, got in counts.items():
        charged_sum = sum(t.get(name, 0) for t in by_type.values())
        if got - charged_sum != (outside or {}).get(name, 0):
            raise AssertionError(
                f"{where}: {name}: {got - charged_sum} launches outside a dispatch, "
                f"not {(outside or {}).get(name, 0)}"
            )
    return {**counts, "by_key_type": {k: dict(v) for k, v in by_type.items()}}


def count_one_call(fn, expect: dict, outside: dict = None) -> dict:
    """Launch counts of one call of fn, zeroed just before it and read
    just after, in all and per key type (charged_dispatches). expect:
    {key type: (windows the call must dispatch, {kernel: launches that
    key type's dispatches must make})}; every other kernel must not
    launch in a dispatch, and outside the dispatches each kernel must
    launch exactly outside.get(kernel, 0) times (the merkle roots of a
    block's execution)."""
    from tendermint_tpu_torch.crypto import gpu_verifier

    by_type: dict = {}
    before = gpu_verifier.stats()
    with charged_dispatches(by_type):
        reset_launches()
        fn()
        counts = launches()
    after = gpu_verifier.stats()
    return check_counts(before, after, by_type, counts, expect, outside)


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


# -- the batch split over several cards (X6) on virtual shards of this
# one card, and the compile probe --

# virtual shards of the card the split runs on: the JAX suite's 8 virtual
# devices and scripts/shard_scaling.py's MESH_SIZES
SHARD_COUNTS = (1, 2, 4, 8)
# the corpora's window: 128 lanes, a multiple of every shard count; lanes
# at every shard boundary of SHARD_COUNTS (multiples of 128 / 8) are
# corrupted
SHARD_WINDOW = 128
# timed calls of the split's 10k window at each shard count
SHARD_REPS = 5
# the shard count the hybrid program (plain torch around K1, launch-bound
# on the card) is split over in (a): the largest, so K1 launches 8 times
SHARD_HYBRID = 8


@contextlib.contextmanager
def recorded_streams(into: list):
    """For the block every kernel launch (ops/build.launch) appends (the
    card's index, the stream's handle) to `into`."""
    from tendermint_tpu_torch.ops import build

    stream_of = build.stream_of

    def recording(device):
        s = stream_of(device)
        into.append((device.index, s.value))
        return s

    build.stream_of = recording
    try:
        yield into
    finally:
        build.stream_of = stream_of


def boundary_lanes(width: int, n: int) -> list:
    """The first and last lane of each shard of a `width`-lane window at
    every count of SHARD_COUNTS, those below n."""
    step = width // max(SHARD_COUNTS)
    return sorted({i for j in range(0, width, step) for i in (j, j + step - 1) if i < n})


def spoiled(triples: list, lanes: list) -> tuple:
    """(pubkeys, messages, signatures) of the triples with a bit of S
    flipped in each of `lanes` that has a 64-byte signature."""
    pks, msgs, sigs = (list(x) for x in zip(*triples))
    for i in lanes:
        if len(sigs[i]) == 64:
            sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]
    return pks, msgs, sigs


def phase_sharding(torch, dev, seed: int, main: dict, mixed: dict) -> dict:
    """X6, the batch split over k virtual shards of this card, k in
    SHARD_COUNTS (parallel/sharding.py): each shard its own window,
    stream and launches, the bitmap gathered in add order.

    (a) The ZIP-215 and sr25519 corpora in a window of SHARD_WINDOW lanes
    with a bit of S flipped at every shard boundary: at each k the tile
    program's bitmaps, and at k = SHARD_HYBRID the hybrid program's,
    equal the unsharded verifier's, the plain version's (K2's or X3's on
    the unsharded window) and the oracle's, lane for lane; X1 and K2, X3,
    and K1 in the hybrid launch k times a window, each shard's launches
    on one stream of its own.
    (b) Config 5's mixed 10k Commit at full width: with the plane
    installed over the mesh, verify_commit dispatches the windows of one
    card and launches k times as many (count_one_call), no fault; each
    key type's 5,000 triples, spoiled at shard boundaries of their
    8,192-lane bucket's splits, give the unsharded verifier's bitmap at
    every k.
    (c) Device ms (torch.profiler, X1 and K2) and CUDA-event ms of one
    window of the 10k ed25519 Commit's signatures (bucket 12288) at each
    k against k = 1: what the split costs on one card (shard_scaling's
    overhead, on virtual shards of one card).
    (d) The node seam: `[gpu] devices = 0` installs the unsharded plane on
    this one card, `devices = 2` raises the JAX node's "only" error.
    (e) parallel.dryrun.dryrun_multichip(4, "cuda")."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, sr25519_corpus, zip215_corpus
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane
    from tendermint_tpu_torch.ops import ed25519_kernel as K
    from tendermint_tpu_torch.ops import sr25519_kernel as SK
    from tendermint_tpu_torch.parallel import (
        ShardedEd25519Verifier,
        ShardedSr25519Verifier,
        make_mesh,
    )
    from tendermint_tpu_torch.parallel.dryrun import dryrun_multichip
    from tendermint_tpu_torch.types.validation import verify_commit

    t_phase = time.perf_counter()
    parts_s = {}
    lanes = boundary_lanes(SHARD_WINDOW, SHARD_WINDOW)
    corpora = {}
    for key_type, triples, expected in (
        ("ed25519", zip215_corpus.corpus(16, seed), zip215_corpus.expected),
        ("sr25519", sr25519_corpus.corpus(seed + 3), sr25519_corpus.expected),
    ):
        tr = (triples * -(-SHARD_WINDOW // len(triples)))[:SHARD_WINDOW]
        exp = np.array(expected(tr))
        exp[lanes] = False
        corpora[key_type] = (spoiled(tr, lanes), exp)
    single = {
        "ed25519": K.Ed25519Verifier([SHARD_WINDOW], device=dev),
        "sr25519": SK.Sr25519Verifier([SHARD_WINDOW], device=dev),
    }
    classes = {"ed25519": ShardedEd25519Verifier, "sr25519": ShardedSr25519Verifier}
    programs = {
        ("ed25519", "tile"): {"sha512_ram": 1, "ed25519_verify_tile": 1},
        ("ed25519", "hybrid"): {"sha512_ram": 1, "ed25519_dual_mult": 1},
        ("sr25519", "tile"): {"sr25519_verify": 1},
        ("sr25519", "hybrid"): {"ed25519_dual_mult": 1},
    }
    # the references of (a), each on the unsharded window
    refs = {}
    for key_type, ((pks, msgs, sigs), exp) in corpora.items():
        v = single[key_type]
        if key_type == "ed25519":
            pk_b, sig_b, dig_b, size_ok = v.pack(pks, msgs, sigs)
            plain = K._verify_tile(pk_b, sig_b, dig_b).cpu().numpy()
        else:
            w = v.upload(pks, msgs, sigs)
            plain, size_ok = SK._verify_tile_sr(w.pk_b, w.sig_b, w.k_b).cpu().numpy(), w.size_ok
        refs[key_type] = (v.verify(pks, msgs, sigs), plain & size_ok)
        if not (np.array_equal(refs[key_type][0], exp) and np.array_equal(refs[key_type][1], exp)):
            raise AssertionError(f"sharding: the unsharded {key_type} references disagree with the oracle")
    parts_s["references"] = time.perf_counter() - t_phase
    corpus_rows = {}
    for k in SHARD_COUNTS:
        mesh = make_mesh([dev] * k)
        for (key_type, program), per_window in programs.items():
            if program == "hybrid" and k != SHARD_HYBRID:
                continue
            t_part = time.perf_counter()
            (pks, msgs, sigs), exp = corpora[key_type]
            v = classes[key_type](mesh, [SHARD_WINDOW], program=program)
            streams: list = []
            reset_launches()
            with recorded_streams(streams):
                got = v.verify(pks, msgs, sigs)
            counts = {n: c for n, c in launches().items() if c}
            torch.cuda.synchronize()
            unsharded, plain = refs[key_type]
            checks = {
                "eq_unsharded": np.array_equal(got, unsharded),
                "eq_plain": np.array_equal(got, plain),
                "eq_oracle": np.array_equal(got, exp),
                "launches_k_a_window": counts == {n: k * c for n, c in per_window.items()},
                # each shard's launches on one stream, a stream a shard
                "a_stream_a_shard": len(set(streams)) == k
                and len(streams) == k * sum(per_window.values()),
            }
            if not all(checks.values()):
                raise AssertionError(f"sharding (a) {key_type} {program} k={k}: {checks}, {counts}")
            corpus_rows.setdefault(str(k), {})[f"{key_type}_{program}"] = {
                "launches": counts,
                "streams": len(set(streams)),
            }
            parts_s[f"{key_type}_{program}"] = parts_s.get(f"{key_type}_{program}", 0.0) + (
                time.perf_counter() - t_part)

    # (b) config 5's mixed 10k Commit through the plane over the mesh
    t_part = time.perf_counter()
    vals, commit = mixed["vals"], mixed["commit"]
    pks, msgs, sigs = commit_triples(vals, commit)
    step = gpu_verifier._GpuBatchVerifier.STREAM_CHUNK
    by_type = {}
    for key_type in gpu_verifier.KEY_TYPES:
        idx = [i for i, v in enumerate(vals.validators) if v.pub_key.type() == key_type]
        triples = [(pks[i], msgs[i], sigs[i]) for i in idx]
        # lanes at shard boundaries of its bucket's splits
        bad = boundary_lanes(K.bucket_for(len(idx), K.DEFAULT_BUCKET_SIZES), len(idx))
        by_type[key_type] = (spoiled(triples, bad), bad, -(-len(idx) // step))
    w_ed, w_sr = by_type["ed25519"][2], by_type["sr25519"][2]
    commit_rows = {}
    unsharded_bits = {
        kt: classes[kt]._SINGLE(device=dev).verify(*t) for kt, (t, _bad, _w) in by_type.items()
    }
    for key_type, (_t, bad, _w) in by_type.items():
        want = np.ones(len(unsharded_bits[key_type]), dtype=bool)
        want[bad] = False
        if not np.array_equal(unsharded_bits[key_type], want):
            raise AssertionError(f"sharding (b): the unsharded {key_type} bitmap is not the expected one")
    for k in SHARD_COUNTS:
        mesh = make_mesh([dev] * k)
        for key_type, (t, _bad, _w) in by_type.items():
            got = classes[key_type](mesh).verify(*t)
            if not np.array_equal(got, unsharded_bits[key_type]):
                raise AssertionError(f"sharding (b): {key_type} at k={k} is not the unsharded bitmap")
        gpu_verifier.install(mesh=mesh)
        settle_probes()
        try:
            per_call = count_one_call(
                lambda: verify_commit(CHAIN_ID, vals, commit.block_id, HEIGHT, commit),
                {
                    "ed25519": (w_ed, {"sha512_ram": k * w_ed, "ed25519_verify_tile": k * w_ed}),
                    "sr25519": (w_sr, {"sr25519_verify": k * w_sr}),
                },
            )
        finally:
            gpu_verifier.uninstall()
        commit_rows[str(k)] = {n: c for n, c in per_call.items() if n != "by_key_type" and c}

    parts_s["mixed_10k"] = time.perf_counter() - t_part
    # (c) the split's cost on one card: one 10k window at each k
    t_part = time.perf_counter()
    pks10, msgs10, sigs10 = commit_triples(main["vals"], main["commit"])
    timing = {}
    for k in SHARD_COUNTS:
        v = ShardedEd25519Verifier(make_mesh([dev] * k))

        def call():
            return v.verify(pks10, msgs10, sigs10)

        if not call().all():
            raise AssertionError(f"sharding (c): the 10k window at k={k} did not verify")
        k2_ms, k2_seen = device_ms(torch, call, SHARD_REPS, KERNEL_NAMES["ed25519_verify_tile"], k)
        x1_ms, x1_seen = device_ms(torch, call, SHARD_REPS, KERNEL_NAMES["sha512_ram"], k)
        timing[str(k)] = {
            "bucket": v._bucket(len(pks10)),
            "lanes_a_shard": v._bucket(len(pks10)) // k,
            "device_ms_k2": k2_ms,
            "device_ms_x1": x1_ms,
            "device_records": {"k2": k2_seen, "x1": x1_seen},
            "events_ms_call": cuda_ms(torch, call, SHARD_REPS),
        }
    base = timing["1"]
    for row in timing.values():
        row["device_ms_vs_k1"] = (row["device_ms_k2"] + row["device_ms_x1"]) / (
            base["device_ms_k2"] + base["device_ms_x1"])
        row["events_ms_vs_k1"] = row["events_ms_call"] / base["events_ms_call"]

    parts_s["window_10k"] = time.perf_counter() - t_part
    # (d) the node seam on this one card
    t_part = time.perf_counter()
    install_device_plane(GPUConfig(devices=0))
    settle_probes()
    try:
        if any(hasattr(gpu_verifier._VERIFIERS[kt], "mesh") for kt in gpu_verifier.KEY_TYPES):
            raise AssertionError("sharding (d): devices = 0 on one card installed a mesh")
    finally:
        uninstall_device_plane()
    try:
        install_device_plane(GPUConfig(devices=2))
    except RuntimeError as e:
        if "only" not in str(e):
            raise
        refused = str(e)
    else:
        uninstall_device_plane()
        raise AssertionError("sharding (d): devices = 2 on one card was installed")
    if gpu_verifier.installed() is not None:
        raise AssertionError("sharding (d): the refused config left a plane installed")

    # (e) the dry run
    dry = dryrun_multichip(4, "cuda")
    settle_probes()
    parts_s["node_seam_and_dryrun"] = time.perf_counter() - t_part

    out = {
        "phase": "sharding",
        "shard_counts": list(SHARD_COUNTS),
        "corpus_window": SHARD_WINDOW,
        "corrupted_lanes": lanes,
        "corpora": corpus_rows,
        "mixed_10k_launches_per_verify_commit": commit_rows,
        "mixed_10k_windows": {"ed25519": w_ed, "sr25519": w_sr},
        "mixed_10k_spoiled_lanes": {kt: b[1] for kt, b in by_type.items()},
        "window_10k": timing,
        "timing_note": "virtual shards of one card: all k shards run on this one GPU",
        "node_seam": {"devices_0": "unsharded", "devices_2": refused},
        "dryrun_multichip_4": dry.tolist(),
        "parts_s": parts_s,
        "seconds": time.perf_counter() - t_phase,
        "ok": True,
    }
    emit(out)
    return out


def phase_compile_probe(torch) -> dict:
    """The compile probe (ops/compile_probe.py), the counterpart of
    scripts/aot_bisect.py: its segments, each a one-thread wrapper around
    one device function, compiled alone for sm_90a in parallel with the
    kernels' nvcc flags, their ptxas -v numbers printed; the whole
    sources' numbers from this install's build_report(), not rebuilt."""
    from tendermint_tpu_torch.ops import build, compile_probe

    t0 = time.perf_counter()
    rows = compile_probe.probe(list(compile_probe.SEGMENTS))
    for row in rows:
        print(compile_probe.format_row(row), file=sys.stderr, flush=True)
    failed = [r["unit"] for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"compile_probe: {failed} failed to compile alone")
    sources = {
        stem: compile_probe.ptxas_resources(log)
        for stem, log in build.build_report()["ptxas"].items()
    }
    out = {
        "phase": "compile_probe",
        "segments": rows,
        "sources": sources,
        "seconds": time.perf_counter() - t0,
        "ok": True,
    }
    emit(out)
    return out


# phase secp256k1: the JAX bench's three-class Commits (bench.py:147-178),
# ed25519, sr25519 and secp256k1 by validator index mod 3
SECP_VALIDATORS = N_VALIDATORS
SECP_SMALL_VALIDATORS = 1_000
# the 1k Commit's BlockIDFlag outside uint8, at this index (the scalar route)
SECP_FLAG_AT = 500


@contextlib.contextmanager
def timed_secp_verifies(into: list):
    """For the block, each Secp256k1BatchVerifier.verify appends (its
    host-clock ms, the kernel launches made inside it)."""
    from tendermint_tpu_torch.crypto.secp256k1 import Secp256k1BatchVerifier

    inner = Secp256k1BatchVerifier.verify

    def wrapper(self):
        before = launches()
        t0 = time.perf_counter()
        try:
            return inner(self)
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            into.append((ms, {k: n - before[k] for k, n in launches().items() if n != before[k]}))

    Secp256k1BatchVerifier.verify = wrapper
    try:
        yield into
    finally:
        Secp256k1BatchVerifier.verify = inner


def phase_secp256k1(torch, seed: int) -> dict:
    """secp256k1 (ROADMAP item 22) beside the card. First, on an earlier
    line, whether this host's hashlib has RIPEMD-160, the address hash of
    crypto/secp256k1.py (the phase fails where not). (a) The JAX bench's three-class
    10k Commit (3,334 ed25519, 3,333 sr25519, 3,333 secp256k1
    validators; workloads.build_three_class_commit, its secp256k1 keys
    and signatures made on a process pool: set-up) verified by
    verify_commit through install_device_plane(GPUConfig()) twice, a warm
    call and a timed one: the ed25519 third launches X1 and K2 a window
    of 2,048, the sr25519 third X3, and the secp256k1 third, verified by
    Secp256k1BatchVerifier on the host, launches nothing; each call's
    wall time split into the ms inside Secp256k1BatchVerifier and the
    rest. (b) The 1k three-class Commit (bench.py:2851's row), spoiled at
    one index of each class, and with one BlockIDFlag outside uint8 (the
    scalar route of types/validation.py): verify_commit's error text on
    the device plane equals the CPU plane's, and each call launches one
    X1 + K2 and one X3 window. No fault and nothing rerouted throughout."""
    import hashlib as _hashlib
    import ssl

    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.gpu_verifier import GpuSr25519BatchVerifier
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane
    from tendermint_tpu_torch.types.commit import Commit
    from tendermint_tpu_torch.types.validation import verify_commit
    from tendermint_tpu_torch.workloads import build_three_class_commit

    t_phase = time.perf_counter()
    try:
        _hashlib.new("ripemd160")
        hashlib_ok = True
    except ValueError:
        hashlib_ok = False
    emit({"phase": "secp256k1_probe", "hashlib_ripemd160": hashlib_ok, "openssl": ssl.OPENSSL_VERSION})
    if not hashlib_ok:
        raise AssertionError("secp256k1: this host's hashlib has no RIPEMD-160 (the address hash)")
    workers = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    vals, bid, commit = build_three_class_commit(SECP_VALIDATORS, CHAIN_ID, HEIGHT, seed, workers=workers)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals1k, bid1k, commit1k = build_three_class_commit(SECP_SMALL_VALIDATORS, CHAIN_ID, HEIGHT, seed + 1)
    build_1k_s = time.perf_counter() - t0
    kinds = [v.pub_key.type() for v in vals.validators]
    by_class = {kt: kinds.count(kt) for kt in ("ed25519", "sr25519", "secp256k1")}
    n = SECP_VALIDATORS
    if by_class != {"ed25519": -(-n // 3), "sr25519": (n + 1) // 3, "secp256k1": n // 3}:
        raise AssertionError(f"secp256k1: the 10k Commit's classes {by_class}")
    step = GpuSr25519BatchVerifier.STREAM_CHUNK

    def tile(ed, sr):
        return {
            "ed25519": (ed, {"sha512_ram": ed, "ed25519_verify_tile": ed}),
            "sr25519": (sr, {"sr25519_verify": sr}),
        }

    # (b)'s variants and their CPU-plane errors first
    kinds1k = [v.pub_key.type() for v in vals1k.validators]
    variants = {}
    for kt in ("ed25519", "sr25519", "secp256k1"):
        i = next(j for j in range(len(kinds1k) // 3, len(kinds1k)) if kinds1k[j] == kt)
        variants[f"bad_{kt}"] = (i, None)
    variants["scalar_route_bad_secp256k1"] = (
        next(j for j in range(SECP_FLAG_AT + 1, len(kinds1k)) if kinds1k[j] == "secp256k1"), SECP_FLAG_AT)

    def variant(name):
        at, flag_at = variants[name]
        out = Commit.from_proto(commit1k.to_proto())
        sig = bytearray(out.signatures[at].signature)
        sig[0] ^= 0x01
        out.signatures[at].signature = bytes(sig)
        if flag_at is not None:
            out.signatures[flag_at].block_id_flag = 300
            if out.block_id_flags_array() is not None:
                raise AssertionError("secp256k1: the flag did not leave uint8")
        return out

    spoiled = {name: variant(name) for name in variants}
    cpu_plane = {name: outcome(lambda c=c: verify_commit(CHAIN_ID, vals1k, bid1k, HEIGHT, c))
                 for name, c in spoiled.items()}
    for name, (kind, msg) in cpu_plane.items():
        if kind != "InvalidCommitError" or "wrong signature" not in msg:
            raise AssertionError(f"secp256k1: the CPU plane answered {name} with {kind}: {msg}")

    start = gpu_verifier.stats()
    install_device_plane(GPUConfig())
    settle_probes()
    try:
        w_ed, w_sr = -(-by_class["ed25519"] // step), -(-by_class["sr25519"] // step)

        def full():
            verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)

        calls = []
        for name in ("warm", "timed"):
            secp = []
            with timed_secp_verifies(secp):
                t0 = time.perf_counter()
                counted = count_one_call(full, tile(w_ed, w_sr))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            if len(secp) != 1 or secp[0][1]:
                raise AssertionError(f"secp256k1: {name}: the secp256k1 batches {secp} (one, launching nothing)")
            calls.append({"call": name, "wall_ms": wall_ms, "secp256k1_host_ms": secp[0][0],
                          "rest_ms": wall_ms - secp[0][0], "launches": counted})
        device = {}
        for name, c in spoiled.items():
            secp = []
            with timed_secp_verifies(secp):
                counted = count_one_call(lambda c=c: device.__setitem__(
                    name, outcome(lambda: verify_commit(CHAIN_ID, vals1k, bid1k, HEIGHT, c))), tile(1, 1))
            if device[name] != cpu_plane[name]:
                raise AssertionError(f"secp256k1: {name}: the device plane answered {device[name]}, "
                                     f"the CPU plane {cpu_plane[name]}")
            if any(launched for _ms, launched in secp):
                raise AssertionError(f"secp256k1: {name}: a secp256k1 batch launched {secp}")
            device[name] = {"error": device[name][1][:60] + "...", "at": variants[name][0],
                            "launches": counted}
        assert_no_fault(start, gpu_verifier.stats(), "secp256k1")
    finally:
        uninstall_device_plane()
    out = {
        "phase": "secp256k1",
        "validators": by_class,
        "commit_build_s": build_s,
        "commit_build_1k_s": build_1k_s,
        "build_workers": workers,
        "verify_commit_10k": calls,
        "rule": {"sha512_ram": w_ed, "ed25519_verify_tile": w_ed, "sr25519_verify": w_sr},
        "commit_1k": device,
        "equal_to_cpu_plane": sorted(device),
        "hashlib_ripemd160": hashlib_ok,
        "ok": True,
    }
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


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


def vote_windows(t, votes, burst: int, gate: int, valid: set, height: int = HEIGHT) -> dict:
    """The device windows each key type's pre-verify must dispatch for
    `votes` in bursts of `burst`, by the reference rule: a burst's
    candidates (the node's height, a 64-byte signature, an index in the
    set and its address) of one key type not proven by an earlier burst
    go to the card when at least `gate` (and 2) of them, as one window (a
    burst is far below the streaming window); every valid candidate is
    proven after its burst."""
    vals = t.vals.validators
    proven: set = set()
    windows = {"ed25519": 0, "sr25519": 0}
    for first in range(0, len(votes), burst):
        groups: dict = {}
        for v in votes[first : first + burst]:
            i = v.validator_index
            if v.height != height or len(v.signature) != 64 or not 0 <= i < len(vals):
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
        got, ref = fn(), plain_once(torch, plain)
        err = int((got.int() - ref.int()).abs().max().item())
        if err:
            raise AssertionError(f"{name} differs from its plain version at {width}")
        if want_bits is not None and got[: len(want_bits)].cpu().tolist() != want_bits:
            raise AssertionError(f"{name}'s bitmap at {width} differs from the valid votes")
        out.setdefault(name, {})[str(width)] = {
            "max_abs_err": err,
            "ms": cuda_ms(torch, fn, 10),
            "plain_ms": _PLAIN_MS.pop(plain),
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
    by kernel and session): each kernel's mean time a record times the
    launches the counted run made, so a dropped record does not shorten
    the sum; up to PROFILER_SESSIONS calls under the profiler while it
    drops every record of a kernel, whose time is then None."""
    from torch.profiler import ProfilerActivity, profile

    want = {name: n for name, n in launched.items() if n}
    ms, kept = {name: None for name in want}, {}
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        for name, n in want.items():
            mine = [e for e in events if KERNEL_NAMES[name] in e.key]
            seen = sum(e.count for e in mine)
            kept.setdefault(name, []).append(seen)
            if seen and ms[name] is None:
                ms[name] = sum(e.self_device_time_total for e in mine) / seen * n / 1e3
        if None not in ms.values():
            break
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
                # not measured while the profiler kept no record of a kernel
                "device_idle_share": None
                if None in busy.values()
                else 1 - sum(busy.values()) / (wall * 1e3),
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


# block execution at config 5's set: heights, timed replays (3, cut
# from 5 for the script's time: PERF.md §4)
BLOCK_EXEC_HEIGHTS = 3
BLOCK_EXEC_REPS = 3


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


# the step machine: config 5's mixed set at CONSENSUS_HEIGHTS heights,
# and 150 ed25519 validators at CONSENSUS_LIGHT_HEIGHTS, one of them
# proposed by the node
CONSENSUS_HEIGHTS = 3
# the 10k heights the CPU plane's reference runs
CONSENSUS_CPU_HEIGHTS = 2
CONSENSUS_LIGHT_HEIGHTS = 5
CONSENSUS_LIGHT_PROPOSES_AT = 3
# the height with a forged proposal ahead of the genuine one and one
# equivocating precommit
CONSENSUS_FORGED_AT = 2


def consensus_node_priv(privs, heights: int, proposes_at: int = 0):
    """The node's validator: the first ed25519 key, in the set's seeded
    order, that proposes round 0 of no height in 1..heights but
    proposes_at (of none when 0). The set is static (kvstore txs change
    no validator): height h's proposer is the genesis set's after h - 1
    increments."""
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet

    vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    proposers = []
    for _ in range(heights):
        proposers.append(vals.get_proposer().address)
        vals = vals.copy_increment_proposer_priority(1)
    for p in privs:
        if p.type() != "ed25519":
            continue
        at = [h for h, a in enumerate(proposers, start=1) if a == p.pub_key().address()]
        if at == ([proposes_at] if proposes_at else []):
            return p
    raise AssertionError(f"no ed25519 validator proposes exactly at {proposes_at or 'no height'}")


def consensus_rule(chain, k: int, vals, node_index: int, proposer_type: str, gate: int,
                   step: int, merkle_gate: int, app_keys: int, burst: int,
                   proposals: int) -> tuple:
    """(expect, outside, quorum) for count checks of height chain[k],
    from its traffic: the pre-verify windows of its prevote bursts and
    of its precommit bursts up to the one whose vote `quorum` brings
    +2/3 (the node moves on to the next height there: the rest are the
    previous height's late precommits, each verified alone on the CPU);
    the LastCommit's verify_commit in each validate_block (at prevote,
    at precommit, at finalize and in apply_block) of a height but the
    first, a window a key type of at least `gate` signatures, `step` at
    most; an sr25519 proposer's `proposals` on the card only where the
    gate admits one signature; and one X4 root a root of `merkle_gate`
    leaves or more: the data and LastCommit roots of each validate_block
    and of finalize's validate_basic, the results and the app's hash
    (over `app_keys` entries), and the set's two roots at the first
    height. Where the node proposes, its block's prevote check runs
    before that height's first message, at the end of the height before
    (the node handles its own proposal as it enters the height)."""
    from types import SimpleNamespace

    from tendermint_tpu_torch.consensus.msgs import decode_msg

    ch = chain[k]
    first = chain[0].height
    nxt = chain[k + 1] if k + 1 < len(chain) and chain[k + 1].node_proposes else None
    t = SimpleNamespace(vals=vals)
    prevotes = [decode_msg(w).vote for w in ch.prevotes]
    precommits = [decode_msg(w).vote for w in ch.precommits]
    valid = {triple(t, v) for v in prevotes + precommits}
    power = [v.voting_power for v in vals.validators]
    need = sum(power) * 2 // 3
    acc, counted, quorum = power[node_index], {node_index}, None
    for i, v in enumerate(precommits):
        if v.block_id == ch.block_id and v.validator_index not in counted:
            counted.add(v.validator_index)
            acc += power[v.validator_index]
            if acc > need:
                quorum = i
                break
    if quorum is None:
        raise AssertionError(f"the precommits of height {ch.height} never reach +2/3")
    windows = {"ed25519": 0, "sr25519": 0}
    for votes in (prevotes, precommits[: (quorum // burst + 1) * burst]):
        for kt, n in vote_windows(t, votes, burst, gate, valid, height=ch.height).items():
            windows[kt] += n
    # (block, validate_basic calls, verify_commit calls) in this span
    checks = [(ch, 4 if ch.node_proposes else 5)]
    if nxt is not None:
        checks.append((nxt, 1))
    for c, n in checks:
        if c.height == first:
            continue
        calls = n - 1 if c is ch else n  # finalize's validate_basic verifies nothing
        for kt in windows:
            m = sum(vals.validators[i].pub_key.type() == kt
                    for i, s in enumerate(c.block.last_commit.signatures) if not s.is_absent())
            windows[kt] += calls * (-(-m // step) if m >= gate else 0)
    if proposer_type == "sr25519" and gate <= 1:
        windows["sr25519"] += proposals
    roots = []
    for c, n in checks:
        per = [len(c.block.txs)]
        if c.height > first:
            per.append(len(c.block.last_commit.signatures))
        roots += per * n
    roots += [len(ch.block.txs), app_keys]
    if k == 0:
        roots += [len(vals), len(vals)]
    expect = {
        "ed25519": (windows["ed25519"], {"sha512_ram": windows["ed25519"],
                                         "ed25519_verify_tile": windows["ed25519"]}),
        "sr25519": (windows["sr25519"], {"sr25519_verify": windows["sr25519"]}),
    }
    return expect, {"sha256_tree": sum(n >= merkle_gate for n in roots)}, quorum


def run_consensus(torch, genesis: str, node_priv, chain, home: str, counted: bool,
                  rules: dict = None, extra: dict = None, profile: tuple = (), at_end=None) -> dict:
    """Drive a fresh node (workloads.consensus_node at `home`) through
    the chain (workloads.drive_heights, bursts of PEER_DRAIN). With
    `counted`, each height's launches are zeroed at its first message
    and read once the node stands at the next height, and checked
    against rules[height]; the heights in `profile` run under
    torch.profiler. Returns each height's HeightRun, its stages' host
    ms, its stores' bytes and, with `counted`, its launches and the
    profiler's events; at_end(node), if given, runs before the node
    closes."""
    import asyncio

    from tendermint_tpu_torch.consensus.state import PEER_DRAIN
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.workloads import consensus_node, drive_heights

    node = consensus_node(genesis, node_priv, home)
    calls = {k: [] for k in ("validate_block", "verify_commit", "save_block", "wal", "apply_block", "finalize")}
    marks, out = {}, {"stages": {}, "stores": {}, "launches": {}}
    by_type: dict = {}
    prof: dict = {}

    def before(h: int) -> None:
        marks[h] = {k: len(v) for k, v in calls.items()}
        if h in profile and "p" not in prof:
            from torch.profiler import ProfilerActivity, profile as make

            prof["p"] = make(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if counted:
            by_type.clear()
            marks[h]["stats"] = gpu_verifier.stats()
            reset_launches()

    def after(h: int) -> None:
        t_after = time.perf_counter()
        if counted:
            counts = launches()
            expect, outside = rules[h]
            out["launches"][h] = check_counts(
                marks[h]["stats"], gpu_verifier.stats(), by_type, counts, expect, outside,
                where=f"height {h}",
            )
        if profile and h == profile[-1]:
            torch.cuda.synchronize()
            prof["p"].__exit__(None, None, None)
            out["profile"] = prof["p"].key_averages()
        out["stages"][h] = {k: v[marks[h][k]:] for k, v in calls.items()}
        out["stores"][h] = {
            "block": node.block_store.load_block(h).to_proto(),
            "block_meta": node.block_store.load_block_meta(h).to_proto(),
            "seen_commit": node.block_store.load_seen_commit().to_proto(),
            "state": node.state_store.load().to_proto(),
            "app_hash": node.app.app_hash,
        }

    clock_async(node.executor, "apply_block", calls["apply_block"])
    clock_async(node.cs, "_finalize_commit", calls["finalize"])
    # each proposal's outcome, by height: accepted, or what it raised
    out["proposals"] = {}
    set_proposal = node.cs._set_proposal

    def record_proposal(proposal):
        seen = out["proposals"].setdefault(proposal.height, [])
        try:
            set_proposal(proposal)
        except Exception as e:  # recorded, and raised on as it was
            seen.append([type(e).__name__, str(e)])
            raise
        seen.append(["ok", ""])

    node.cs._set_proposal = record_proposal
    try:
        with contextlib.ExitStack() as hooks:
            for owner, attr, into in (
                (node.executor, "validate_block", "validate_block"),
                (execution, "verify_commit", "verify_commit"),
                (node.block_store, "save_block", "save_block"),
                (node.cs.wal, "write_end_height", "wal"),
            ):
                hooks.enter_context(timed(owner, attr, calls[into]))
            if counted:
                hooks.enter_context(charged_dispatches(by_type))
            out["runs"] = asyncio.run(
                drive_heights(node, chain, PEER_DRAIN, before, after, extra)
            )
        out["end_heights"] = node.end_heights()
        out["evidence"] = [
            [type(ev).__name__, ev.vote_a.validator_address.hex()]
            for ev in node.evpool.pending_evidence(1 << 20)[0]
        ]
        if at_end is not None:
            out["at_end"] = at_end(node)
    finally:
        node.close()
    return out


def consensus_stages(res: dict, heights) -> dict:
    """p50 over `heights` of each stage's host ms: the height (first
    message to EndHeight, and to the node at the next height), the
    proposal and its parts, the prevote and precommit ingests (the
    latter less finalize), finalize by part, and the four validate_block
    and verify_commit calls each."""
    rows = []
    for run in res["runs"]:
        if run.height not in heights:
            continue
        st = res["stages"][run.height]
        fin = sum(st["finalize"])
        rows.append(
            {
                "height_ms": run.end_height_s * 1e3,
                "height_through_apply_ms": run.next_height_s * 1e3,
                "all_messages_ms": run.precommits_s * 1e3,
                "late_precommits_ms": (run.precommits_s - run.next_height_s) * 1e3,
                "proposal_and_parts_ms": run.proposal_s * 1e3,
                "prevote_ingest_ms": (run.prevotes_s - run.proposal_s) * 1e3,
                "precommit_ingest_ms": (run.precommits_s - run.prevotes_s) * 1e3 - fin,
                "finalize_ms": fin,
                "finalize_validate_block_ms": st["validate_block"][2] if len(st["validate_block"]) > 2 else None,
                "finalize_save_block_ms": sum(st["save_block"]),
                "finalize_wal_ms": sum(st["wal"]),
                "finalize_apply_block_ms": sum(st["apply_block"]),
                "validate_block_ms": st["validate_block"],
                "verify_commit_ms": st["verify_commit"],
            }
        )
    out = {}
    for key in rows[0]:
        vals = [r[key] for r in rows]
        if isinstance(vals[0], list):
            out[key] = [float(np.percentile([v[i] for v in vals], 50)) for i in range(len(vals[0]))]
        elif vals[0] is not None:
            out[key] = float(np.percentile(vals, 50))
    out["height_ms_samples"] = [r["height_ms"] for r in rows]
    return out


def phase_consensus_heights(torch, seed: int) -> dict:
    """The step machine (consensus/state.py ConsensusState) of one node
    with the device plane installed from its config, committing heights
    from genesis: at config 5's mixed set (N_VALIDATORS, half sr25519),
    CONSENSUS_HEIGHTS blocks of N_TXS kvstore transactions (TX_LENGTHS
    bytes) in 64 KB parts, and at LIGHT_VALIDATORS ed25519 validators
    CONSENSUS_LIGHT_HEIGHTS heights, the node proposing the empty block
    of CONSENSUS_LIGHT_PROPOSES_AT itself. The node's validator is one
    ed25519 member signing through FilePV, its stores SqliteKV files, a
    WAL, an evidence pool and an event bus beside it, the JAX package's
    default timeouts with skip_timeout_commit, and its clock pinned
    (workloads.pinned_clock). Each height reaches it as a ProposalMessage
    and BlockPartMessages, then the other validators' prevotes, then
    their precommits, as wire bytes in bursts of PEER_DRAIN
    (workloads.build_consensus_chain, drive_heights). Every height must
    commit in round 0 and make the launches of consensus_rule (zeroed
    at its first message, read when the node stands at the next
    height). The timeouts acted on are the first height's start and,
    reported, the next height's timeout_commit where it fires before
    the last late precommit of a height is in; any other fails the run.
    At
    CONSENSUS_FORGED_AT a proposal with one signature bit flipped, sent
    ahead of the genuine one, is ignored, and one equivocating precommit
    leaves DuplicateVoteEvidence pending in the pool. A light-client
    attack against the 10k set (a conflicting header at that height
    signed by every validator, common height 1) passes
    evidence.verify_evidence on the card with the trusting windows of
    reference_plan, and with one counted signature flipped is refused
    with the JAX message. The blocks, seen commits, state bytes, app
    hash and the WAL's EndHeight records must equal those of the same
    run on the native CPU plane (its first CONSENSUS_CPU_HEIGHTS heights
    at 10k, every height at 150). Timed by stage (consensus_stages);
    the device's busy time at heights 2-3 under the profiler gives its
    idle share. No fault and no reroute."""
    import tempfile

    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.consensus.msgs import ProposalMessage, decode_msg, encode_msg
    from tendermint_tpu_torch.consensus.state import PEER_DRAIN
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle
    from tendermint_tpu_torch.crypto.gpu_verifier import _GpuBatchVerifier
    from tendermint_tpu_torch.evidence.verify import verify_evidence
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence
    from tendermint_tpu_torch.types.light import LightBlock, SignedHeader
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    from tendermint_tpu_torch.workloads import (
        build_consensus_chain,
        kv_genesis,
        kv_txs,
        seeded_keys,
        sign_commit,
    )

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before consensus_heights")
    cfg = GPUConfig()
    t_phase = time.perf_counter()

    # the traffic, built on the CPU plane
    t0 = time.perf_counter()
    privs = seeded_keys(N_VALIDATORS, seed, N_VALIDATORS // 2)
    genesis = kv_genesis(CHAIN_ID, privs)
    node_priv = consensus_node_priv(privs, CONSENSUS_HEIGHTS)
    txs = [kv_txs(seed, h, N_TXS, TX_LENGTHS) for h in range(1, CONSENSUS_HEIGHTS + 1)]
    chain = build_consensus_chain(genesis, privs, node_priv, txs, seed, CONSENSUS_FORGED_AT)
    vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    forged = decode_msg(chain[CONSENSUS_FORGED_AT - 1].proposal).proposal
    sig = bytearray(forged.signature)
    sig[int(np.random.default_rng([seed, 15]).integers(64))] ^= 0x10
    forged.signature = bytes(sig)
    extra = {CONSENSUS_FORGED_AT: [encode_msg(ProposalMessage(forged))]}
    # the light-client attack: the block of CONSENSUS_FORGED_AT with
    # another app hash, signed by every validator; common height 1
    attacked = chain[CONSENSUS_FORGED_AT - 1].block
    header = type(attacked.header).from_proto(attacked.header.to_proto())
    header.app_hash = hashlib.sha256(b"attack-%d" % seed).digest()
    attack_id = BlockID(hash=header.hash(), part_set_header=chain[CONSENSUS_FORGED_AT - 1].block_id.part_set_header)
    attack_commit = sign_commit(CHAIN_ID, vals, attack_id, header.height, header.time_ns, privs, seed + 1)
    attack = LightClientAttackEvidence(
        conflicting_block=LightBlock(SignedHeader(header, attack_commit), vals),
        common_height=1,
        total_voting_power=vals.total_voting_power(),
        timestamp_ns=chain[0].block.header.time_ns,
    )
    bad_at = int(np.random.default_rng([seed, 16]).integers(0, len(vals) // 4))
    forged_commit = type(attack_commit).from_proto(attack_commit.to_proto())
    bad_sig = bytearray(forged_commit.signatures[bad_at].signature)
    bad_sig[0] ^= 0x01
    forged_commit.signatures[bad_at].signature = bytes(bad_sig)
    forged_attack = LightClientAttackEvidence(
        conflicting_block=LightBlock(SignedHeader(header, forged_commit), vals),
        common_height=1,
        total_voting_power=vals.total_voting_power(),
        timestamp_ns=attack.timestamp_ns,
    )
    # the 150-validator chain, the node proposing one height
    light_privs = seeded_keys(LIGHT_VALIDATORS, seed)
    light_genesis = kv_genesis(CHAIN_ID, light_privs)
    light_node = consensus_node_priv(light_privs, CONSENSUS_LIGHT_HEIGHTS, CONSENSUS_LIGHT_PROPOSES_AT)
    light_txs = [kv_txs(seed, h, 100, TX_LENGTHS) for h in range(1, CONSENSUS_LIGHT_HEIGHTS + 1)]
    light_chain = build_consensus_chain(light_genesis, light_privs, light_node, light_txs, seed)
    light_vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in light_privs])
    build_s = time.perf_counter() - t0

    def rules_for(ch_list, v, node_priv_, extra_) -> tuple:
        """consensus_rule of each height of ch_list, and the precommit
        that brings +2/3 at each, by height."""
        node_index, _ = v.get_by_address(node_priv_.pub_key().address())
        out, quorums, keys, cur = {}, {}, set(), v
        for k, ch in enumerate(ch_list):
            keys.update(t.partition(b"=")[0] for t in ch.block.txs)
            expect, outside, quorums[ch.height] = consensus_rule(
                ch_list, k, v, node_index, cur.get_proposer().pub_key.type(),
                cfg.min_batch_size, _GpuBatchVerifier.STREAM_CHUNK, MK.installed(),
                len(keys), PEER_DRAIN, 1 + len(extra_.get(ch.height, ())),
            )
            out[ch.height] = (expect, outside)
            cur = cur.copy_increment_proposer_priority(1)
        return out, quorums

    results = {}
    start = gpu_verifier.stats()
    with tempfile.TemporaryDirectory(prefix="consensus-") as tmp:
        install_device_plane(cfg)
        settle_probes()
        try:
            rules, quorums = rules_for(chain, vals, node_priv, extra)
            light_rules, _ = rules_for(light_chain, light_vals, light_node, {})

            def attack_checks(node):
                """Each attack through verify_evidence on the node's
                stores, counted against reference_plan's windows."""
                state = node.state_store.load()
                out = {"forged_index": bad_at}
                for name, ev, commit, bad in (("ok", attack, attack_commit, -1),
                                              ("forged", forged_attack, forged_commit, bad_at)):
                    want, windows = reference_plan(vals, commit, "trusting", bad)
                    got = []
                    out[f"{name}_launches"] = count_one_call(
                        lambda: got.append(outcome(lambda: verify_evidence(
                            ev, state, node.state_store, node.block_store))),
                        {kt: (n, {"sr25519_verify": n} if kt == "sr25519"
                              else {"sha512_ram": n, "ed25519_verify_tile": n})
                         for kt, n in windows.items()},
                    )
                    if got[0] != want:
                        raise AssertionError(f"light-client attack ({name}): {got[0]}, not {want}")
                    out[f"{name}_outcome"], out[f"{name}_windows"] = list(got[0]), windows
                return out

            results["10k"] = run_consensus(
                torch, genesis, node_priv, chain, os.path.join(tmp, "device"), True,
                rules, extra, profile=(2, CONSENSUS_HEIGHTS),
                at_end=attack_checks,
            )
            results["150"] = run_consensus(
                torch, light_genesis, light_node, light_chain, os.path.join(tmp, "device150"),
                True, light_rules,
            )
            assert_no_fault(start, gpu_verifier.stats(), "consensus_heights")
        finally:
            uninstall_device_plane()
        # the CPU plane's reference runs CONSENSUS_CPU_HEIGHTS of the
        # 10k heights (the script's time: PERF.md §4)
        ref = run_consensus(torch, genesis, node_priv, chain[:CONSENSUS_CPU_HEIGHTS],
                            os.path.join(tmp, "cpu"), False, extra=extra)
        light_ref = run_consensus(torch, light_genesis, light_node, light_chain,
                                  os.path.join(tmp, "cpu150"), False)
    for name, got, want in (("10k", results["10k"], ref), ("150", results["150"], light_ref)):
        for h, stores in want["stores"].items():
            for key, value in stores.items():
                if got["stores"][h][key] != value:
                    raise AssertionError(f"{name} height {h}: {key} differs from the CPU plane's")
        ended = got["end_heights"][: len(want["end_heights"])]
        if ended != want["end_heights"] or len(want["end_heights"]) != len(want["runs"]):
            raise AssertionError(f"{name}: the WAL's EndHeight records differ from the CPU plane's")
        for res in (got, want):
            for run in res["runs"]:
                if run.round != 0:
                    raise AssertionError(f"{name} height {run.height} committed in round {run.round}")
                # acted on: height 1's start, and, reported, the next
                # height's timeout_commit where it fires before the last
                # late precommit is in (the node then starts the height
                # without it); any other timeout fails the run
                allowed = {(1, 0, 1)} if run.height == 1 else set()
                allowed.add((run.height + 1, 0, 1))
                stray = [t for t in run.timeouts if t[3] and t[:3] not in allowed]
                if stray:
                    raise AssertionError(f"{name} height {run.height}: timeouts acted on {stray}")
    equivocator = vals.validators[chain[CONSENSUS_FORGED_AT - 1].equivocator].address.hex()
    for res in (results["10k"], ref):
        if res["evidence"] != [["DuplicateVoteEvidence", equivocator]]:
            raise AssertionError(f"the pool holds {res['evidence']}, not the equivocation")
        got = res["proposals"][CONSENSUS_FORGED_AT]
        if got != [["ValueError", "invalid proposal signature"], ["ok", ""]]:
            raise AssertionError(f"the proposals at height {CONSENSUS_FORGED_AT}: {got}")

    # the device's busy time at heights 2..CONSENSUS_HEIGHTS, by kernel:
    # its mean time a record times the launches counted there
    dev = results["10k"]
    timed_heights = list(range(2, CONSENSUS_HEIGHTS + 1))
    launched: dict = {}
    for h in timed_heights:
        for name, n in dev["launches"][h].items():
            if name != "by_key_type" and n:
                launched[name] = launched.get(name, 0) + n
    busy, kept = {}, {}
    for name, n in launched.items():
        mine = [e for e in dev["profile"] if KERNEL_NAMES[name] in e.key]
        seen_n = sum(e.count for e in mine)
        kept[name] = seen_n
        if seen_n:
            busy[name] = sum(e.self_device_time_total for e in mine) / seen_n * n / 1e3
    wall_ms = sum(r.next_height_s for r in dev["runs"] if r.height in timed_heights) * 1e3
    stages = consensus_stages(dev, timed_heights)
    ref_stages = consensus_stages(ref, timed_heights)
    out = {
        "phase": "consensus_heights",
        "validators": {"ed25519": N_VALIDATORS - N_VALIDATORS // 2, "sr25519": N_VALIDATORS // 2},
        "heights": CONSENSUS_HEIGHTS,
        "txs_per_block": N_TXS,
        "parts_per_block": [len(ch.parts) for ch in chain],
        "node_index": vals.get_by_address(node_priv.pub_key().address())[0],
        "build_s": build_s,
        "quorum_vote_index": quorums,
        "rounds": [r.round for r in dev["runs"]],
        "timeouts": {r.height: r.timeouts for r in dev["runs"]},
        "cpu_plane_timeouts": {r.height: r.timeouts for r in ref["runs"]},
        # the next height's timeout_commit acted on before every late
        # precommit of a height was in, on the card and on the CPU plane
        "timeout_commit_fired_at": {
            name: [r.height + 1 for r in res["runs"] if (r.height + 1, 0, 1, True) in r.timeouts]
            for name, res in (("card", dev), ("cpu_plane", ref))
        },
        "launches_per_height": {
            h: {k: v for k, v in c.items() if k != "by_key_type" and v} for h, c in dev["launches"].items()
        },
        "rule_per_height": {
            h: {"windows": {k: v[0] for k, v in r[0].items()}, **r[1]} for h, r in rules.items()
        },
        "ms_p50_heights_2_3": stages,
        "cpu_plane_heights": CONSENSUS_CPU_HEIGHTS,
        "cpu_plane_ms_p50_heights_2_3": ref_stages,
        "device_busy_ms_heights_2_3": busy,
        "device_records_kept": kept,
        "device_kernels_not_measured": sorted(set(launched) - set(busy)),
        "device_idle_share": 1 - sum(busy.values()) / wall_ms,
        "forged_proposal": {"height": CONSENSUS_FORGED_AT,
                            "outcomes": dev["proposals"][CONSENSUS_FORGED_AT]},
        "equivocation": {"height": CONSENSUS_FORGED_AT, "pending": dev["evidence"]},
        "light_client_attack": dev["at_end"],
        "equal_to_cpu_plane": ["block", "block_meta", "seen_commit", "state", "app_hash", "end_heights"],
        "light": {
            "validators": LIGHT_VALIDATORS,
            "heights": CONSENSUS_LIGHT_HEIGHTS,
            "node_proposes_at": CONSENSUS_LIGHT_PROPOSES_AT,
            "rounds": [r.round for r in results["150"]["runs"]],
            "launches_per_height": {
                h: {k: v for k, v in c.items() if k != "by_key_type" and v}
                for h, c in results["150"]["launches"].items()
            },
            "height_ms": [r.end_height_s * 1e3 for r in results["150"]["runs"]],
            "height_through_apply_ms": [r.next_height_s * 1e3 for r in results["150"]["runs"]],
            "cpu_plane_height_ms": [r.end_height_s * 1e3 for r in light_ref["runs"]],
        },
        "phase_s": time.perf_counter() - t_phase,
        "ok": True,
    }
    emit(out)
    return {"launches": out["launches_per_height"], "light_launches": out["light"]["launches_per_height"]}


# the mempool and its gossip (phase mempool_proposer): B's pool admits
# MEMPOOL_DUPLICATES resubmissions and MEMPOOL_MALFORMED malformed
# validator txs among its N_TXS new ones, MEMPOOL_LATE more after the
# node's proposal; both pools MEMPOOL_SIZE deep (the JAX default of 5,000
# cannot hold a 10,000-tx block); MEMPOOL_TCP_TXS gossiped over TCP
MEMPOOL_SIZE = 20_000
MEMPOOL_DUPLICATES = 500
MEMPOOL_MALFORMED = 20
MEMPOOL_LATE = 2_000
MEMPOOL_TCP_TXS = 256
MEMPOOL_GOSSIP_TIMEOUT_S = 120.0
# the node's timeout_commit in this phase (the JAX default is 1 s): with
# skip_timeout_commit it enters its own height as the last late precommit
# of the height before is in, so the LastCommit of the block it proposes
# holds every validator, as the harness predicts; at 10k those ~3,100
# precommits can take longer than 1 s (PERF.md §7), and a node that
# proposes on its timeout_commit instead signs a block no vote is for.
# Height 1 starts after it, as it starts after 1 s by default.
MEMPOOL_TIMEOUT_COMMIT_S = 5.0
# the heights the CPU plane's reference runs (the script's time: PERF.md
# §4; 2 in PR 16, 3 before); where the node proposes among them, its
# height is compared too
MEMPOOL_CPU_HEIGHTS = 1
DUPLICATE = ("MempoolError", "tx already exists in cache")


def malformed_val_tx(i: int, rng) -> tuple:
    """A validator tx (`val:` prefix) kvstore's check_tx refuses, and the
    log it refuses it with (the JAX kvstore's messages): no `!`, a pubkey
    that is not hex, a power that is not an int, a negative power, in
    turn."""
    pk = rng.bytes(32).hex()
    kind = i % 4
    if kind == 0:
        return b"val:" + pk.encode(), "expected val:<pubkey>!<power>"
    if kind == 1:
        bad = "zz" + pk[2:]
        return f"val:{bad}!10".encode(), f"pubkey {bad!r} is not hex"
    if kind == 2:
        return f"val:{pk}!ten{i}".encode(), f"power {'ten%d' % i!r} is not an int"
    return f"val:{pk}!-{i + 1}".encode(), "power must be >= 0"


def mempool_stream(seed: int, txs: list) -> tuple:
    """B's admission stream: txs in order, with MEMPOOL_DUPLICATES
    resubmissions (each after its original) and MEMPOOL_MALFORMED
    malformed validator txs at seeded places; and each item's expected
    outcome: ("code", 0, "") admitted, DUPLICATE, or ("code", 1, log)."""
    rng = np.random.default_rng([seed, 30])
    extras = []
    for _ in range(MEMPOOL_DUPLICATES):
        at = int(rng.integers(1, len(txs) + 1))
        extras.append((at, txs[int(rng.integers(0, at))], DUPLICATE))
    for i in range(MEMPOOL_MALFORMED):
        tx, log = malformed_val_tx(i, rng)
        extras.append((int(rng.integers(0, len(txs) + 1)), tx, ("code", 1, log)))
    extras.sort(key=lambda e: e[0])
    stream, want, k = [], [], 0
    for i, tx in enumerate(txs + [None]):
        while k < len(extras) and extras[k][0] == i:
            stream.append(extras[k][1])
            want.append(extras[k][2])
            k += 1
        if tx is not None:
            stream.append(tx)
            want.append(("code", 0, ""))
    return stream, want


def check_outcome(res) -> tuple:
    """A check_tx_batch outcome as compared: (the error's type, its
    message) or ("code", code, log)."""
    if isinstance(res, Exception):
        return (type(res).__name__, str(res))
    return ("code", res.code, res.log)


def proposer_rule(chain, vals, node_priv, gate: int, step: int, merkle_gate: int, burst: int) -> dict:
    """consensus_rule of each height, and, in the span of the height
    before the node proposes, the two roots of its own block's header
    that create_proposal_block computes (State.make_block: the data root
    over the reaped txs, the LastCommit root): the node proposes as it
    enters its height, before that height's first message."""
    node_index, _ = vals.get_by_address(node_priv.pub_key().address())
    out, keys, cur = {}, set(), vals
    for k, ch in enumerate(chain):
        keys.update(t.partition(b"=")[0] for t in ch.block.txs)
        expect, outside, _ = consensus_rule(
            chain, k, vals, node_index, cur.get_proposer().pub_key.type(), gate, step,
            merkle_gate, len(keys), burst, 1,
        )
        if k + 1 < len(chain) and chain[k + 1].node_proposes:
            nxt = chain[k + 1].block
            own = [len(nxt.txs), len(nxt.last_commit.signatures)]
            outside = {"sha256_tree": outside["sha256_tree"] + sum(n >= merkle_gate for n in own)}
        out[ch.height] = (expect, outside)
        cur = cur.copy_increment_proposer_priority(1)
    return out


def run_tcp_gossip(seed: int, txs: list) -> dict:
    """Two gossip nodes on TCPTransport at 127.0.0.1:0 (B listening, A
    dialing), B's pool admitting txs, which reach A through
    SecretConnection on the pure-Python AEAD: each side must have
    authenticated the other's node ID, and A must hold every tx once,
    in B's order. Returns the handshakes' ms and the gossip's txs/s."""
    import asyncio

    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.config import MempoolConfig
    from tendermint_tpu_torch.p2p import transport as T
    from tendermint_tpu_torch.p2p.types import node_id_from_pubkey
    from tendermint_tpu_torch.workloads import admit, gossip_node, kv_mempool, node_key, wait_for_pool

    handshakes = []
    inner = T._TCPConnection.handshake

    async def timed_handshake(self, node_info, priv_key):
        t0 = time.perf_counter()
        try:
            return await inner(self, node_info, priv_key)
        finally:
            handshakes.append((time.perf_counter() - t0) * 1e3)

    async def run():
        cfg = MempoolConfig(size=MEMPOOL_SIZE)
        pa, pb = kv_mempool(KVStoreApplication(), cfg), kv_mempool(KVStoreApplication(), cfg)
        b = gossip_node(pb, node_key(seed, 11), T.TCPTransport(), CHAIN_ID,
                        listen_addr="127.0.0.1:0", moniker="tcp-b")
        a = gossip_node(pa, node_key(seed, 10), T.TCPTransport(), CHAIN_ID, moniker="tcp-a")
        await b.start()
        try:
            t_up = time.perf_counter()
            a.peer_manager.add(f"{b.node_id}@127.0.0.1:{b.router.transport.listen_port}")
            await a.start()
            try:
                deadline = time.monotonic() + 30
                while not (a.peer_manager.peers() and b.peer_manager.peers()):
                    if time.monotonic() > deadline:
                        raise AssertionError("the TCP peers did not connect")
                    await asyncio.sleep(0.001)
                up_ms = (time.perf_counter() - t_up) * 1e3
                seen = {}
                for me, other in ((a, b), (b, a)):
                    conn = me.router._peer_conns[other.node_id]
                    seen[me.node_id] = node_id_from_pubkey(conn._secret.remote_pubkey)
                if seen != {a.node_id: b.node_id, b.node_id: a.node_id}:
                    raise AssertionError(f"TCP: authenticated {seen}")
                t0 = time.perf_counter()
                outs, _ = await admit(pb, txs, cfg.tx_batch_size)
                if [check_outcome(r) for r in outs] != [("code", 0, "")] * len(txs):
                    raise AssertionError("TCP: B refused a tx")
                t1 = await wait_for_pool(pa, len(txs), MEMPOOL_GOSSIP_TIMEOUT_S)
                await asyncio.sleep(0.05)  # a second copy would land by now
                if pa.reap_max_txs(-1) != list(txs) or pa.size() != len(txs):
                    raise AssertionError("TCP: A's pool is not B's txs, once each, in order")
                return {"connect_ms": up_ms, "gossip_s": t1 - t0, "txs_per_s": len(txs) / (t1 - t0)}
            finally:
                await a.stop()
        finally:
            await b.stop()

    T._TCPConnection.handshake = timed_handshake
    try:
        out = asyncio.run(run())
    finally:
        T._TCPConnection.handshake = inner
    if len(handshakes) != 2:
        raise AssertionError(f"TCP: {len(handshakes)} handshakes, not 2")
    return {**out, "handshake_ms": handshakes, "txs": len(txs)}


def run_proposer(torch, genesis: str, node_priv, chain, stream: list, late: list,
                 home: str, seed: int, counted: bool, rules: dict = None,
                 profile: tuple = ()) -> dict:
    """Node A (workloads.consensus_node with a TxMempool of MEMPOOL_SIZE)
    and node B (a kvstore app and its pool) through
    workloads.drive_mempool_heights: B admits `stream`, its admitted txs
    gossip to A, A meets the chain and proposes its height from its
    pool, B admits `late` at that height's first message. With
    `counted`, each height's launches are zeroed at its first message,
    read when the node stands at the next one and checked against
    rules[height]; heights in `profile` run under torch.profiler. Also
    records what each pool receives from its peer, A's reap, A's pool
    after each height and the txs each recheck took. Returns what the
    phase checks and times."""
    import asyncio

    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.config import ConsensusConfig, MempoolConfig
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.workloads import consensus_node, drive_mempool_heights, kv_mempool

    mcfg = MempoolConfig(size=MEMPOOL_SIZE)
    ccfg = ConsensusConfig(skip_timeout_commit=True, timeout_commit=MEMPOOL_TIMEOUT_COMMIT_S)
    node = consensus_node(genesis, node_priv, home, ccfg, mempool_cfg=mcfg)
    pool_a, pool_b = node.mempool, kv_mempool(KVStoreApplication(), mcfg)
    out = {"stages": {}, "stores": {}, "launches": {}, "reaped": [], "received_by_b": 0,
           "received_by_a": [], "pool_after": {}, "recheck_txs": {}, "first_message": {},
           "after_s": {}}
    calls = {k: [] for k in ("validate_block", "verify_commit", "save_block", "wal",
                             "apply_block", "finalize", "update", "recheck",
                             "create_proposal_block")}
    marks, by_type, prof = {}, {}, {}

    # what each pool receives from its peer
    def receiving(pool, into):
        inner = pool.check_tx_batch

        async def wrapper(txs, tx_info=None):
            if tx_info is not None and tx_info.sender_id:
                into(txs)
            return await inner(txs, tx_info)

        pool.check_tx_batch = wrapper

    receiving(pool_a, out["received_by_a"].extend)
    receiving(pool_b, lambda txs: out.__setitem__("received_by_b", out["received_by_b"] + len(txs)))
    reap = pool_a.reap_max_bytes_max_gas

    def reaping(max_bytes, max_gas):
        t0 = time.perf_counter()
        txs = reap(max_bytes, max_gas)
        out["reap_ms"] = (time.perf_counter() - t0) * 1e3
        out["reaped"].append(txs)
        return txs

    pool_a.reap_max_bytes_max_gas = reaping
    clock_async(pool_a, "update", calls["update"])
    clock_async(pool_a, "_recheck", calls["recheck"])
    recheck = pool_a._recheck

    async def rechecking():
        out["recheck_txs"][node.cs.rs.height] = pool_a.size()
        return await recheck()

    pool_a._recheck = rechecking
    clock_async(node.executor, "apply_block", calls["apply_block"])
    clock_async(node.cs, "_finalize_commit", calls["finalize"])

    def before(h: int) -> None:
        marks[h] = {k: len(v) for k, v in calls.items()}
        out["first_message"][h] = time.perf_counter()
        if h in profile and "p" not in prof:
            from torch.profiler import ProfilerActivity, profile as make

            prof["p"] = make(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if counted:
            by_type.clear()
            marks[h]["stats"] = gpu_verifier.stats()
            reset_launches()

    def after(h: int) -> None:
        t_after = time.perf_counter()
        if counted:
            counts = launches()
            expect, outside = rules[h]
            out["launches"][h] = check_counts(
                marks[h]["stats"], gpu_verifier.stats(), by_type, counts, expect, outside,
                where=f"mempool_proposer height {h}",
            )
        if profile and h == profile[-1]:
            torch.cuda.synchronize()
            prof["p"].__exit__(None, None, None)
            out["profile"] = prof["p"].key_averages()
        out["stages"][h] = {k: v[marks[h][k]:] for k, v in calls.items()}
        out["pool_after"][h] = pool_a.reap_max_txs(-1)
        out["stores"][h] = {
            "block": node.block_store.load_block(h).to_proto(),
            "block_meta": node.block_store.load_block_meta(h).to_proto(),
            "seen_commit": node.block_store.load_seen_commit().to_proto(),
            "state": node.state_store.load().to_proto(),
            "app_hash": node.app.app_hash,
        }
        # this hook's own time: the next height's _enter_propose may
        # precede it, so proposer_stages takes it out of the own height
        out["after_s"][h] = time.perf_counter() - t_after

    try:
        with contextlib.ExitStack() as hooks:
            for owner, attr, into in (
                (node.executor, "validate_block", "validate_block"),
                (node.executor, "create_proposal_block", "create_proposal_block"),
                (execution, "verify_commit", "verify_commit"),
                (node.block_store, "save_block", "save_block"),
                (node.cs.wal, "write_end_height", "wal"),
            ):
                hooks.enter_context(timed(owner, attr, calls[into]))
            if counted:
                hooks.enter_context(charged_dispatches(by_type))
            out["run"] = asyncio.run(drive_mempool_heights(
                node, pool_b, chain, stream, late, seed, before, after, MEMPOOL_GOSSIP_TIMEOUT_S))
        out["end_heights"] = node.end_heights()
    finally:
        node.close()
    out["proposer_height"] = next((ch.height for ch in chain if ch.node_proposes), None)
    return out


def proposer_stages(res: dict) -> dict:
    """Host ms of the node's own height, from _enter_propose to
    EndHeight, by stage: create_proposal_block (with its roots), the own
    validate_block at prevote, prevote ingest, precommit ingest less
    finalize, finalize by part (validate_block, save_block, WAL,
    apply_block, and in it the mempool's update and recheck); and to the
    node at the next height. The harness's after() hook of the height
    before (reading the stores) runs after _enter_propose and is taken
    out."""
    mrun, h = res["run"], res["proposer_height"]
    prev, st = res["stages"][h - 1], res["stages"][h]
    run = next(r for r in mrun.runs if r.height == h)
    hook = res["after_s"][h - 1] * 1e3
    lead = (res["first_message"][h] - mrun.enter_propose_at) * 1e3 - hook
    fin = sum(st["finalize"])
    return {
        "height_ms": mrun.own_height_s * 1e3 - hook,
        "harness_hook_ms_taken_out": hook,
        "enter_propose_to_first_message_ms": lead,
        "create_proposal_block_ms": prev["create_proposal_block"][-1],
        # the own block's check at prevote: that span's last validate_block
        "own_validate_block_ms": prev["validate_block"][-1],
        "prevote_ingest_ms": (run.prevotes_s - run.proposal_s) * 1e3,
        "precommit_ingest_ms": (run.precommits_s - run.prevotes_s) * 1e3 - fin,
        "finalize_ms": fin,
        "finalize_validate_block_ms": st["validate_block"][-2],
        "finalize_save_block_ms": sum(st["save_block"]),
        "finalize_wal_ms": sum(st["wal"]),
        "finalize_apply_block_ms": sum(st["apply_block"]),
        "finalize_mempool_update_ms": sum(st["update"]),
        "finalize_mempool_recheck_ms": sum(st["recheck"]),
        "verify_commit_ms": prev["verify_commit"][-1:] + st["verify_commit"],
        "to_next_height_ms": lead + run.next_height_s * 1e3,
    }


def phase_mempool_proposer(torch, seed: int) -> dict:
    """The mempool and its gossip with the device plane installed
    (install_device_plane(GPUConfig()), then settle_probes()): at config
    5's mixed 10k genesis, node A, a validator (workloads.consensus_node:
    the ed25519 member that proposes round 0 of the first height from 2
    on whose proposer holds an ed25519 key, FilePV, WAL, evidence pool
    and event bus on SqliteKV) with a TxMempool, and node B, a kvstore
    app and its TxMempool, each with a router and the mempool reactor on
    one MemoryNetwork; both pools take the JAX MempoolConfig but
    size=MEMPOOL_SIZE. B admits N_TXS new kvstore txs (TX_LENGTHS bytes)
    with MEMPOOL_DUPLICATES resubmissions and MEMPOOL_MALFORMED malformed
    validator txs among them through check_tx_batch in batches of 64;
    the admitted txs gossip to A on channel 0x30. Once A holds them all,
    the heights before A's come from the harness with N_TXS other txs
    (A's update rechecks its pool at each commit); A proposes its
    height, reaping all of B's txs in B's order, and the harness feeds
    the other validators' prevotes and precommits for that block
    (workloads.build_consensus_chain with node_reaps); at its first
    message B admits MEMPOOL_LATE more; the next height comes from the
    harness. Checks: B's outcomes (the duplicates and the malformed txs
    refused with the JAX messages), A never receives a refused tx nor one
    twice, nothing is sent back to B, A's block is B's txs in order, every
    height commits in round 0 with the launches of proposer_rule, A's
    pool holds none of the committed txs after its height and every late
    tx at the end, no fault and no reroute; the blocks, seen commits,
    state, app hash, WAL EndHeight records and A's reap equal the same
    run on the native CPU plane through its first MEMPOOL_CPU_HEIGHTS
    heights (A's reap too where A's height is among them; the reference
    is cut to keep the script's time). Also MEMPOOL_TCP_TXS txs over TCP
    (run_tcp_gossip). Timed: B's admission, the gossip, the recheck, the
    reap, A's height by stage (proposer_stages), the device's busy time
    and idle share over A's height and the one before it."""
    import tempfile

    from tendermint_tpu_torch.config import GPUConfig, P2PConfig
    from tendermint_tpu_torch.consensus.state import PEER_DRAIN
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle, sigcache
    from tendermint_tpu_torch.crypto.gpu_verifier import _GpuBatchVerifier
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.types.tx import txs_hash
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    from tendermint_tpu_torch.workloads import (
        build_consensus_chain,
        first_proposer_height,
        kv_genesis,
        kv_txs,
        seeded_keys,
    )

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before mempool_proposer")
    cfg = GPUConfig()
    t_phase = time.perf_counter()

    # the traffic, built on the CPU plane
    t0 = time.perf_counter()
    privs = seeded_keys(N_VALIDATORS, seed, N_VALIDATORS // 2)
    genesis = kv_genesis(CHAIN_ID, privs)
    proposer_h = first_proposer_height(privs)
    heights = proposer_h + 1
    node_priv = consensus_node_priv(privs, heights, proposer_h)
    gossiped = kv_txs(seed + 1, proposer_h, N_TXS, TX_LENGTHS)
    late = kv_txs(seed + 1, proposer_h + 1, MEMPOOL_LATE, TX_LENGTHS)
    txs = [gossiped if h == proposer_h else kv_txs(seed, h, N_TXS, TX_LENGTHS)
           for h in range(1, heights + 1)]
    chain = build_consensus_chain(genesis, privs, node_priv, txs, seed, node_reaps=True)
    stream, want = mempool_stream(seed, gossiped)
    vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    tcp_txs = kv_txs(seed + 2, 1, MEMPOOL_TCP_TXS, TX_LENGTHS)
    build_s = time.perf_counter() - t0
    if [ch.height for ch in chain if ch.node_proposes] != [proposer_h]:
        raise AssertionError("the node must propose exactly one height")

    with tempfile.TemporaryDirectory(prefix="mempool-") as tmp:
        # an empty verified-signature cache: consensus_heights's
        # reference leaves the same harness votes of heights 1-2 in it
        sigcache.reset()
        start = gpu_verifier.stats()
        install_device_plane(cfg)
        settle_probes()
        try:
            rules = proposer_rule(chain, vals, node_priv, cfg.min_batch_size,
                                  _GpuBatchVerifier.STREAM_CHUNK, MK.installed(), PEER_DRAIN)
            dev = run_proposer(torch, genesis, node_priv, chain, stream, late,
                               os.path.join(tmp, "device"), seed, True, rules,
                               profile=(proposer_h - 1, proposer_h))
            assert_no_fault(start, gpu_verifier.stats(), "mempool_proposer")
        finally:
            uninstall_device_plane()
        # the CPU plane's reference: its first heights (the node's own
        # among them where it proposes by MEMPOOL_CPU_HEIGHTS)
        cpu_heights = min(MEMPOOL_CPU_HEIGHTS, proposer_h)
        sigcache.reset()
        ref = run_proposer(torch, genesis, node_priv, chain[:cpu_heights], stream, late,
                           os.path.join(tmp, "cpu"), seed, False)
    tcp = run_tcp_gossip(seed, tcp_txs)  # host only: no device plane to compare

    committed = set(gossiped)
    refused = {tx for tx, w in zip(stream, want) if w != ("code", 0, "")} - committed
    for name, res in (("card", dev), ("cpu_plane", ref)):
        mrun = res["run"]
        proposed = res["proposer_height"] is not None
        got = [check_outcome(r) for r in mrun.outcomes]
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"{name}: B's outcome {bad} is {got[bad]}, not {want[bad]}")
        late_in = late if proposed else []
        if [check_outcome(r) for r in mrun.late_outcomes] != [("code", 0, "")] * len(late_in):
            raise AssertionError(f"{name}: B refused a late tx")
        got = res["received_by_a"]
        if got != gossiped + late_in or refused & set(got):
            raise AssertionError(f"{name}: A received {len(got)} txs, not B's admitted ones once each in order")
        if res["received_by_b"]:
            raise AssertionError(f"{name}: {res['received_by_b']} txs were sent back to B")
        if proposed:
            # (a run cut short before A's height may or may not have
            # reaped as A entered it: not compared)
            if res["reaped"] != [gossiped]:
                raise AssertionError(f"{name}: A reaped {[len(r) for r in res['reaped']]} txs, not B's {len(gossiped)}")
            if res["stores"][proposer_h]["block"] != chain[proposer_h - 1].block.to_proto():
                raise AssertionError(f"{name}: A's block at {proposer_h} is not the harness's")
            after_own = res["pool_after"][proposer_h]
            if committed & set(after_own) or not set(after_own) <= set(late):
                raise AssertionError(f"{name}: A's pool after its height holds a committed or foreign tx")
        if chain[proposer_h - 1].block.header.data_hash != txs_hash(gossiped):
            raise AssertionError(f"{name}: the data hash is not the host's root")
        if mrun.pool_end != (late if proposed else gossiped):
            raise AssertionError(f"{name}: A's pool at the end is not the late txs in order")
        for run in mrun.runs:
            if run.round != 0:
                raise AssertionError(f"{name} height {run.height} committed in round {run.round}")
            allowed = {(1, 0, 1)} if run.height == 1 else set()
            allowed.add((run.height + 1, 0, 1))
            stray = [t for t in run.timeouts if t[3] and t[:3] not in allowed]
            if stray:
                raise AssertionError(f"{name} height {run.height}: timeouts acted on {stray}")
    for h, stores in ref["stores"].items():
        for key, value in stores.items():
            if dev["stores"][h][key] != value:
                raise AssertionError(f"mempool_proposer height {h}: {key} differs from the CPU plane's")
    if (dev["end_heights"][:cpu_heights] != ref["end_heights"]
            or (len(dev["end_heights"]), len(ref["end_heights"])) != (heights, cpu_heights)):
        raise AssertionError("mempool_proposer: the WAL's EndHeight records differ from the CPU plane's")
    if ref["proposer_height"] is not None and dev["reaped"] != ref["reaped"]:
        raise AssertionError("mempool_proposer: A's reap differs from the CPU plane's")

    # the device's busy time over the profiled heights, by kernel
    timed_heights = [proposer_h - 1, proposer_h]
    launched: dict = {}
    for h in timed_heights:
        for name, n in dev["launches"][h].items():
            if name != "by_key_type" and n:
                launched[name] = launched.get(name, 0) + n
    busy, kept = {}, {}
    for name, n in launched.items():
        mine = [e for e in dev["profile"] if KERNEL_NAMES[name] in e.key]
        seen_n = sum(e.count for e in mine)
        kept[name] = seen_n
        if seen_n:
            busy[name] = sum(e.self_device_time_total for e in mine) / seen_n * n / 1e3
    wall_ms = sum(r.next_height_s for r in dev["run"].runs if r.height in timed_heights) * 1e3
    n_bytes = sum(len(t) for t in gossiped)
    send_rate = P2PConfig().send_rate  # bytes/s
    out = {
        "phase": "mempool_proposer",
        "validators": {"ed25519": N_VALIDATORS - N_VALIDATORS // 2, "sr25519": N_VALIDATORS // 2},
        "heights": heights,
        "proposer_height": proposer_h,
        "node_index": vals.get_by_address(node_priv.pub_key().address())[0],
        "mempool_size": MEMPOOL_SIZE,
        "stream": {"new": len(gossiped), "duplicates": MEMPOOL_DUPLICATES,
                   "malformed": MEMPOOL_MALFORMED, "late": MEMPOOL_LATE},
        "build_s": build_s,
        "rounds": [r.round for r in dev["run"].runs],
        "timeouts": {r.height: r.timeouts for r in dev["run"].runs},
        "launches_per_height": {
            h: {k: v for k, v in c.items() if k != "by_key_type" and v} for h, c in dev["launches"].items()
        },
        "rule_per_height": {
            h: {"windows": {k: v[0] for k, v in r[0].items()}, **r[1]} for h, r in rules.items()
        },
        "gossip_bytes": n_bytes,
        "send_rate_floor_s": n_bytes / send_rate,
        "rechecked_txs_by_height": dev["recheck_txs"],
        "cpu_plane_rechecked_txs_by_height": ref["recheck_txs"],
        "equal_to_cpu_plane": ["block", "block_meta", "seen_commit", "state", "app_hash",
                               "end_heights", "reaped"],
        "cpu_plane_heights": cpu_heights,
        "device_busy_ms_own_and_previous_height": busy,
        "device_records_kept": kept,
        "device_kernels_not_measured": sorted(set(launched) - set(busy)),
        "device_idle_share": 1 - sum(busy.values()) / wall_ms,
        "ok": True,
    }
    for name, res in (("card", dev), ("cpu_plane", ref)):
        mrun = res["run"]
        out[name] = {
            "admission_txs_per_s": len(stream) / mrun.admit_s,
            "admission_s": mrun.admit_s,
            "gossip_s": mrun.gossip_s,
            "gossip_txs_per_s": len(gossiped) / mrun.gossip_s,
            "recheck_ms_height_1": res["stages"][1]["recheck"],
            "reap_ms": res.get("reap_ms"),
            "own_height_ms": proposer_stages(res) if res["proposer_height"] is not None else None,
            "height_ms": [r.end_height_s * 1e3 for r in mrun.runs],
        }
    out["tcp"] = tcp
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"launches": out["launches_per_height"]}


# consensus gossip (phase consensus_gossip): three real validators of
# config 5's mixed set (A proposes height GOSSIP_PROPOSES_AT, C
# equivocates on its prevote of GOSSIP_EQUIVOCATE_AT) and the harness
# peer on one MemoryNetwork; GOSSIP_TXS txs in each harness block and in
# B's pool, which A reaps; the CPU plane's reference runs
# GOSSIP_CPU_HEIGHTS heights (none, cut from 2 and then 1 for the
# script's time: PERF.md §4)
GOSSIP_HEIGHTS = 3
GOSSIP_PROPOSES_AT = 3
GOSSIP_EQUIVOCATE_AT = 2
GOSSIP_TXS = 2_000
GOSSIP_CPU_HEIGHTS = 0
GOSSIP_TIMEOUT_S = 120.0
# at GOSSIP_EQUIVOCATE_AT the harness holds its votes until a node found
# C's two prevotes, this long at most: the HasVote of the first one can
# mark the index at every peer, so the second travels only once a live
# stall reset (2 s of a frozen round state) makes a node resend it
GOSSIP_DETECT_S = 15.0
GOSSIP_MONIKERS = ("node-a", "node-b", "node-c")


def burst_survivors(cs, batch) -> dict:
    """What cs._preverify_votes will verify of `batch`, read before it
    runs: by key type, the votes of the node's height with a 64-byte
    signature, an index in its set and that validator's address, whose
    triple the verified-signature cache does not hold (looked up without
    touching the cache)."""
    from tendermint_tpu_torch.consensus.msgs import VoteMessage
    from tendermint_tpu_torch.crypto import sigcache

    rs, chain_id = cs.rs, cs.state.chain_id
    out: dict = {}
    for mi in batch:
        if not isinstance(mi.msg, VoteMessage):
            continue
        v = mi.msg.vote
        if v.height != rs.height or len(v.signature) != 64:
            continue
        addr, val = rs.validators.get_by_index(v.validator_index)
        if val is None or addr != v.validator_address or val.pub_key.address() != v.validator_address:
            continue
        key = (val.pub_key.bytes(), v.sign_bytes(chain_id), v.signature)
        if key in sigcache._gen0 or key in sigcache._gen1:
            continue
        kt = val.pub_key.type()
        out[kt] = out.get(kt, 0) + 1
    return out


def window_rule(by_type: dict, gate: int, step: int) -> dict:
    """The launches of a batch verify of by_type[kt] signatures a key
    type: none under the gate (the native CPU plane), else a window of up
    to `step` each; X1 and K2 a window of ed25519, X3 one of sr25519."""
    ed, sr = by_type.get("ed25519", 0), by_type.get("sr25519", 0)
    w_ed = -(-ed // step) if ed >= max(gate, 2) else 0
    w_sr = -(-sr // step) if sr >= max(gate, 2) else 0
    return {"sha512_ram": w_ed, "ed25519_verify_tile": w_ed, "sr25519_verify": w_sr}


def exact(got: dict, want: dict) -> bool:
    """got has want's launches and none of any other kernel."""
    return all(got.get(k, 0) == want.get(k, 0) for k in set(got) | set(want))


def run_gossip(torch, genesis: str, privs, keys: tuple, node_keys: tuple, txs: list, pool_txs: list,
               home: str, seed: int, counted: bool, profile: tuple = ()) -> dict:
    """workloads.run_gossip_network: A, B and C (each a consensus_node
    with a TxMempool of MEMPOOL_SIZE and a timeout_commit of
    MEMPOOL_TIMEOUT_COMMIT_S) and the harness peer, C's prevote of
    GOSSIP_EQUIVOCATE_AT doubled by the Byzantine plane's equivocate
    rule. Every pre-verify burst records its size, and with `counted`
    its launches beside the rule of its survivors by key type (read
    before it runs); so does every verify_commit call; the run's
    launches are zeroed just before it and read just after; heights in
    `profile` run under torch.profiler. Each node's block, raw state
    bytes and app hash are read once every node stands past a height.
    Returns what the phase checks and reports."""
    import asyncio

    from tendermint_tpu_torch.config import ConsensusConfig, MempoolConfig
    from tendermint_tpu_torch.consensus import byzantine
    from tendermint_tpu_torch.consensus import peer_state, reactor as cs_reactor
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.gpu_verifier import _GpuBatchVerifier
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.state import store as state_store
    from tendermint_tpu_torch.workloads import run_gossip_network

    gate = gpu_verifier.installed() or 0
    step = _GpuBatchVerifier.STREAM_CHUNK
    out = {"bursts": [], "commits": [], "picks_ms": {}, "stores": {}, "evidence_in": {},
           "detected": {}, "profile": None, "x4_by_height": {}, "x4_seen": 0}
    current = [0]
    prof: dict = {}
    nodes: list = []

    def record(vn) -> None:
        cs, name, pool = vn.node.cs, vn.moniker, vn.node.evpool
        preverify, report, add = cs._preverify_votes, pool.report_conflicting_votes, pool.add_evidence

        def preverifying(batch):
            entry = {"node": name, "height": cs.rs.height, "size": len(batch)}
            if counted:
                entry["want"] = window_rule(burst_survivors(cs, batch), gate, step)
                before_ = launches()
            preverify(batch)
            if counted:
                entry["got"] = {k: n - before_[k] for k, n in launches().items()}
            out["bursts"].append(entry)

        def reported(a, b):
            out["detected"].setdefault(name, []).append((a.height, a.type, a.validator_index))
            report(a, b)

        def added(ev):
            known = pool.is_pending(ev) or pool.is_committed(ev)
            add(ev)
            out["evidence_in"].setdefault(name, []).append(
                {"hash": ev.hash().hex(), "height": cs.rs.height, "known": known})

        cs._preverify_votes = preverifying
        pool.report_conflicting_votes = reported
        pool.add_evidence = added

    def instrument(made, harness) -> None:
        nodes.extend(made)
        for vn in made:
            record(vn)
        c = made[2]
        out["byzantine"] = byzantine.maybe_install(c.node.cs, c.consensus, c.moniker)
        out["real_ids"] = {vn.moniker: vn.node_id for vn in made}
        out["harness_id"] = harness.node_id
        if counted:
            reset_launches()
        out["t0"] = time.perf_counter()

    def before(h: int) -> None:
        current[0] = h
        if h in profile and "p" not in prof:
            from torch.profiler import ProfilerActivity, profile as make

            prof["p"] = make(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()

    def after(h: int) -> None:
        if profile and h == profile[-1] and "p" in prof:
            torch.cuda.synchronize()
            out["profile_wall_s"] = time.perf_counter() - prof["t0"]
            prof["p"].__exit__(None, None, None)
            out["profile"] = prof["p"].key_averages()
        if h == GOSSIP_EQUIVOCATE_AT:
            out["targets"] = out["byzantine"]._target_peers()
        if counted:
            # X4 launches outside the spans, by the harness's heights
            x4 = launches()["sha256_tree"]
            out["x4_by_height"][h] = x4 - out["x4_seen"]
            out["x4_seen"] = x4
        out["stores"][h] = {
            vn.moniker: {
                "block": vn.node.block_store.load_block(h).to_proto(),
                # the stored bytes: decoding a 10k set three times a
                # height would cost ~1 s of the run
                "state": vn.node.state_store._db.get(state_store._STATE),
                "app_hash": vn.node.app.app_hash,
            }
            for vn in nodes
        }

    async def hold(h: int) -> None:
        if h != GOSSIP_EQUIVOCATE_AT:
            return
        t0 = time.perf_counter()
        while not out["detected"] and time.perf_counter() - t0 < GOSSIP_DETECT_S:
            await asyncio.sleep(0.01)
        out["held_ms"] = (time.perf_counter() - t0) * 1e3

    def clocked(fn):
        def wrapper(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                out["picks_ms"][current[0]] = out["picks_ms"].get(current[0], 0.0) + ms

        return wrapper

    inner_verify = execution.verify_commit

    def verifying(chain_id, vals, block_id, height, commit):
        present: dict = {}
        for v, s in zip(vals.validators, commit.signatures):
            if not s.is_absent():
                present[v.pub_key.type()] = present.get(v.pub_key.type(), 0) + 1
        before_ = launches()
        try:
            return inner_verify(chain_id, vals, block_id, height, commit)
        finally:
            if counted:
                # a block's LastCommit: the block's height is commit's + 1
                out["commits"].append({
                    "height": height + 1, "present": present, "want": window_rule(present, gate, step),
                    "got": {k: n - before_[k] for k, n in launches().items()},
                })

    picks = ((peer_state.PeerState, "pick_vote_to_send"),
             (cs_reactor.ConsensusReactor, "_send_commit_vote"),
             (cs_reactor.ConsensusReactor, "_pick_part_to_send"))
    originals = {(cls, attr): cls.__dict__[attr] for cls, attr in picks}
    ccfg = ConsensusConfig(skip_timeout_commit=True, timeout_commit=MEMPOOL_TIMEOUT_COMMIT_S)
    with byzantine.inject("equivocate", h_lo=GOSSIP_EQUIVOCATE_AT, h_hi=GOSSIP_EQUIVOCATE_AT,
                          step="prevote", victim=GOSSIP_MONIKERS[2], seed=seed):
        try:
            for (cls, attr), fn in originals.items():
                setattr(cls, attr, clocked(fn))
            execution.verify_commit = verifying
            out["run"] = run_gossip_network(
                genesis, privs, keys, node_keys, txs, pool_txs, home, seed, ccfg,
                MempoolConfig(size=MEMPOOL_SIZE), instrument, before, after, GOSSIP_MONIKERS,
                GOSSIP_TIMEOUT_S, hold,
            )
            out["run_s"] = time.perf_counter() - out["t0"]
            if counted:
                out["launches"] = launches()
        finally:
            execution.verify_commit = inner_verify
            for (cls, attr), fn in originals.items():
                setattr(cls, attr, fn)
            fired = list(out["byzantine"].fired) if out.get("byzantine") else []
            byzantine.reset()
    out["fired"] = fired
    return out


def phase_consensus_gossip(torch, seed: int) -> dict:
    """Consensus gossip with the device plane installed
    (install_device_plane(GPUConfig()), then settle_probes()): config 5's
    mixed 10k genesis; validators A (the proposer of height
    GOSSIP_PROPOSES_AT), B (ed25519) and C (sr25519 where the set has
    one; workloads.gossip_keys), each a consensus_node (FilePV, WAL,
    evidence pool and event bus on SqliteKV, a TxMempool) on a router
    with the consensus, mempool and evidence reactors, and the harness
    peer H with the consensus channels and no step machine, all on one
    MemoryNetwork in a full mesh (workloads.run_gossip_network). B admits
    GOSSIP_TXS kvstore txs, which the mempool reactors carry to A and C.
    The harness signs for the other 9,997 validators: its proposals and
    parts go from H to one node, each of its votes to one node (index mod
    3), the rest travels by the reactors' gossip; at A's height it signs
    A's block as A made it. C's prevote at GOSSIP_EQUIVOCATE_AT is
    doubled towards the first of its peers in node ID order, a real node
    (workloads.gossip_node_keys); the harness holds that height's votes
    until a node has found the two prevotes (GOSSIP_DETECT_S at most). Checks: every node commits heights
    1..GOSSIP_HEIGHTS in round 0 with the same blocks and app hashes,
    each block the one its proposer made; A's block carries B's txs and
    C's DuplicateVoteEvidence, and every node that did not find the
    conflict itself got it through its evidence reactor before height
    GOSSIP_PROPOSES_AT ended; every pre-verify burst launches what its
    recorded survivors imply (a window a key type at the gate of 32 or
    more, none under it), every LastCommit verify_commit its windows,
    nothing else launches but X4, and the pre-verify launches X1 and X3;
    no fault or reroute; and the CPU plane's run of heights
    1..GOSSIP_CPU_HEIGHTS (none for now: the script's time) gives the
    same blocks, states and app hashes at every node. Reports, a height: ms from the proposal to each node's
    EndHeight and their spread, the proposal's ms to the complete block
    at the farthest node, votes/s by gossip from real peers and from H,
    duplicates, envelopes by channel (HasVote apart), burst sizes, the
    picks' ms, launches; device busy ms and idle share over heights
    2..GOSSIP_HEIGHTS; the phase's seconds."""
    import tempfile

    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle, sigcache
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    from tendermint_tpu_torch.workloads import (
        gossip_keys,
        gossip_node_keys,
        kv_genesis,
        kv_txs,
        seeded_keys,
        seeded_witness,
    )

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before consensus_gossip")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    privs = seeded_keys(N_VALIDATORS, seed, N_VALIDATORS // 2)
    genesis = kv_genesis(CHAIN_ID, privs)
    keys = gossip_keys(privs, GOSSIP_HEIGHTS, GOSSIP_PROPOSES_AT)
    for p in keys:
        seeded_witness(p, seed)
    node_keys = gossip_node_keys(seed)
    txs = [kv_txs(seed + 3, h, GOSSIP_TXS, TX_LENGTHS) for h in range(1, GOSSIP_HEIGHTS + 1)]
    pool_txs = kv_txs(seed + 4, GOSSIP_PROPOSES_AT, GOSSIP_TXS, TX_LENGTHS)
    vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    build_s = time.perf_counter() - t0
    if any(p.type() == "sr25519" for p in privs) and not any(p.type() == "sr25519" for p in keys):
        raise AssertionError("no real node holds an sr25519 key")

    with tempfile.TemporaryDirectory(prefix="gossip-") as tmp:
        sigcache.reset()
        start = gpu_verifier.stats()
        install_device_plane(GPUConfig())
        settle_probes()
        try:
            dev = run_gossip(torch, genesis, privs, keys, node_keys, txs, pool_txs,
                             os.path.join(tmp, "device"), seed, True, profile=(2, GOSSIP_HEIGHTS))
            assert_no_fault(start, gpu_verifier.stats(), "consensus_gossip")
        finally:
            uninstall_device_plane()
        sigcache.reset()
        ref = None
        if GOSSIP_CPU_HEIGHTS:
            t_ref = time.perf_counter()
            ref = run_gossip(torch, genesis, privs, keys, node_keys, txs[:GOSSIP_CPU_HEIGHTS], pool_txs,
                             os.path.join(tmp, "cpu"), seed, False)
            ref_s = time.perf_counter() - t_ref

    run = dev["run"]
    ids = dev["real_ids"]
    if not dev["targets"] or not set(dev["targets"]) <= {ids["node-a"], ids["node-b"]}:
        raise AssertionError(f"C's equivocation targets {dev['targets']}, not a real node")
    if dev["fired"] != [("equivocate", GOSSIP_EQUIVOCATE_AT, 0, 1)]:
        raise AssertionError(f"C's rule fired {dev['fired']}")
    # every node commits every height in round 0, the same bytes, the
    # proposer's block
    for g in run.heights:
        if set(g.rounds.values()) != {0} or len(g.rounds) != 3:
            raise AssertionError(f"height {g.height} committed in rounds {g.rounds}")
        stores = dev["stores"][g.height]
        for key in ("block", "state", "app_hash"):
            if len({s[key] for s in stores.values()}) != 1:
                raise AssertionError(f"the nodes' {key} differ at height {g.height}")
        if stores["node-a"]["block"] != g.block.to_proto():
            raise AssertionError(f"height {g.height}'s block is not the one its proposer made")
        want = "node-a" if g.height == GOSSIP_PROPOSES_AT else "harness"
        if g.proposer != want:
            raise AssertionError(f"height {g.height} was proposed by {g.proposer}, not {want}")
    own = next(g for g in run.heights if g.height == GOSSIP_PROPOSES_AT)
    if sorted(own.block.txs) != sorted(pool_txs):
        raise AssertionError("A's block is not B's gossiped txs")
    evidence = list(own.block.evidence)
    c_addr = keys[2].pub_key().address()
    if (len(evidence) != 1 or not isinstance(evidence[0], DuplicateVoteEvidence)
            or evidence[0].vote_a.validator_address != c_addr
            or evidence[0].vote_a.height != GOSSIP_EQUIVOCATE_AT):
        raise AssertionError(f"A's block carries {evidence}, not C's equivocation")
    ev_hash = evidence[0].hash().hex()
    detected = sorted(dev["detected"])
    through_reactor = sorted(n for n, items in dev["evidence_in"].items()
                             if any(i["hash"] == ev_hash and i["height"] <= GOSSIP_PROPOSES_AT for i in items))
    if not detected or "node-c" in detected:
        raise AssertionError(f"the conflict was found by {detected}")
    missing = set(GOSSIP_MONIKERS) - set(detected) - set(through_reactor)
    if missing:
        raise AssertionError(f"the evidence never reached {sorted(missing)} through the evidence reactor")
    # launches: each burst and each verify_commit its rule, the rest X4
    for b in dev["bursts"]:
        if not exact(b["got"], b["want"]):
            raise AssertionError(f"a pre-verify burst launched {b['got']}, not {b['want']}: {b}")
    for c in dev["commits"]:
        if not exact(c["got"], c["want"]):
            raise AssertionError(f"a verify_commit launched {c['got']}, not {c['want']}")
    spans = dev["bursts"] + dev["commits"]
    inside = {k: sum(x["got"][k] for x in spans) for k in dev["launches"]}
    outside = {k: n - inside[k] for k, n in dev["launches"].items()}
    if any(n for k, n in outside.items() if k != "sha256_tree"):
        raise AssertionError(f"launches outside a pre-verify or verify_commit: {outside}")
    preverify = {k: sum(b["got"][k] for b in dev["bursts"]) for k in dev["launches"]}
    if not preverify["sha512_ram"] or not preverify["sr25519_verify"]:
        raise AssertionError(f"the pre-verify launched {preverify} at 10k")
    for name in ("sha512_ram", "ed25519_verify_tile", "sr25519_verify", "sha256_tree"):
        if not dev["launches"][name]:
            raise AssertionError(f"{name} was not launched on consensus_gossip")
    # the CPU plane's heights
    for h in range(1, GOSSIP_CPU_HEIGHTS + 1):
        for name in GOSSIP_MONIKERS:
            for key in ("block", "state", "app_hash"):
                if dev["stores"][h][name][key] != ref["stores"][h][name][key]:
                    raise AssertionError(f"consensus_gossip height {h}: {name}'s {key} differs from the CPU plane's")

    def height_report(res: dict, g) -> dict:
        r, h = res["run"], g.height
        ends = {n: g.end_height_at[n] - g.proposal_at for n in GOSSIP_MONIKERS}
        dur = max(ends.values())
        bursts = [x for x in res["bursts"] if x["height"] == h]
        sizes = [x["size"] for x in bursts]
        rep = {
            "proposer": g.proposer,
            "proposal_sent_to": g.sent_to,
            "ms_to_end_height": {n: s * 1e3 for n, s in ends.items()},
            "commit_spread_ms": (max(ends.values()) - min(ends.values())) * 1e3,
            "proposal_to_complete_block_farthest_ms": (max(g.complete_at.values()) - g.proposal_at) * 1e3,
            "gossip_votes_per_s": {n: r.votes_from_peers[n].get(h, 0) / dur for n in GOSSIP_MONIKERS},
            "harness_votes_per_s": {n: r.votes_from_harness[n].get(h, 0) / dur for n in GOSSIP_MONIKERS},
            "votes_from_peers": {n: r.votes_from_peers[n].get(h, 0) for n in GOSSIP_MONIKERS},
            "votes_from_harness": {n: r.votes_from_harness[n].get(h, 0) for n in GOSSIP_MONIKERS},
            "duplicate_votes": {n: r.duplicate_votes[n].get(h, 0) for n in GOSSIP_MONIKERS},
            "envelopes": {n: r.envelopes[n].get(h, {}) for n in GOSSIP_MONIKERS},
            "timeouts_acted": {n: [t[:2] for t in g.timeouts[n] if t[2]] for n in GOSSIP_MONIKERS},
            "bursts": len(bursts),
            "burst_size_min_median_max": [min(sizes), float(np.median(sizes)), max(sizes)] if sizes else None,
            "picks_ms": res["picks_ms"].get(h, 0.0),
        }
        if "launches" in res:
            commits = [c for c in res["commits"] if c["height"] == h]
            rep["verify_commit_calls"] = len(commits)
            rep["preverify_launches"] = {k: sum(x["got"][k] for x in bursts) for k in res["launches"]
                                         if sum(x["got"][k] for x in bursts)}
            rep["launches"] = {k: sum(x["got"][k] for x in bursts + commits) for k in res["launches"]
                               if sum(x["got"][k] for x in bursts + commits)}
            # X4 from one after() to the next: the roots of that span
            rep["launches"]["sha256_tree"] = res["x4_by_height"][h]
        return rep

    by_height = {g.height: height_report(dev, g) for g in run.heights}
    # the device's busy time over the profiled heights, by kernel: each
    # kernel's mean time a record times its launches there
    launched: dict = {}
    for h in range(2, GOSSIP_HEIGHTS + 1):
        for k, n in by_height[h]["launches"].items():
            launched[k] = launched.get(k, 0) + n
    busy, kept = {}, {}
    for name, n in launched.items():
        mine = [e for e in dev["profile"] if KERNEL_NAMES[name] in e.key]
        kept[name] = sum(e.count for e in mine)
        if kept[name]:
            busy[name] = sum(e.self_device_time_total for e in mine) / kept[name] * n / 1e3
    out = {
        "phase": "consensus_gossip",
        "validators": {"ed25519": N_VALIDATORS - N_VALIDATORS // 2, "sr25519": N_VALIDATORS // 2},
        "real_nodes": {n: {"key_type": k.type(), "index": vals.get_by_address(k.pub_key().address())[0]}
                       for n, k in zip(GOSSIP_MONIKERS, keys)},
        "heights": GOSSIP_HEIGHTS,
        "txs_a_block": GOSSIP_TXS,
        "build_s": build_s,
        "tx_gossip_s": run.tx_gossip_s,
        "run_s": dev["run_s"],
        "equivocation": {"fired": dev["fired"], "targets": dev["targets"], "found_by": detected,
                         "through_evidence_reactor": through_reactor,
                         "harness_held_votes_ms": dev["held_ms"],
                         # None: the reference ends before that height
                         "cpu_plane_harness_held_votes_ms": ref.get("held_ms") if ref else None},
        "queue_drops": run.dropped,
        "launches": {k: n for k, n in dev["launches"].items() if n},
        "launches_per_height": {h: r["launches"] for h, r in by_height.items()},
        "launches_outside_spans": {k: n for k, n in outside.items() if n},
        "by_height": by_height,
        "cpu_plane": {
            "heights": GOSSIP_CPU_HEIGHTS,
            "run_s": ref["run_s"],
            "phase_s": ref_s,
            "by_height": {g.height: height_report(ref, g) for g in ref["run"].heights},
        } if ref else {"heights": 0},
        "equal_to_cpu_plane": ["block", "state", "app_hash"] if ref else [],
        "device_busy_ms_heights_2_3": busy,
        "device_records_kept": kept,
        "device_kernels_not_measured": sorted(k for k, n in launched.items() if n and k not in busy),
        "device_idle_share_heights_2_3": 1 - sum(busy.values()) / (dev["profile_wall_s"] * 1e3),
        "ok": True,
    }
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"launches": out["launches_per_height"]}


# catch-up: a chain of CATCHUP_HEIGHTS blocks of N_TXS kvstore txs at
# config 5's mixed set, its app taking a state-sync snapshot every
# CATCHUP_SNAPSHOT heights, served by three peers to a fresh node
CATCHUP_HEIGHTS = 8
CATCHUP_SNAPSHOT = 4
# block_sync: block CATCHUP_FORGED_AT as the first peer asked for it
# sends it, its LastCommit with one sr25519 signature flipped (the check
# of the block below it refuses it)
CATCHUP_FORGED_AT = 4
# block_sync: the heights whose apply the CPU plane's reference repeats
# (cut from 3, then 2, for the script's time)
CATCHUP_CPU_HEIGHTS = 1
# state_sync: the operator's trust root, the discovery sleep, a trusting
# period that keeps the seeded chain's times (workloads.BASE_TIME_NS)
# inside it, and the backfill height whose light block the peer first in
# node ID order sends with a flipped sr25519 signature
CATCHUP_TRUST_HEIGHT = 1
CATCHUP_DISCOVERY_S = 1.0
CATCHUP_TRUST_PERIOD_S = 10 * 365 * 24 * 3600.0
CATCHUP_BAD_LIGHT_AT = 2
# node_key indexes: the fresh node's, then the three serving peers'
CATCHUP_NODE_KEYS = (40, 41, 42, 43)
CATCHUP_TIMEOUT_S = 300.0
# the commit checks of the catch-up path: the module whose name each
# caller reads, the name, and the plan it runs
CATCHUP_CHECKS = (
    ("tendermint_tpu_torch.blocksync.reactor", "verify_commit_light", "light"),
    ("tendermint_tpu_torch.statesync.reactor", "verify_commit_light", "light"),
    ("tendermint_tpu_torch.light.verifier", "verify_commit_light", "light"),
    ("tendermint_tpu_torch.light.verifier", "verify_commit_light_trusting", "trusting"),
    ("tendermint_tpu_torch.state.execution", "verify_commit", "full"),
)
SIGNATURE_KERNELS = ("sha512_ram", "ed25519_verify_tile", "sr25519_verify")


def commit_rule(kind: str, vals, commit, gate: int, step: int) -> dict:
    """The launches of one commit check, from the plan
    types/validation.py _verify_commit_batch_vector runs: "full"
    (verify_commit) verifies every present signature; "light"
    (verify_commit_light) the COMMIT votes through the one whose running
    power first exceeds 2/3 of the set's; "trusting"
    (verify_commit_light_trusting at light.verifier's default 1/3) the
    COMMIT votes whose address the trusted set `vals` holds, through the
    one whose running power first exceeds 1/3 of that set's. Counted by
    key type, then window_rule. A check that fails on a signature
    launches the same windows: every group is drained first. "bulk"
    (commit_signers) is a merged window of light checks."""
    return window_rule(commit_signers(kind, vals, commit), gate, step)


def commit_signers(kind: str, vals, commit) -> dict:
    """The signatures of each key type commit_rule's plan verifies; for
    "bulk" (light.verifier's verify_commit_light_bulk, a merged window of
    light checks) `vals` is its rows (set, block ID, height, commit), each
    row a light plan, and `commit` is None."""
    from tendermint_tpu_torch.types.commit import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT

    if kind == "bulk":
        by_type: dict = {}
        for row_vals, _block_id, _height, row_commit in vals:
            for key_type, n in commit_signers("light", row_vals, row_commit).items():
                by_type[key_type] = by_type.get(key_type, 0) + n
        return by_type
    flags = commit.block_id_flags_array()
    powers = vals.powers_array()
    total = int(powers.sum())
    if kind == "full":
        picked = [vals.validators[i] for i in np.flatnonzero(flags != BLOCK_ID_FLAG_ABSENT).tolist()]
    else:
        at = np.flatnonzero(flags == BLOCK_ID_FLAG_COMMIT).tolist()
        if kind == "light":
            by = [vals.validators[i] for i in at]
            needed = total * 2 // 3
        else:
            by = [vals.get_by_address(commit.signatures[i].validator_address)[1] for i in at]
            needed = total // 3
        cum = np.cumsum([v.voting_power if v is not None else 0 for v in by])
        end = int(np.argmax(cum > needed)) + 1 if cum.size and cum[-1] > needed else len(by)
        picked = [v for v in by[:end] if v is not None]
    by_type: dict = {}
    for v in picked:
        by_type[v.pub_key.type()] = by_type.get(v.pub_key.type(), 0) + 1
    return by_type


@contextlib.contextmanager
def recorded_checks(calls: list, checks: tuple = CATCHUP_CHECKS):
    """For the block, each commit check of `checks` appends a record to
    `calls`: its plan, height, set and commit (the rule is computed after
    the run, off its clock), the launches it made, its host ms and its
    outcome. A "bulk" check records its rows as the set (commit_signers)
    and its last row's height."""
    import importlib

    originals = []

    def wrap(fn, kind):
        def wrapper(*args):
            if kind == "trusting":
                _chain_id, vals, commit, _trust = args
                height = commit.height
            elif kind == "bulk":
                _chain_id, vals = args
                commit, height = None, vals[-1][2]
            else:
                _chain_id, vals, _block_id, height, commit = args
            before = launches()
            t0 = time.perf_counter()
            result = "ok", ""
            try:
                return fn(*args)
            except Exception as e:  # recorded, then raised unchanged
                result = type(e).__name__, str(e)
                raise
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                calls.append({
                    "kind": kind, "height": height, "vals": vals, "commit": commit, "ms": ms,
                    "got": {k: n - before[k] for k, n in launches().items()}, "outcome": result,
                })

        return wrapper

    for mod_name, attr, kind in checks:
        mod = importlib.import_module(mod_name)
        originals.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, wrap(getattr(mod, attr), kind))
    try:
        yield calls
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


def check_catchup_launches(calls: list, counts: dict, where: str) -> list:
    """Each recorded commit check launched its rule's kernels (X1 and K2 a
    window of ed25519, X3 one of sr25519), the signature kernels launched
    nowhere else, and no kernel but X4 launched outside the checks.
    Returns the calls' reports, without their sets and commits."""
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.gpu_verifier import GpuSr25519BatchVerifier

    gate, step = gpu_verifier.installed(), GpuSr25519BatchVerifier.STREAM_CHUNK
    reports = []
    for c in calls:
        want = commit_rule(c["kind"], c["vals"], c["commit"], gate, step)
        if not exact(c["got"], want):
            raise AssertionError(
                f"{where}: the {c['kind']} check at height {c['height']} launched {c['got']}, not {want}"
            )
        reports.append({"kind": c["kind"], "height": c["height"], "ms": c["ms"],
                        "launches": {k: n for k, n in c["got"].items() if n},
                        "outcome": list(c["outcome"])})
    for name, n in counts.items():
        in_checks = sum(c["got"].get(name, 0) for c in calls)
        if name in SIGNATURE_KERNELS and n != in_checks:
            raise AssertionError(f"{where}: {name} launched {n - in_checks} times outside the checks")
        if name not in SIGNATURE_KERNELS and name != "sha256_tree" and n:
            raise AssertionError(f"{where}: {name} launched {n} times")
    return reports


def catchup_busy(prof, counts: dict, wall_s: float) -> dict:
    """Device busy ms by kernel over a profiled run (each kernel's mean
    time a record times its launches), the records kept, and the idle
    share of the run's wall time over the kernels measured."""
    events = prof.key_averages()
    busy, kept = {}, {}
    for name, n in counts.items():
        if not n:
            continue
        mine = [e for e in events if KERNEL_NAMES[name] in e.key]
        kept[name] = sum(e.count for e in mine)
        if kept[name]:
            busy[name] = sum(e.self_device_time_total for e in mine) / kept[name] * n / 1e3
    return {
        "device_busy_ms": busy,
        "device_records_kept": kept,
        "device_kernels_not_measured": sorted(k for k, n in counts.items() if n and k not in busy),
        "device_idle_share": 1 - sum(busy.values()) / (wall_s * 1e3),
    }


def catchup_chain(seed: int) -> dict:
    """The chain the catch-up phases and node_start serve: CATCHUP_HEIGHTS
    blocks of N_TXS kvstore txs (TX_LENGTHS bytes) at config 5's mixed
    genesis, made and applied on the CPU plane by workloads.serve_chain
    from the app's InitChain (as a node started from a home begins),
    whose node (MemKV stores, its app snapshotting every
    CATCHUP_SNAPSHOT heights) the peers serve. Every fresh node of these
    phases takes the InitChain too (run_catchup's init_chain)."""
    from tendermint_tpu_torch.workloads import kv_genesis, kv_txs, seeded_keys, serve_chain

    t0 = time.perf_counter()
    privs = seeded_keys(N_VALIDATORS, seed, N_VALIDATORS // 2)
    genesis = kv_genesis(CHAIN_ID, privs)
    txs = [kv_txs(seed, h, N_TXS, TX_LENGTHS) for h in range(1, CATCHUP_HEIGHTS + 1)]
    chain, node, states = serve_chain(genesis, privs, txs, seed, snapshot_interval=CATCHUP_SNAPSHOT,
                                      init_chain=True)
    return {"genesis": genesis, "privs": privs, "chain": chain, "node": node, "states": states,
            "build_s": time.perf_counter() - t0}


def sr25519_inside_two_thirds(vals, commit, seed: int, label: int) -> int:
    """A seeded index of an sr25519 COMMIT vote that verify_commit_light
    checks (inside the first 2/3 of the set's power)."""
    n = len(commit.signatures) * 3 // 5
    at = [i for i in range(n) if vals.validators[i].pub_key.type() == "sr25519"
          and commit.signatures[i].is_for_block()]
    return at[int(np.random.default_rng([seed, label]).integers(0, len(at)))]


def phase_block_sync(torch, seed: int, served: dict) -> dict:
    """Block sync with the device plane installed
    (install_device_plane(GPUConfig()), then settle_probes()): a fresh
    non-validator node at config 5's mixed genesis catches up from three
    peers serving `served` (catchup_chain) on one MemoryNetwork
    (workloads.run_catchup, mode "block"). It verifies block H with the
    LastCommit of block H+1 (verify_commit_light), saves and applies it,
    and once its pool is caught up switches its consensus reactor on,
    leaving the tip to consensus. Block CATCHUP_FORGED_AT, as the first
    peer asked for it sends it, carries a LastCommit with one sr25519
    signature inside the first 2/3 of power flipped
    (workloads.ServingStore with a shared claim). Checks: the forged
    commit is refused with the JAX package's message; the peers that
    served that pair are banned, as the JAX rule names them; the pair is
    fetched again from a peer not banned; the fresh node's stored blocks
    1..tip-1, its final state's bytes and its app hash equal the
    chain's; every commit check (verify_commit_light of block sync,
    verify_commit of apply_block) launched its rule's windows, and only
    X4 launched outside them; no fault or reroute; and the CPU plane's
    reference of heights 1..CATCHUP_CPU_HEIGHTS (the same checks, saves
    and applies on a fresh node) gives equal states, app hashes, ABCI
    responses and stored blocks. Reports blocks/s, ms a block (verify,
    apply), the run under the profiler for the device's idle share, and
    the phase's seconds."""
    import asyncio

    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane
    from tendermint_tpu_torch.types.validation import verify_commit_light
    from tendermint_tpu_torch.workloads import (
        ServingStore,
        block_exec_node,
        forged_block,
        forged_commit,
        run_catchup,
    )

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before block_sync")
    t_phase = time.perf_counter()
    genesis, chain, node, states = served["genesis"], served["chain"], served["node"], served["states"]
    vals = states[0].last_validators
    at = CATCHUP_FORGED_AT
    forged_idx = sr25519_inside_two_thirds(vals, chain[at - 1].block.last_commit, seed, 17)
    forged = forged_block(chain[at - 1].block, forged_commit(chain[at - 1].block.last_commit, forged_idx))
    claim: dict = {}
    views = [ServingStore(node.block_store, blocks={at: forged}, claim=claim, name=str(i)) for i in range(3)]
    calls: list = []
    pairs: list = []
    records: dict = {}
    verify_ms: list = []
    apply_ms: list = []

    def instrument(fresh, servers):
        reactor, executor = fresh.blocksync, fresh.exec_node.executor
        inner_pair, inner_apply = reactor._verify_apply, executor.apply_block

        async def verify_apply(first, second):
            pool = reactor.pool
            h = first.header.height
            peers = (pool.first_block_peer(), pool.second_block_peer())
            n = len(calls)
            before = launches()
            await inner_pair(first, second)
            pairs.append({"height": h, "peers": peers, "applied": reactor.state.last_block_height >= h,
                          "verify_ms": calls[n]["ms"],
                          "launches": {k: v - before[k] for k, v in launches().items()}})

        async def apply(state, block_id, block):
            t0 = time.perf_counter()
            out = await inner_apply(state, block_id, block)
            apply_ms.append((time.perf_counter() - t0) * 1e3)
            if block.header.height <= CATCHUP_CPU_HEIGHTS:
                records[block.header.height] = {
                    "state": out, "app_hash": fresh.exec_node.app.app_hash,
                }
            return out

        reactor._verify_apply = verify_apply
        executor.apply_block = apply

    start = gpu_verifier.stats()
    install_device_plane(GPUConfig())
    settle_probes()
    try:
        with recorded_checks(calls), profile(activities=[ProfilerActivity.CUDA]) as prof:
            reset_launches()
            run = run_catchup(genesis, node, views, CATCHUP_NODE_KEYS, seed, "block",
                              timeout_s=CATCHUP_TIMEOUT_S, instrument=instrument, init_chain=True)
            torch.cuda.synchronize()
            counts = launches()
        assert_no_fault(start, gpu_verifier.stats(), "block_sync")
        reports = check_catchup_launches(calls, counts, "block_sync")
    finally:
        uninstall_device_plane()
    busy = catchup_busy(prof, counts, run.seconds)
    fresh = run.fresh.exec_node
    tip = len(chain)
    # the forged pair: refused with the JAX message, its two peers banned,
    # then fetched again from a peer not banned
    refused = [p for p in pairs if not p["applied"]]
    forger = run.server_ids[int(claim[at])]
    if len(refused) != 1 or refused[0]["height"] != at - 1 or refused[0]["peers"][1] != forger:
        raise AssertionError(f"block_sync: the forged block was not refused once: {refused}")
    failed = [c for c in reports if c["outcome"][0] != "ok"]
    want_msg = ("InvalidCommitError", f"wrong signature (#{forged_idx}): "
                f"{forged.last_commit.signatures[forged_idx].signature.hex()}")
    if [tuple(c["outcome"]) for c in failed] != [want_msg]:
        raise AssertionError(f"block_sync: the forged commit's outcome {failed}, not {want_msg}")
    if set(run.banned) != set(refused[0]["peers"]):
        raise AssertionError(f"block_sync: banned {run.banned}, the JAX rule names {refused[0]['peers']}")
    again = next(p for p in pairs if p["height"] == at - 1 and p["applied"])
    if set(again["peers"]) & set(run.banned):
        raise AssertionError(f"block_sync: the pair was fetched again from a banned peer: {again}")
    # the fresh node's chain equals the served one
    if run.state.last_block_height != tip - 1 or run.applied != tip - 1:
        raise AssertionError(f"block_sync: applied {run.applied} heights, the state at "
                             f"{run.state.last_block_height}, not {tip - 1}")
    for h in range(1, tip):
        if fresh.block_store.load_block(h).to_proto() != chain[h - 1].block.to_proto():
            raise AssertionError(f"block_sync: stored block {h} differs from the chain's")
    if run.state.to_proto() != states[tip - 2].to_proto():
        raise AssertionError("block_sync: the final state differs from the chain's")
    if fresh.app.app_hash != chain[tip - 1].block.header.app_hash:
        raise AssertionError("block_sync: the app hash differs from the chain's")
    if run.fresh.consensus.cs.rs.height != tip or run.fresh.consensus.wait_sync:
        raise AssertionError("block_sync: consensus was not switched on at the tip")
    # the CPU plane's reference of the first heights: the same checks,
    # saves and applies on a fresh node
    t_ref = time.perf_counter()
    ref = block_exec_node(genesis, init_chain=True)
    state = ref.state
    for h in range(1, CATCHUP_CPU_HEIGHTS + 1):
        cb, nxt = chain[h - 1], chain[h]
        verify_commit_light(CHAIN_ID, state.validators, cb.block_id, h, nxt.block.last_commit)
        ref.block_store.save_block(cb.block, cb.parts, nxt.block.last_commit)
        state = asyncio.run(ref.executor.apply_block(state, cb.block_id, cb.block))
        got = records[h]
        if got["state"].to_proto() != state.to_proto() or got["app_hash"] != ref.app.app_hash:
            raise AssertionError(f"block_sync: height {h} differs from the CPU plane's")
        if fresh.state_store.load_abci_responses(h).to_proto() != ref.state_store.load_abci_responses(h).to_proto():
            raise AssertionError(f"block_sync: height {h}'s ABCI responses differ from the CPU plane's")
        if fresh.block_store.load_block(h).to_proto() != ref.block_store.load_block(h).to_proto():
            raise AssertionError(f"block_sync: stored block {h} differs from the CPU plane's")
    ref_s = time.perf_counter() - t_ref
    launched = {k: n for k, n in counts.items() if n}
    verify_ok = [p["verify_ms"] for p in pairs if p["applied"]]
    out = {
        "phase": "block_sync",
        "validators": {"ed25519": N_VALIDATORS - N_VALIDATORS // 2, "sr25519": N_VALIDATORS // 2},
        "chain_heights": tip,
        "txs_per_block": N_TXS,
        "build_s": served["build_s"],
        "run_s": run.seconds,
        "blocks_applied": run.applied,
        "blocks_per_s": run.applied / run.seconds,
        "ms_per_block": {"verify_commit_light": float(np.mean(verify_ok)), "apply_block": float(np.mean(apply_ms)),
                         "verify_samples": verify_ok, "apply_samples": apply_ms},
        "forged": {"height": at, "index": forged_idx, "served_by": forger, "outcome": list(want_msg),
                   "banned": run.banned, "fetched_again_from": list(again["peers"])},
        "checks": reports,
        "launches": launched,
        **busy,
        "cpu_plane": {"heights": CATCHUP_CPU_HEIGHTS, "s": ref_s},
        "equal_to_chain": ["blocks", "state", "app_hash"],
        "equal_to_cpu_plane": ["state", "app_hash", "abci_responses", "blocks"],
        "ok": True,
    }
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"launches": launched, "blocks_per_s": out["blocks_per_s"],
            "pair_launches": {p["height"]: p["launches"] for p in pairs if p["applied"]},
            "refused_pair_launches": [p["launches"] for p in pairs if not p["applied"]]}


def phase_state_sync(torch, seed: int, served: dict) -> dict:
    """State sync with the device plane installed
    (install_device_plane(GPUConfig()), then settle_probes()): three
    peers serve `served` (catchup_chain), whose app took a snapshot at
    CATCHUP_SNAPSHOT (a peer lists it once the two heights above it are
    stored: workloads.ServingClient), and a fresh node at the genesis,
    given the trust root CATCHUP_TRUST_HEIGHT and its header's hash,
    state-syncs, backfills and block-syncs (workloads.run_catchup, mode
    "state"; discovery CATCHUP_DISCOVERY_S): its embedded light client
    pins the root and verifies the light blocks at S, S+1 and S+2 from
    it (a trusting and a light check of S, skipping from the root, then
    a light check each), the chunks are fetched, spooled and applied,
    the state bootstrapped, the headers below S fetched and verified one
    at a time (the peer first in node ID order sends its light block at
    CATCHUP_BAD_LIGHT_AT with one sr25519 signature flipped: the node
    moves on to the next peer), then block sync runs to the tip. Checks:
    the restored app hash, the bootstrapped state's bytes (its
    validators' and params' last-changed heights are S+1, as the
    reference's state provider sets them), the stored signed headers and
    the validator sets of heights 1..S equal the serving node's; the
    light client's checks are the ones light/client.py makes (initialize
    none; verify_light_block_at_height skips from the root to S, then
    steps), the backfill's one a height and one more at the bad one,
    block sync's and apply_block's one a block; each launched its rule's
    windows and only X4 launched outside them; no fault or reroute; the
    final state (last-changed heights as above), app hash and blocks
    equal the chain's. Reports the restore's seconds, chunks and
    chunks/s beside the discovery sleep, ms a light-block verify,
    backfill headers/s, the device's idle share and the phase's
    seconds."""
    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.config import GPUConfig, StateSyncConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane
    from tendermint_tpu_torch.p2p.types import node_id_from_pubkey
    from tendermint_tpu_torch.workloads import ServingStore, forged_commit, node_key, run_catchup

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before state_sync")
    t_phase = time.perf_counter()
    genesis, chain, node, states = served["genesis"], served["chain"], served["node"], served["states"]
    S, tip = CATCHUP_SNAPSHOT, len(chain)
    bad_at = CATCHUP_BAD_LIGHT_AT
    bad_commit = node.block_store.load_block_commit(bad_at)
    bad_idx = sr25519_inside_two_thirds(states[bad_at - 1].validators, bad_commit, seed, 19)
    ids = [node_id_from_pubkey(node_key(seed, k).pub_key()) for k in CATCHUP_NODE_KEYS[1:]]
    bad_peer = min(ids)
    views = [ServingStore(node.block_store, commits={bad_at: forged_commit(bad_commit, bad_idx)})
             if i == bad_peer else node.block_store for i in ids]
    snapshot = next(s for s in node.app.list_snapshots(None).snapshots if s.height == S)
    cfg = StateSyncConfig(
        trust_height=CATCHUP_TRUST_HEIGHT,
        trust_hash=node.block_store.load_block_meta(CATCHUP_TRUST_HEIGHT).header.hash().hex(),
        trust_period=CATCHUP_TRUST_PERIOD_S,
        discovery_time=CATCHUP_DISCOVERY_S,
    )
    calls: list = []
    spans: dict = {"fetch_chunks": [], "apply_chunks": []}

    def instrument(fresh, servers):
        for attr in spans:
            clock_async(fresh.statesync, f"_{attr}", spans[attr])

    start = gpu_verifier.stats()
    install_device_plane(GPUConfig())
    settle_probes()
    try:
        with recorded_checks(calls), profile(activities=[ProfilerActivity.CUDA]) as prof:
            reset_launches()
            run = run_catchup(genesis, node, views, CATCHUP_NODE_KEYS, seed, "state", ss_cfg=cfg,
                              timeout_s=CATCHUP_TIMEOUT_S, instrument=instrument, init_chain=True)
            torch.cuda.synchronize()
            counts = launches()
        assert_no_fault(start, gpu_verifier.stats(), "state_sync")
        reports = check_catchup_launches(calls, counts, "state_sync")
    finally:
        uninstall_device_plane()
    busy = catchup_busy(prof, counts, run.seconds)
    fresh = run.fresh.exec_node
    # the checks in order, as the code makes them
    want = [("trusting", S), ("light", S), ("light", S + 1), ("light", S + 2)]
    want += [("light", h) for h in range(S - 1, 0, -1) for _ in range(2 if h == bad_at else 1)]
    for h in range(S + 1, tip):
        want += [("light", h), ("full", h - 1)]
    got = [(c["kind"], c["height"]) for c in reports]
    if got != want:
        raise AssertionError(f"state_sync: the commit checks {got}, not {want}")
    bad = [c for c in reports if c["outcome"][0] != "ok"]
    want_bad = ["InvalidCommitError", f"wrong signature (#{bad_idx}): "
                f"{forged_commit(bad_commit, bad_idx).signatures[bad_idx].signature.hex()}"]
    if len(bad) != 1 or bad[0]["height"] != bad_at or bad[0]["outcome"] != want_bad:
        raise AssertionError(f"state_sync: the bad light block's checks {bad}")
    # the restore: app hash, bootstrapped state, signed headers, sets
    if run.restored_height != S or run.backfilled != S - 1:
        raise AssertionError(f"state_sync: restored {run.restored_height}, backfilled {run.backfilled}")

    def as_bootstrapped(state):
        out = state.copy()
        out.last_height_validators_changed = S + 1
        out.last_height_consensus_params_changed = S + 1
        return out.to_proto()

    if run.bootstrapped != as_bootstrapped(states[S - 1]):
        raise AssertionError("state_sync: the bootstrapped state differs from the chain's")
    for h in range(1, S + 1):
        meta = fresh.block_store.load_block_meta(h)
        if meta is None or meta.header.to_proto() != chain[h - 1].block.header.to_proto():
            raise AssertionError(f"state_sync: the stored header {h} differs from the serving node's")
        # a signed header's commit is kept under the height below it
        if h > 1 and fresh.block_store.load_block_commit(h - 1).to_proto() != \
                node.block_store.load_block_commit(h).to_proto():
            raise AssertionError(f"state_sync: the stored commit of {h} differs from the serving node's")
        if fresh.state_store.load_validators(h).to_proto() != node.state_store.load_validators(h).to_proto():
            raise AssertionError(f"state_sync: the validator set of {h} differs from the serving node's")
    for h in range(S + 1, tip):
        if fresh.block_store.load_block(h).to_proto() != chain[h - 1].block.to_proto():
            raise AssertionError(f"state_sync: stored block {h} differs from the chain's")
    if run.state.to_proto() != as_bootstrapped(states[tip - 2]):
        raise AssertionError("state_sync: the final state differs from the chain's")
    if fresh.app.app_hash != chain[tip - 1].block.header.app_hash:
        raise AssertionError("state_sync: the app hash differs from the chain's")
    if run.fresh.consensus.cs.rs.height != tip or run.fresh.consensus.wait_sync:
        raise AssertionError("state_sync: consensus was not switched on at the tip")
    chunk_s = (sum(spans["fetch_chunks"]) + sum(spans["apply_chunks"])) / 1e3
    light = [c["ms"] for c in reports[:4]]
    backfill = [c for c in reports[4:4 + S]]
    out = {
        "phase": "state_sync",
        "validators": {"ed25519": N_VALIDATORS - N_VALIDATORS // 2, "sr25519": N_VALIDATORS // 2},
        "chain_heights": tip,
        "snapshot": {"height": S, "chunks": snapshot.chunks, "bytes": len(node.app._snapshots[(S, 1)]),
                     "app_entries": len(json.loads(node.app._snapshots[(S, 1)])["state"])},
        "run_s": run.seconds,
        "discovery_s": run.discovery_s,
        "restore_s": run.restore_s,
        "chunks_s": chunk_s,
        "chunks_per_s": snapshot.chunks / chunk_s,
        "fetch_chunks_ms": spans["fetch_chunks"],
        "apply_chunks_ms": spans["apply_chunks"],
        "light_verify_ms": {"mean": float(np.mean(light)), "samples": light},
        "backfill": {"headers": run.backfilled, "s": run.backfill_s,
                     "headers_per_s": run.backfilled / run.backfill_s,
                     "verify_ms": [c["ms"] for c in backfill],
                     "bad_light_block": {"height": bad_at, "index": bad_idx, "peer": bad_peer,
                                         "outcome": want_bad}},
        "block_sync": {"s": run.block_sync_s, "blocks_applied": run.applied},
        "checks": reports,
        "launches": {k: n for k, n in counts.items() if n},
        **busy,
        "equal_to_serving_node": ["app_hash", "bootstrapped_state", "signed_headers", "validator_sets",
                                  "blocks", "final_state"],
        "ok": True,
    }
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"launches": out["launches"]}


# the rpc phase. (a) config 4 over HTTP: CONFIG4_MIXED_HEADERS hops (the
# depth cut for the script's time) of LIGHT_VALIDATORS ed25519
# validators, applied by workloads.serve_chain; a lying witness serves a
# conflicting header at the tip. (b) config 5's routes on the catch-up
# chain: the light blocks of RPC_LIGHT_HEIGHTS, the indexed heights, the
# proofs of one block, and RPC_BROADCAST txs through broadcast_tx_sync
RPC_HEADERS = CONFIG4_MIXED_HEADERS
RPC_LIGHT_HEIGHTS = tuple(range(2, 8))
RPC_INDEX_HEIGHTS = (4, 5)
RPC_PROOF_HEIGHT = 5
RPC_PROOFS = 100
RPC_BROADCAST = 1_000
RPC_DUPLICATES = 50
RPC_MALFORMED = 10
RPC_CLIENTS = 8
RPC_TIMEOUT_S = 120.0
# the attack's checks: the client's merged window, the witness header's
# cross-check, and the evidence pool's check of the reported evidence
RPC_ATTACK_CHECKS = (
    ("tendermint_tpu_torch.light.verifier", "verify_commit_light_bulk", "bulk"),
    ("tendermint_tpu_torch.light.verifier", "verify_commit_light", "light"),
    ("tendermint_tpu_torch.evidence.verify", "verify_commit_light_trusting", "trusting"),
)


def rpc_chain(seed: int) -> dict:
    """Config 4's chain for the rpc phase: RPC_HEADERS + 1 applied blocks
    (no txs) of LIGHT_VALIDATORS ed25519 validators from the seed, built
    and applied on the CPU plane by workloads.serve_chain."""
    from tendermint_tpu_torch.workloads import kv_genesis, seeded_keys, serve_chain

    t0 = time.perf_counter()
    privs = seeded_keys(LIGHT_VALIDATORS, seed)
    _chain, node, _states = serve_chain(
        kv_genesis(CONFIG4_CHAIN_ID, privs), privs, [[] for _ in range(RPC_HEADERS + 1)], seed
    )
    return {"privs": privs, "node": node, "build_s": time.perf_counter() - t0}


def rpc_http_sync(torch, seed: int, chain: dict) -> dict:
    """(a): the HTTP light sync of config 4 beside the in-process one, and
    the lying witness. Runs with the device plane installed."""
    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.evidence.pool import EvidencePool
    from tendermint_tpu_torch.light import verifier
    from tendermint_tpu_torch.light.client import SEQUENTIAL_BATCH_HOPS
    from tendermint_tpu_torch.light.errors import DivergenceError
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.rpc.core import Environment
    from tendermint_tpu_torch.rpc.servingcache import ServingCache
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.types import validation
    from tendermint_tpu_torch.types.light import LightBlock, LightBlocksResponse
    from tendermint_tpu_torch.workloads import (
        ServingStore,
        conflicting_light_block,
        http_light_client,
        http_light_sync,
        light_client,
        light_sync,
        rpc_light_sync,
        rpc_serving,
        stored_light_blocks,
    )

    node = chain["node"]
    bs, ss = node.block_store, node.state_store
    tip = bs.height()
    hops = tip - 1
    blocks = stored_light_blocks(bs, ss, range(1, tip + 1))
    gate = gpu_verifier.installed()
    per_commit = 2 * LIGHT_VALIDATORS // 3 + 1
    w = light_windows(hops, per_commit, SEQUENTIAL_BATCH_HOPS, gate)
    expect = {"ed25519": (w, {"sha512_ram": w, "ed25519_verify_tile": w})}
    runs = {}

    def http():
        runs["http"] = rpc_light_sync(bs, ss, CONFIG4_CHAIN_ID, SEQUENTIAL_BATCH_HOPS,
                                      pruning_size=tip)

    def in_process():
        runs["in_process"] = light_client(blocks, CONFIG4_CHAIN_ID, tip)
        light_sync(runs["in_process"], SEQUENTIAL_BATCH_HOPS)

    out = {"launches_http_sync": count_one_call(http, expect),
           "launches_in_process_sync": count_one_call(in_process, expect)}
    got = {k: v for k, v in out["launches_http_sync"].items() if k != "by_key_type"}
    want = {k: v for k, v in out["launches_in_process_sync"].items() if k != "by_key_type"}
    if got != want:
        raise AssertionError(f"rpc: the HTTP sync launched {got}, the in-process one {want}")
    for name, run in (("http", runs["http"].client), ("in_process", runs["in_process"])):
        for h in range(1, tip + 1):
            lb = run.store.light_block(h)
            if lb is None or lb.to_proto() != blocks[h].to_proto():
                raise AssertionError(f"rpc: the {name} sync stored another header {h} than the chain's")
    # headers/s in turns, then in reverse order; ms a page over every
    # HTTP sync's bulk fetches
    readings = {"http": [], "in_process": []}
    fetch_s, pages = list(runs["http"].fetch_s), runs["http"].pages
    for name in ("http", "in_process", "in_process", "http"):
        if name == "http":
            run = rpc_light_sync(bs, ss, CONFIG4_CHAIN_ID, SEQUENTIAL_BATCH_HOPS)
            seconds = run.seconds
            fetch_s += run.fetch_s
            pages += run.pages
        else:
            seconds = light_sync(light_client(blocks, CONFIG4_CHAIN_ID), SEQUENTIAL_BATCH_HOPS)
        readings[name].append(hops / seconds)
    out["headers_per_s"] = {k: float(np.mean(v)) for k, v in readings.items()}
    out["headers_per_s_readings"] = readings
    out["ms_per_page"] = sum(fetch_s) * 1e3 / pages
    out["pages"] = pages
    # the card's busy share over one more HTTP sync, and where its host
    # time goes: the server's assembly and encode of each light block
    # (store loads, to_proto), the client's page decode, then the
    # client's stages as config4 times them
    stages = {
        "server_encode": (ServingCache, "encoded_light_block"),
        "client_decode": (LightBlocksResponse, "from_proto"),
        "validate_basic": (LightBlock, "validate_basic"),
        "header_checks": (verifier, "adjacent_header_checks"),
        "collect": (validation, "collect_commit_light"),
        "verify": (validation, "verify_triples_grouped"),
        "store": (LightStore, "save_light_block"),
    }
    spent = {name: [] for name in stages}
    with contextlib.ExitStack() as stack, profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name, (owner, attr) in stages.items():
            stack.enter_context(timed(owner, attr, spent[name]))
        reset_launches()
        run = rpc_light_sync(bs, ss, CONFIG4_CHAIN_ID, SEQUENTIAL_BATCH_HOPS)
        torch.cuda.synchronize()
        counts = launches()
    out["http_sync_profiled"] = {"s": run.seconds, **catchup_busy(prof, counts, run.seconds)}
    ms = {name: sum(v) / hops for name, v in spent.items()}
    out["http_ms_per_header"] = {"total": run.seconds * 1e3 / hops, **ms,
                                 "rest": run.seconds * 1e3 / hops - sum(ms.values())}

    # the lying witness: the tip with another app hash, signed by all
    meta, commit = conflicting_light_block(bs, ss, tip, chain["privs"], seed)
    primary = Environment(chain_id=CONFIG4_CHAIN_ID, block_store=bs, state_store=ss,
                          evidence_pool=EvidencePool(MemKV(), ss, bs))
    liar = Environment(chain_id=CONFIG4_CHAIN_ID, state_store=ss,
                       block_store=ServingStore(bs, metas={tip: meta}, commits={tip: commit}))
    calls, reports = [], []
    now = meta.header.time_ns + 1_000_000_000
    call = HTTPClient.call

    async def recorded_call(self, method, **params):
        try:
            res = await call(self, method, **params)
        except Exception as e:  # recorded, then raised unchanged
            if method == "broadcast_evidence":
                reports.append((self.port, type(e).__name__, str(e)))
            raise
        if method == "broadcast_evidence":
            reports.append((self.port, "ok", res))
        return res

    async def attack():
        async with rpc_serving([primary, liar]) as addrs:
            client = http_light_client(addrs[0], addrs[1:], CONFIG4_CHAIN_ID, blocks[tip - 1])
            try:
                await http_light_sync(client, tip, now, SEQUENTIAL_BATCH_HOPS)
            except DivergenceError as e:
                return e, addrs
        raise AssertionError("rpc: the lying witness's header raised no DivergenceError")

    before = gpu_verifier.stats()
    HTTPClient.call = recorded_call
    try:
        with recorded_checks(calls, RPC_ATTACK_CHECKS):
            reset_launches()
            err, addrs = asyncio_run(attack())
            counts = launches()
    finally:
        HTTPClient.call = call
    assert_no_fault(before, gpu_verifier.stats(), "rpc attack")
    checks = check_catchup_launches(calls, counts, "rpc attack")
    got = [(c["kind"], c["height"]) for c in checks]
    if got != [("bulk", tip), ("light", tip), ("trusting", tip)]:
        raise AssertionError(f"rpc attack: the commit checks {got}")
    (ev,) = err.evidence
    pending = [e.hash() for e in primary.evidence_pool.pending_evidence(10**6)[0]]
    primary_port = int(addrs[0].rsplit(":", 1)[1])
    answer = [r for r in reports if r[0] == primary_port]
    if answer != [(primary_port, "ok", {"hash": ev.hash().hex()})] or pending != [ev.hash()]:
        raise AssertionError(f"rpc attack: the primary answered {answer}, holds {pending}")
    if ev.total_voting_power != ss.load_validators(tip - 1).total_voting_power():
        raise AssertionError("rpc attack: the evidence's total power is not the common set's")
    out["attack"] = {
        "height": tip,
        "common_height": ev.common_height,
        "error": str(err),
        "evidence_hash": ev.hash().hex(),
        "primary_answer": answer[0][2],
        "witness_answer": [list(r[1:]) for r in reports if r[0] != primary_port],
        "checks": checks,
        "launches": {k: n for k, n in counts.items() if n},
    }
    return out


def asyncio_run(coro):
    """asyncio.run under RPC_TIMEOUT_S, so that a hang fails the phase."""
    import asyncio

    return asyncio.run(asyncio.wait_for(coro, RPC_TIMEOUT_S))


def rpc_config5_routes(torch, seed: int, served: dict) -> dict:
    """(b): config 5's routes on the catch-up chain over HTTP. Runs with
    the device plane installed."""
    import asyncio
    import base64

    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.merkle import Proof, verify_multiproofs_batch
    from tendermint_tpu_torch.encoding.proto import ProtoWriter
    from tendermint_tpu_torch.eventbus import EventBus
    from tendermint_tpu_torch.light.verifier import MAX_CLOCK_DRIFT_NS, verify_adjacent
    from tendermint_tpu_torch.mempool.types import MempoolError
    from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
    from tendermint_tpu_torch.rpc.core import Environment
    from tendermint_tpu_torch.state.indexer import IndexerService, KVSink
    from tendermint_tpu_torch.state.sink_sql import SQLSink
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.types.light import LightBlock
    from tendermint_tpu_torch.types.tx import tx_hash
    from tendermint_tpu_torch.workloads import kv_mempool, kv_txs, publish_stored_height, rpc_serving

    node, chain = served["node"], served["chain"]
    bs, ss = node.block_store, node.state_store
    rng = np.random.default_rng([seed, 18])
    kv, sql = KVSink(MemKV()), SQLSink("sqlite::memory:", CHAIN_ID)
    bus = EventBus()
    pool, twin = kv_mempool(KVStoreApplication()), kv_mempool(KVStoreApplication())
    env = Environment(chain_id=CHAIN_ID, block_store=bs, state_store=ss, mempool=pool,
                      event_bus=bus, event_sinks=[kv, sql])
    env_sql = Environment(chain_id=CHAIN_ID, block_store=bs, state_store=ss, event_sinks=[sql])
    # the txs sent: unique kvstore txs and malformed validator txs in a
    # seeded order, then duplicates of some of the unique ones
    n_unique = RPC_BROADCAST - RPC_DUPLICATES - RPC_MALFORMED
    unique = kv_txs(seed, 1_000_018, n_unique, TX_LENGTHS)
    malformed = [malformed_val_tx(i, rng)[0] for i in range(RPC_MALFORMED)]
    wave1 = [(unique + malformed)[i] for i in rng.permutation(n_unique + RPC_MALFORMED).tolist()]
    wave2 = [unique[i] for i in rng.choice(n_unique, RPC_DUPLICATES, replace=False).tolist()]
    calls: list = []
    out: dict = {}

    async def run():
        await bus.start()
        indexer = IndexerService([kv, sql], bus)
        await indexer.start()
        t0 = time.perf_counter()
        published = 0
        for h in RPC_INDEX_HEIGHTS:
            last = bs.load_block(h).txs[-1]
            published += publish_stored_height(bus, bs, ss, h)
            while not (kv.get_tx_by_hash(tx_hash(last)) and sql.get_tx_by_hash(tx_hash(last))):
                await asyncio.sleep(0.005)
        out["indexed"] = {"txs": published, "s": time.perf_counter() - t0,
                          "txs_per_s": published / (time.perf_counter() - t0)}
        await indexer.stop()
        async with rpc_serving([env, env_sql]) as addrs:
            c, c_sql = HTTPClient(addrs[0], RPC_TIMEOUT_S), HTTPClient(addrs[1], RPC_TIMEOUT_S)
            # light blocks, each adjacent pair checked on the card
            t0 = time.perf_counter()
            raw = {h: (await c.call("light_block", height=h))["light_block"] for h in RPC_LIGHT_HEIGHTS}
            out["light_block_fetch_ms"] = (time.perf_counter() - t0) * 1e3 / len(raw)
            lbs = {h: LightBlock.from_proto(bytes.fromhex(b)) for h, b in raw.items()}
            now = lbs[RPC_LIGHT_HEIGHTS[-1]].signed_header.header.time_ns + 1_000_000_000
            with recorded_checks(calls, (CATCHUP_CHECKS[2],)):
                reset_launches()
                ms = []
                for h in RPC_LIGHT_HEIGHTS:
                    t1 = time.perf_counter()
                    lbs[h].validate_basic(CHAIN_ID)
                    if h > RPC_LIGHT_HEIGHTS[0]:
                        verify_adjacent(CHAIN_ID, lbs[h - 1].signed_header, lbs[h].signed_header,
                                        lbs[h].validator_set, 10**18, now, MAX_CLOCK_DRIFT_NS)
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t1) * 1e3)
                counts = launches()
            out["light_check_ms"] = {"mean": float(np.mean(ms)), "samples": ms}
            out["light_checks"] = check_catchup_launches(calls, counts, "rpc config5")
            roots = counts.get("sha256_tree", 0)
            if roots != len(RPC_LIGHT_HEIGHTS):
                raise AssertionError(f"rpc config5: X4 launched {roots} times, "
                                     f"not one a validator set ({len(RPC_LIGHT_HEIGHTS)})")
            out["light_launches"] = {k: n for k, n in counts.items() if n}
            # the bulk page, byte-equal to the single blobs
            lo, hi = RPC_LIGHT_HEIGHTS[0], RPC_LIGHT_HEIGHTS[-1]
            page = await c.call("light_blocks", min_height=lo, max_height=hi)
            w = ProtoWriter()
            for h in RPC_LIGHT_HEIGHTS:
                w.message(1, bytes.fromhex(raw[h]))
            w.int(2, bs.height())
            if page["light_blocks"] != w.finish().hex() or page["count"] != len(RPC_LIGHT_HEIGHTS):
                raise AssertionError("rpc config5: the light_blocks page differs from the single blobs")
            # proofs of RPC_PROOFS txs of one block, against the checked
            # header's data_hash, on the host
            block = chain[RPC_PROOF_HEIGHT - 1].block
            idx = sorted(rng.choice(len(block.txs), RPC_PROOFS, replace=False).tolist())
            t0 = time.perf_counter()
            res = await c.call("tx_proofs", height=RPC_PROOF_HEIGHT, indices=idx)
            out["tx_proofs_ms"] = (time.perf_counter() - t0) * 1e3
            proofs = [Proof.from_proto_bytes(bytes.fromhex(p)) for p in res["proofs"]]
            data_hash = lbs[RPC_PROOF_HEIGHT].signed_header.header.data_hash
            ok = verify_multiproofs_batch(proofs, data_hash, [tx_hash(block.txs[i]) for i in idx])
            if not ok.all() or [p.index for p in proofs] != idx or res["root"] != data_hash.hex():
                raise AssertionError("rpc config5: a tx proof did not verify against data_hash")
            # searches on both sinks
            t0 = time.perf_counter()
            found = await c.call("tx_search", query=f"tx.height={RPC_PROOF_HEIGHT}")
            out["tx_search_kv_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            found_sql = await c_sql.call("tx_search", query=f"tx.height={RPC_PROOF_HEIGHT}")
            out["tx_search_sql_ms"] = (time.perf_counter() - t0) * 1e3
            if found["total_count"] != N_TXS or found_sql != found:
                raise AssertionError(f"rpc config5: tx_search found {found['total_count']} and "
                                     f"{found_sql['total_count']}, pages equal {found_sql == found}")
            one = block.txs[idx[0]]
            tx = await c.call("tx", hash=tx_hash(one).hex())
            results = await c.call("block_results", height=RPC_PROOF_HEIGHT)
            if (tx["height"], tx["index"], base64.b64decode(tx["tx"])) != (RPC_PROOF_HEIGHT, idx[0], one) \
                    or results["txs_results"][idx[0]] != tx["tx_result"]:
                raise AssertionError("rpc config5: tx and block_results disagree")
            vals = await c.call("validators", height=RPC_PROOF_HEIGHT, page=1, per_page=100)
            if (vals["count"], vals["total"]) != (100, N_VALIDATORS):
                raise AssertionError(f"rpc config5: validators page {vals['count']} of {vals['total']}")
            # broadcast_tx_sync from RPC_CLIENTS connections, each wave
            # against the twin pool's own check_tx in order
            clients = [HTTPClient(addrs[0], RPC_TIMEOUT_S) for _ in range(RPC_CLIENTS)]

            async def send(k, tx):
                try:
                    return "ok", await clients[k % RPC_CLIENTS].call(
                        "broadcast_tx_sync", tx=base64.b64encode(tx).decode())
                except RPCClientError as e:
                    return "err", e.code, str(e)

            got, t0 = [], time.perf_counter()
            for wave in (wave1, wave2):
                got += await asyncio.gather(*(send(k, tx) for k, tx in enumerate(wave)))
            out["broadcast_s"] = time.perf_counter() - t0
            for cl in (c, c_sql, *clients):
                await cl.close()
        want = []
        for tx in wave1 + wave2:
            try:
                r = await twin.check_tx(tx)
                want.append(("ok", {"code": r.code, "data": base64.b64encode(r.data).decode(),
                                    "log": r.log, "codespace": r.codespace, "hash": tx_hash(tx).hex()}))
            except MempoolError as e:
                want.append(("err", -32603, f"tx rejected: {e} ()"))
        if got != want:
            bad = next(i for i, (g, x) in enumerate(zip(got, want)) if g != x)
            raise AssertionError(f"rpc config5: broadcast {bad}: {got[bad]}, the twin pool's {want[bad]}")
        out["broadcast"] = {
            "txs": len(got), "txs_per_s": len(got) / out["broadcast_s"], "clients": RPC_CLIENTS,
            "accepted": sum(g[0] == "ok" and g[1]["code"] == 0 for g in got),
            "refused_by_app": sum(g[0] == "ok" and g[1]["code"] != 0 for g in got),
            "duplicates": sum(g[0] == "err" for g in got),
        }
        await bus.stop()

    before = gpu_verifier.stats()
    asyncio_run(run())
    assert_no_fault(before, gpu_verifier.stats(), "rpc config5")
    sql.close()
    if out["broadcast"]["duplicates"] != RPC_DUPLICATES or out["broadcast"]["refused_by_app"] != RPC_MALFORMED:
        raise AssertionError(f"rpc config5: broadcast outcomes {out['broadcast']}")
    return out


def phase_rpc(torch, seed: int, served: dict) -> dict:
    """RPC with the device plane installed (install_device_plane(
    GPUConfig()), then settle_probes()); every server on 127.0.0.1:0.
    (a) Config 4 over HTTP (rpc_chain): a fresh sequential light client
    of an RPC server over the chain's node (primary) and an honest
    witness syncs from height 1 to the tip through light_blocks pages of
    20; its X1 and K2 launches equal those of the same client code
    syncing in process (workloads.ChainProvider), every stored light
    block equals the chain's; headers/s of both in turns, ms a page and
    the card's idle share over an HTTP sync. A client trusting the
    height below the tip, with a lying witness (the tip's header with
    another app hash, signed by all), raises DivergenceError and reports
    the evidence over HTTP; the primary answers its hash and holds it as
    pending; the client's window, the cross-check and the pool's
    trusting check each launch their rule's windows. (b) Config 5's
    routes on the catch-up chain `served`, with a TxMempool and an
    IndexerService on a KV and an SQL sink fed heights
    RPC_INDEX_HEIGHTS' stored results through the event bus (txs/s
    indexed): light_block at RPC_LIGHT_HEIGHTS, each adjacent pair
    checked on the card (X1, K2, X3 by the light plan, X4 once a set);
    the light_blocks page byte-equal to those blobs; RPC_PROOFS tx proofs
    of one block verified against the checked header's data_hash on the
    host; tx_search totals of N_TXS and equal pages on both sinks; tx,
    block_results and validators; RPC_BROADCAST txs through
    broadcast_tx_sync, each outcome the twin pool's (txs/s). No fault or
    reroute."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before rpc")
    t_phase = time.perf_counter()
    chain = rpc_chain(seed)
    start = gpu_verifier.stats()
    install_device_plane(GPUConfig())
    settle_probes()
    try:
        t0 = time.perf_counter()
        config4 = rpc_http_sync(torch, seed, chain)
        config4["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        config5 = rpc_config5_routes(torch, seed, served)
        config5["s"] = time.perf_counter() - t0
        assert_no_fault(start, gpu_verifier.stats(), "rpc")
    finally:
        uninstall_device_plane()
    out = {
        "phase": "rpc",
        "config4": {"validators": LIGHT_VALIDATORS, "headers": RPC_HEADERS,
                    "chain_build_s": chain["build_s"], **config4},
        "config5": {"validators": {"ed25519": N_VALIDATORS - N_VALIDATORS // 2,
                                   "sr25519": N_VALIDATORS // 2},
                    "light_heights": list(RPC_LIGHT_HEIGHTS), **config5},
        "ok": True,
    }
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    strip = lambda d: {k: n for k, n in d.items() if k != "by_key_type"}  # noqa: E731
    return {"launches": {"http_sync": strip(config4["launches_http_sync"]),
                         "in_process_sync": strip(config4["launches_in_process_sync"]),
                         "attack": config4["attack"]["launches"],
                         "config5_light_checks": config5["light_launches"]}}


# node_start: a node of config 5's mixed set started by make_node from a
# home the CLI's `init` wrote, on a MemoryNetwork with three peers serving
# the catch-up chain (their node_key indexes); then a `testnet` of
# NODE_START_CLI_NODES validators (BASELINE config 1) run as `start`
# processes over TCP until each reaches NODE_START_CLI_HEIGHT
NODE_START_SERVER_KEYS = (44, 45, 46)
NODE_START_CLI_NODES = 4
NODE_START_CLI_HEIGHT = 3
NODE_START_CLI_TIMEOUT_S = 120.0
# where the node and the processes install their device plane
NODE_START_DEVICE = "cuda"
NODE_START_KERNELS = ("sha512_ram", "ed25519_verify_tile", "sr25519_verify", "sha256_tree")


@contextlib.contextmanager
def pair_launches(into: dict):
    """For the block, every BlocksyncReactor._verify_apply that applies
    its first block records the launches it made under that height."""
    from tendermint_tpu_torch.blocksync.reactor import BlocksyncReactor

    inner = BlocksyncReactor._verify_apply

    async def wrapper(self, first, second):
        before = launches()
        await inner(self, first, second)
        if self.state.last_block_height >= first.header.height:
            into[first.header.height] = {k: n - before[k] for k, n in launches().items()}

    BlocksyncReactor._verify_apply = wrapper
    try:
        yield into
    finally:
        BlocksyncReactor._verify_apply = inner


@contextlib.contextmanager
def handshake_launches(into: list):
    """For the block, every Handshaker.handshake appends the launches it
    made."""
    from tendermint_tpu_torch.consensus.replay import Handshaker

    inner = Handshaker.handshake

    async def wrapper(self, app_client):
        before = launches()
        try:
            return await inner(self, app_client)
        finally:
            into.append({k: n - before[k] for k, n in launches().items()})

    Handshaker.handshake = wrapper
    try:
        yield into
    finally:
        Handshaker.handshake = inner


def _four(counts: dict) -> dict:
    return {k: counts.get(k, 0) for k in NODE_START_KERNELS}


def phase_node_start(torch, seed: int, served: dict, block_sync: dict) -> dict:
    """Node start, as an operator runs it. First, on an earlier line,
    whether `import grpc` works on this host (item 21b's gRPC modules).
    (1) A home written by the CLI's `init` (workloads.init_home: the
    catch-up chain's genesis through GenesisDoc.save_as, block sync on,
    state sync off, its three peers, [gpu] as init writes it) started by
    make_node(load_config(home), transport=<the peers' MemoryNetwork>)
    (workloads.run_node_start): the node installs the device plane from
    its [gpu] (settle_probes() right after), runs the ABCI handshake
    (InitChain), block-syncs blocks 1..tip-1 and switches to consensus.
    Checks: every commit check launched its rule's windows and only X4
    launched outside them (check_catchup_launches); each applied block's
    X1, K2, X3 and X4 launches equal block_sync's for the same block, and
    the node's totals equal block_sync's less its refused pair; the
    stored blocks, the state and the app hash equal the chain's; the home
    has [instrumentation] prometheus = true on 127.0.0.1:0, and the
    node's /metrics and /healthz, scraped over HTTP before the stop
    (workloads.check_node_scrape), parse with no duplicate series, the
    gpu_* batches, signatures and padded lanes moved as
    gpu_verifier.stats() did over the part and its faults not at all,
    state_block_processing counted each block applied, /healthz reads
    the block store's height and p2p_peers the three peers; after
    stop() the data lock is free and every DB closed. (2) The chain's
    last block and its seen commit saved into the home's block store (the
    "crash before apply" of tests/test_consensus_replay.py) and the node
    started again from the home with a fresh kvstore app (stopped once
    its start returns: nothing is left to sync): the same [gpu]
    reuses the install; the handshake replays blocks 1..tip-1 into the
    app (no check) and applies the last through apply_block, whose
    LastCommit is verified on the card: its launches are block_exec's
    rule for that block (block_exec_rule) plus one X4 root for the
    InitChain and one for each replayed block's app hash; the state and
    the app hash equal the chain's at the tip. (3) `testnet` homes of
    NODE_START_CLI_NODES validators on 127.0.0.1 ports taken free,
    [gpu] enable = true, run as `python3 -m tendermint_tpu_torch.cmd
    start` processes over TCP (workloads.cli_localnet) until the HTTP
    client's `status` reads NODE_START_CLI_HEIGHT on each; each installs
    its plane in its own process, and exits 0 on SIGTERM; each serves
    Prometheus on a port taken free and is scraped once at that height
    (workloads.check_cli_scrape: consensus_height reached it, the gpu_*
    family there with no batch). Under the gate
    of 32 their commits verify on the CPU plane, so they launch nothing
    by rule. Reports each part's seconds, the scrapes' ms and bytes, blocks/s through the node
    beside block_sync's, the handshake's replay seconds, the card's idle
    share of parts 1 and 2, and each process's install line and height."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle
    from tendermint_tpu_torch.crypto.gpu_verifier import GpuSr25519BatchVerifier
    from tendermint_tpu_torch.node import device as device_plane
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.state.types import State
    from tendermint_tpu_torch.store.block_store import BlockStore
    from tendermint_tpu_torch.store.kv import SqliteKV
    from tendermint_tpu_torch.workloads import (
        NODE_MEM_ADDR,
        catchup_peers,
        check_cli_scrape,
        check_node_scrape,
        cli_localnet,
        gpu_series,
        init_home,
        run_node_start,
        stage_crash,
    )

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before node_start")
    t_phase = time.perf_counter()
    try:
        import grpc

        probe = {"import_grpc": True, "grpc_version": grpc.__version__}
    except ImportError as e:
        probe = {"import_grpc": False, "error": str(e)}
    emit({"phase": "node_start_probe", **probe})
    genesis, chain, node, states = served["genesis"], served["chain"], served["node"], served["states"]
    tip = len(chain)
    keys = NODE_START_SERVER_KEYS
    settings = {
        "blocksync": {"enable": True},
        "statesync": {"enable": False},
        "p2p": {"laddr": "tcp://" + NODE_MEM_ADDR, "persistent_peers": catchup_peers(keys, seed)},
        "rpc": {"laddr": "tcp://127.0.0.1:0"},
        "instrumentation": {"prometheus": True, "prometheus_listen_addr": "127.0.0.1:0"},
    }
    # the home outlives the phase: operator_tools inspects and replays it,
    # then removes tmp
    with kept_on_success("node_start_") as tmp:
        home = os.path.join(tmp, "home")
        t0 = time.perf_counter()
        init_home(home, genesis, settings)
        init_s = time.perf_counter() - t0
        calls, pairs, shakes, assembled = [], {}, [], {}

        def instrument(n):
            # the node installed its plane in make_node: let the probes
            # report, and count from its start
            settle_probes()
            assembled.update({k: v for k, v in launches().items() if v})
            reset_launches()

        start, series0 = gpu_verifier.stats(), gpu_series()
        try:
            # (1) block sync from the home
            t1 = time.perf_counter()
            with recorded_checks(calls), pair_launches(pairs), handshake_launches(shakes), \
                    profile(activities=[ProfilerActivity.CUDA]) as prof1:
                reset_launches()
                run1 = run_node_start(home, node, keys, seed, device=NODE_START_DEVICE,
                                      timeout_s=CATCHUP_TIMEOUT_S, instrument=instrument)
                torch.cuda.synchronize()
                counts1 = launches()
            part1_s = time.perf_counter() - t1
            plane = device_plane.installed_plane()
            if plane != (GPUConfig(), NODE_START_DEVICE):
                raise AssertionError(f"node_start: the node installed {plane}, not its [gpu]")
            reports1 = check_catchup_launches(calls, counts1, "node_start")
            # its scrape before the stop, over HTTP
            scrape1 = check_node_scrape(run1, start, series0, peers=len(keys))
            verifier = gpu_verifier._VERIFIERS["ed25519"]
            # (2) the staged crash, and the restart's handshake
            stage_crash(home, chain[tip - 1])
            calls2, shakes2 = [], []
            app2 = KVStoreApplication()
            t2 = time.perf_counter()
            with recorded_checks(calls2), handshake_launches(shakes2), \
                    profile(activities=[ProfilerActivity.CUDA]) as prof2:
                reset_launches()
                run2 = run_node_start(home, node, keys, seed, device=NODE_START_DEVICE, app=app2,
                                      timeout_s=CATCHUP_TIMEOUT_S, wait_synced=False)
                torch.cuda.synchronize()
                counts2 = launches()
            part2_s = time.perf_counter() - t2
            if gpu_verifier._VERIFIERS["ed25519"] is not verifier:
                raise AssertionError("node_start: the restart installed the plane again")
            assert_no_fault(start, gpu_verifier.stats(), "node_start")
            reports2 = check_catchup_launches(calls2, shakes2[0], "node_start handshake")
            gate, step, min_batch = MK.installed(), GpuSr25519BatchVerifier.STREAM_CHUNK, gpu_verifier.installed()
        finally:
            device_plane.uninstall_device_plane()
        # (1)'s checks: the launches block by block against block_sync's
        for h in range(1, tip):
            if h not in pairs or _four(pairs[h]) != _four(block_sync["pair_launches"][h]):
                raise AssertionError(f"node_start: block {h} launched {pairs.get(h)}, block_sync "
                                     f"{block_sync['pair_launches'].get(h)}")
        want1 = _four(block_sync["launches"])
        for refused in block_sync["refused_pair_launches"]:
            want1 = {k: n - refused.get(k, 0) for k, n in want1.items()}
        if _four(counts1) != want1:
            raise AssertionError(f"node_start: launched {_four(counts1)}, block_sync less its refused "
                                 f"pair {want1}")
        if run1.applied != tip - 1 or run1.state.to_proto() != states[tip - 2].to_proto():
            raise AssertionError(f"node_start: applied {run1.applied}, the state differs from the chain's")
        if run1.app_hash != chain[tip - 1].block.header.app_hash:
            raise AssertionError("node_start: the app hash differs from the chain's")
        if run1.node.consensus.rs.height != tip or run1.node.consensus_reactor.wait_sync:
            raise AssertionError("node_start: consensus was not switched on at the tip")
        for run in (run1, run2):
            if not run.lock_released or run.dbs_closed != run.dbs:
                raise AssertionError(f"node_start: after stop the lock is held ({not run.lock_released}) "
                                     f"or {run.dbs - run.dbs_closed} of {run.dbs} DBs are open")
        db = SqliteKV(os.path.join(home, "data", "blockstore.sqlite"))
        try:
            stored = BlockStore(db)
            for h in range(1, tip + 1):
                if stored.load_block(h).to_proto() != chain[h - 1].block.to_proto():
                    raise AssertionError(f"node_start: stored block {h} differs from the chain's")
        finally:
            db.close()
        # (2)'s checks: one full check, block exec's rule, the tip's state
        # block tip's LastCommit, the commit of height tip - 1
        if [(c["kind"], c["height"]) for c in calls2] != [("full", tip - 1)]:
            raise AssertionError(f"node_start: the handshake's checks {[(c['kind'], c['height']) for c in calls2]}")
        expect, outside = block_exec_rule(State.from_proto(states[tip - 2].to_proto()), chain[tip - 1].block,
                                          len(app2.state), gate, step, min_batch)
        want2 = {
            "sha512_ram": expect["ed25519"][1].get("sha512_ram", 0),
            "ed25519_verify_tile": expect["ed25519"][1].get("ed25519_verify_tile", 0),
            "sr25519_verify": expect["sr25519"][1].get("sr25519_verify", 0),
            "sha256_tree": outside["sha256_tree"] + 1 + (tip - 1),
        }
        if _four(shakes2[0]) != want2:
            raise AssertionError(f"node_start: the handshake launched {_four(shakes2[0])}, not {want2}")
        if (run2.replayed, run2.applied) != (tip, 0):
            raise AssertionError(f"node_start: the handshake replayed {run2.replayed}, block sync applied "
                                 f"{run2.applied}")
        if run2.state.to_proto() != states[tip - 1].to_proto() or run2.app_hash != states[tip - 1].app_hash:
            raise AssertionError("node_start: the restart's state or app hash differs from the chain's")
        # (3) the CLI's processes
        t3 = time.perf_counter()
        procs = cli_localnet(os.path.join(tmp, "net"), NODE_START_CLI_NODES, NODE_START_CLI_HEIGHT, gpu=True,
                             device=NODE_START_DEVICE, timeout_s=NODE_START_CLI_TIMEOUT_S, prometheus=True)
        part3_s = time.perf_counter() - t3
    processes = []
    for nd in procs:
        installed = [line for line in nd.log if "device plane installed" in line]
        if nd.rc != 0 or nd.height < NODE_START_CLI_HEIGHT or len(installed) != 1:
            raise AssertionError(f"node_start: {os.path.basename(nd.home)} exited {nd.rc} at height "
                                 f"{nd.height}, install lines {installed}; log tail {nd.log[-5:]}")
        processes.append({"home": os.path.basename(nd.home), "height": nd.height, "rc": nd.rc,
                          "install_line": installed[0],
                          "scrape": check_cli_scrape(nd, NODE_START_CLI_HEIGHT)})
    launched1 = {k: n for k, n in counts1.items() if n}
    out = {
        "phase": "node_start",
        "validators": {"ed25519": N_VALIDATORS - N_VALIDATORS // 2, "sr25519": N_VALIDATORS // 2},
        "chain_heights": tip,
        "txs_per_block": N_TXS,
        "init_s": init_s,
        "block_sync_from_home": {
            "s": part1_s, "make_node_s": run1.make_s, "start_s": run1.start_s,
            "handshake_s": run1.handshake_s, "start_to_caught_up_s": run1.start_s + run1.sync_s,
            "blocks_applied": run1.applied,
            "blocks_per_s": run1.applied / (run1.start_s + run1.sync_s),
            "block_sync_phase_blocks_per_s": block_sync["blocks_per_s"],
            "launches_at_make_node": assembled,
            "launches": launched1,
            "launches_per_block": {h: {k: n for k, n in pairs[h].items() if n} for h in sorted(pairs)},
            "checks": reports1,
            "scrape": scrape1,
            **{f"{k}_parts_1": v for k, v in catchup_busy(prof1, counts1, run1.seconds).items()},
        },
        "crash_replay": {
            "s": part2_s, "handshake_replay_s": run2.handshake_s, "blocks_replayed": run2.replayed,
            "start_s": run2.start_s,
            "handshake_launches": {k: n for k, n in shakes2[0].items() if n},
            "rule": want2,
            "checks": reports2,
            **{f"{k}_part_2": v for k, v in catchup_busy(prof2, counts2, run2.seconds).items()},
        },
        "cli_processes": {"s": part3_s, "nodes": NODE_START_CLI_NODES, "processes": processes,
                          "launches": 0},
        "equal_to_block_sync": ["launches_per_block", "launches_less_refused_pair"],
        "equal_to_chain": ["blocks", "state", "app_hash", "state_at_tip_after_replay"],
        **probe,
        "ok": True,
    }
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"launches": {"block_sync_from_home": launched1,
                         "crash_replay_handshake": {k: n for k, n in shakes2[0].items() if n}},
            "home": home, "tmp": tmp}


# operator_tools: the operator's commands as processes of the CLI, each
# installing its own device plane. (a)/(b): `light` over config 4's
# chains of OPS_LIGHT_HEIGHTS heights (150 ed25519; 75 + 75 mixed),
# asked for light_block 2..tip in order; (b) with OPS_FAULT.
# (c): `inspect` and `replay` on node_start's stopped home. (d): a
# ProcessRunner net of config 1 to OPS_NET_HEIGHT, validator02 SIGKILLed
# at OPS_NET_KILL_AT and a state-sync joiner starting at OPS_NET_JOIN_AT.
OPS_LIGHT_HEIGHTS = 24
OPS_LIGHT_CHAIN_ID = "chip-smoke-operator"
OPS_FAULT = "gpu.dispatch:raise:p=0.5:seed=11"
OPS_NET_HEIGHT = 7
OPS_NET_KILL_AT = 3
OPS_NET_JOIN_AT = 4
OPS_TIMEOUT_S = 180.0
# where every child installs its plane
OPS_DEVICE = "cuda"
OPS_KERNELS = ("sha512_ram", "ed25519_verify_tile", "sr25519_verify", "sha256_tree")
_OPS_ADDR = re.compile(r" on (127\.0\.0\.1):(\d+)")


@contextlib.contextmanager
def kept_on_success(prefix: str):
    """A temporary directory the caller removes; removed here only when
    the block raises."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix=prefix)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def cli_env(**extra) -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


async def cli_serving(*argv, env=None):
    """A `python3 -m tendermint_tpu_torch.cmd` process serving on
    127.0.0.1: (the process, its address, the lines it printed up to the
    one naming the address, the seconds to that line)."""
    import asyncio

    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "tendermint_tpu_torch.cmd", *argv, env=env or cli_env(),
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
    )
    lines = []
    while True:
        line = (await asyncio.wait_for(proc.stdout.readline(), OPS_TIMEOUT_S)).decode()
        if not line:
            raise AssertionError(f"operator_tools: {argv[:3]} exited {await proc.wait()}: {lines[-8:]}")
        lines.append(line.rstrip("\n"))
        m = _OPS_ADDR.search(line)
        if m:
            return proc, f"{m.group(1)}:{m.group(2)}", lines, time.perf_counter() - t0


async def cli_stopped(proc, what: str) -> list:
    """SIGTERM, then the rest of the output; the process must exit 0."""
    import asyncio
    import signal

    if proc.returncode is None:
        proc.send_signal(signal.SIGTERM)
    out = (await asyncio.wait_for(proc.stdout.read(), OPS_TIMEOUT_S)).decode().splitlines()
    rc = await asyncio.wait_for(proc.wait(), OPS_TIMEOUT_S)
    if rc != 0:
        raise AssertionError(f"operator_tools: {what} exited {rc}: {out[-8:]}")
    return out


def plane_line(lines: list, what: str) -> dict:
    """The `device plane: {...}` line a light or replay process prints
    as its last."""
    reports = [json.loads(x.split("device plane: ", 1)[1]) for x in lines if x.startswith("device plane: ")]
    if len(reports) != 1:
        raise AssertionError(f"operator_tools: {what} printed {len(reports)} device plane lines: {lines[-8:]}")
    return reports[0]


def ops_light_chain(seed: int, n_sr: int) -> dict:
    """A config 4 chain of OPS_LIGHT_HEIGHTS applied blocks (no txs) of
    LIGHT_VALIDATORS validators, n_sr of them sr25519, built on the CPU
    plane (workloads.serve_chain)."""
    from tendermint_tpu_torch.workloads import kv_genesis, seeded_keys, serve_chain, stored_light_blocks

    t0 = time.perf_counter()
    privs = seeded_keys(LIGHT_VALIDATORS, seed, n_sr)
    _chain, node, _states = serve_chain(kv_genesis(OPS_LIGHT_CHAIN_ID, privs), privs,
                                        [[] for _ in range(OPS_LIGHT_HEIGHTS)], seed)
    bs, ss = node.block_store, node.state_store
    return {"node": node, "blocks": stored_light_blocks(bs, ss, range(1, bs.height() + 1)),
            "build_s": time.perf_counter() - t0}


def light_rule(blocks: dict, heights: list, gate: int, step: int) -> dict:
    """commit_rule("light") summed over the hops to `heights`, each an
    adjacent verify_commit_light of its block's commit."""
    rule = dict.fromkeys(SIGNATURE_KERNELS, 0)
    for h in heights:
        lb = blocks[h]
        signers = commit_signers("light", lb.validator_set, lb.signed_header.commit)
        for k, n in window_rule(signers, gate, step).items():
            rule[k] += n
    return rule


def ops_light(torch, chains: dict, tmp: str) -> dict:
    """(a) and (b): for each chain two `light` processes (the second
    under OPS_FAULT) of an RPC server over it, all four spawned and asked
    at once, then an in-process light.Client of the same server; each is
    asked for light_block 2..tip in order (an adjacent hop each:
    verify_commit_light, 2/3 of the set's signatures). The bytes must be
    the chain's stored light blocks; the in-process client's launches
    (counted here) and the first process's (its exit line) must both
    equal light_rule; the faulted one must report faults and rerouted
    signatures."""
    import asyncio

    from tendermint_tpu_torch.crypto import gpu_verifier
    from tendermint_tpu_torch.crypto.gpu_verifier import _GpuBatchVerifier
    from tendermint_tpu_torch.light import Client, LightStore, TrustOptions
    from tendermint_tpu_torch.light.provider import HTTPProvider
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.rpc.core import Environment
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.workloads import rpc_serving

    gate, step = gpu_verifier.installed(), _GpuBatchVerifier.STREAM_CHUNK
    period_s = CATCHUP_TRUST_PERIOD_S
    heights = {name: list(range(2, max(c["blocks"]) + 1)) for name, c in chains.items()}
    rules = {name: light_rule(c["blocks"], heights[name], gate, step) for name, c in chains.items()}
    runs = [(name, run) for name in chains for run in ("plain", "faulted")]

    async def ask(addr: str, hs: list) -> tuple:
        client = HTTPClient(addr, timeout=OPS_TIMEOUT_S)
        t0 = time.perf_counter()
        try:
            got = {h: (await client.call("light_block", height=h))["light_block"] for h in hs}
        finally:
            await client.close()
        return got, (time.perf_counter() - t0) * 1e3 / len(hs)

    async def in_process(name: str, primary: str) -> dict:
        blocks = chains[name]["blocks"]
        client = Client(OPS_LIGHT_CHAIN_ID, TrustOptions(period_ns=int(period_s * 1e9), height=1,
                                                         hash=blocks[1].signed_header.hash()),
                        HTTPProvider(primary), [], LightStore(MemKV()))
        rule = rules[name]
        expect = {"ed25519": (rule["sha512_ram"], {"sha512_ram": rule["sha512_ram"],
                                                   "ed25519_verify_tile": rule["ed25519_verify_tile"]}),
                  "sr25519": (rule["sr25519_verify"], {"sr25519_verify": rule["sr25519_verify"]})}
        by_type: dict = {}
        before = gpu_verifier.stats()
        t0 = time.perf_counter()
        with charged_dispatches(by_type):
            reset_launches()
            mine = {h: (await client.verify_light_block_at_height(h, time.time_ns())).to_proto().hex()
                    for h in heights[name]}
            torch.cuda.synchronize()
            counts = launches()
        ms = (time.perf_counter() - t0) * 1e3 / len(heights[name])
        await client.primary.close()
        checked = check_counts(before, gpu_verifier.stats(), by_type, counts, expect,
                               where=f"operator_tools light {name} in process")
        return {"mine": mine, "ms": ms, "checked": checked}

    async def go() -> dict:
        envs = [Environment(chain_id=OPS_LIGHT_CHAIN_ID, block_store=c["node"].block_store,
                            state_store=c["node"].state_store) for c in chains.values()]
        async with rpc_serving(envs) as addrs:
            primary = dict(zip(chains, addrs))

            def argv(name, run):
                return ["--home", os.path.join(tmp, f"light-{name}-{run}"), "light", OPS_LIGHT_CHAIN_ID,
                        "--primary", primary[name], "--trust-height", "1",
                        "--trust-hash", chains[name]["blocks"][1].signed_header.hash().hex(),
                        "--trust-period", str(period_s), "--laddr", "tcp://127.0.0.1:0", "--device", OPS_DEVICE]

            procs = await asyncio.gather(*(
                cli_serving(*argv(name, run), env=cli_env(**({"TM_TPU_FAULT": OPS_FAULT} if run == "faulted" else {})))
                for name, run in runs))
            try:
                asked = await asyncio.gather(*(ask(p[1], heights[name]) for (name, _r), p in zip(runs, procs)))
            finally:
                exits = [await cli_stopped(p[0], f"light {name} {run}") for (name, run), p in zip(runs, procs)]
            mine = {name: await in_process(name, primary[name]) for name in chains}
            return {"procs": procs, "asked": asked, "exits": exits, "mine": mine}

    res = asyncio_ops(go())
    out = {}
    for name, chain in chains.items():
        blocks = chain["blocks"]
        want = {h: blocks[h].to_proto().hex() for h in heights[name]}
        got = {run: res["asked"][i] for i, (n, run) in enumerate(runs) if n == name}
        lines = {run: res["exits"][i] for i, (n, run) in enumerate(runs) if n == name}
        ready = {run: res["procs"][i][3] for i, (n, run) in enumerate(runs) if n == name}
        for run, (served, _ms) in got.items():
            if served != want:
                bad = [h for h in heights[name] if served[h] != want[h]]
                raise AssertionError(f"operator_tools: light {name} {run} served other bytes at heights {bad}")
        mine = res["mine"][name]
        if mine["mine"] != want:
            raise AssertionError(f"operator_tools: the in-process client of {name} verified other light blocks")
        plain, faulted = (plane_line(lines[run], f"light {name} {run}") for run in ("plain", "faulted"))
        rule = rules[name]
        child = {k: plain["launches"].get(k, 0) for k in OPS_KERNELS}
        if child != {**rule, "sha256_tree": 0} or any(n for k, n in plain["launches"].items() if k not in OPS_KERNELS):
            raise AssertionError(f"operator_tools: light {name} launched {plain['launches']}, the rule {rule}")
        if plain["installed"] != OPS_DEVICE or plain["stats"]["faults"] or plain["stats"]["rerouted_sigs"]:
            raise AssertionError(f"operator_tools: light {name}'s plane {plain['installed']}, stats {plain['stats']}")
        if faulted["stats"]["faults"] < 1 or faulted["stats"]["rerouted_sigs"] < 1:
            raise AssertionError(f"operator_tools: light {name} under {OPS_FAULT} reported {faulted['stats']}")
        key_types = [v.pub_key.type() for v in blocks[1].validator_set.validators]
        out[name] = {
            "validators": {kt: key_types.count(kt) for kt in ("ed25519", "sr25519")},
            "heights_asked": [heights[name][0], heights[name][-1]],
            "chain_build_s": chain["build_s"],
            "proxy_ready_s": ready,
            "ms_per_light_block": {**{run: ms for run, (_g, ms) in got.items()}, "in_process": mine["ms"]},
            "rule": rule,
            "launches_child": {k: n for k, n in child.items() if n},
            "launches_in_process": {k: n for k, n in mine["checked"].items() if k != "by_key_type" and n},
            "faulted": {"spec": OPS_FAULT, "faults": faulted["stats"]["faults"],
                        "rerouted_sigs": faulted["stats"]["rerouted_sigs"],
                        "launches": {k: n for k, n in faulted["launches"].items() if n}},
            "equal_bytes": ["plain", "faulted", "in_process", "stored"],
        }
    return out


def asyncio_ops(coro):
    """asyncio.run under the phase's limit, so that a hang fails it."""
    import asyncio

    return asyncio.run(asyncio.wait_for(coro, 4 * OPS_TIMEOUT_S))


def ops_inspect_replay(node_start: dict, served: dict) -> dict:
    """(c)'s processes on node_start's stopped home: `inspect` refuses
    while this process holds the data dir's lock; then it serves block,
    commit, light_block and header at heights 1, tip // 2 and tip (10k
    light blocks, ~1 MB of JSON each), whose answers ops_inspect_check
    holds against the stores. `replay --device cuda` rebuilds the app
    from the stored blocks: its final height and app hash are the
    chain's, and its launches are X4 = blocks + 1 (the InitChain's root
    and one app hash a block) and nothing else. Nothing here runs a
    kernel in this process."""
    import asyncio

    from tendermint_tpu_torch.node.node import acquire_pid_lock, release_pid_lock
    from tendermint_tpu_torch.rpc.client import HTTPClient

    home = node_start["home"]
    states = served["states"]
    tip = len(served["chain"])
    heights = (1, tip // 2, tip)
    routes = [(m, h) for h in heights for m in ("block", "commit", "light_block", "header")]

    async def refused() -> tuple:
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home", home, "inspect",
            "--laddr", "tcp://127.0.0.1:0", env=cli_env(),
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT)
        out = (await asyncio.wait_for(proc.stdout.read(), OPS_TIMEOUT_S)).decode()
        return await proc.wait(), out

    lock = os.path.join(home, "data", "LOCK")
    fd = acquire_pid_lock(lock)
    try:
        t0 = time.perf_counter()
        rc, out = asyncio_ops(refused())
        refused_s = time.perf_counter() - t0
    finally:
        release_pid_lock(lock, fd)
    if rc != 1 or "node appears to be running" not in out:
        raise AssertionError(f"operator_tools: inspect of a locked home exited {rc}: {out[-300:]}")

    async def served_by_inspect() -> tuple:
        proc, addr, _lines, ready_s = await cli_serving("--home", home, "inspect", "--laddr", "tcp://127.0.0.1:0")
        client = HTTPClient(addr, timeout=OPS_TIMEOUT_S)
        try:
            t0 = time.perf_counter()
            got = {f"{m} {h}": await client.call(m, height=h) for m, h in routes}
            return got, ready_s, (time.perf_counter() - t0) * 1e3 / len(routes)
        finally:
            await client.close()
            await cli_stopped(proc, "inspect")

    t0 = time.perf_counter()
    got, ready_s, ms = asyncio_ops(served_by_inspect())
    inspect_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home", home, "replay",
                           "--device", OPS_DEVICE], env=cli_env(), capture_output=True, text=True,
                          timeout=OPS_TIMEOUT_S)
    replay_s = time.perf_counter() - t0
    lines = done.stdout.splitlines()
    if done.returncode != 0:
        raise AssertionError(f"operator_tools: replay exited {done.returncode}: {done.stderr[-600:]}")
    final = [x for x in lines if x.startswith("replayed ")]
    want_line = f"replayed {tip} blocks; final height {tip} app_hash {states[tip - 1].app_hash.hex()}"
    if final != [want_line]:
        raise AssertionError(f"operator_tools: replay printed {final}, not [{want_line!r}]")
    report = plane_line(lines, "replay")
    child = {k: report["launches"].get(k, 0) for k in OPS_KERNELS}
    want_launches = {**dict.fromkeys(SIGNATURE_KERNELS, 0), "sha256_tree": tip + 1}
    if child != want_launches or any(n for k, n in report["launches"].items() if k not in OPS_KERNELS):
        raise AssertionError(f"operator_tools: replay launched {report['launches']}, not {want_launches}")
    if report["installed"] != OPS_DEVICE or report["stats"]["faults"]:
        raise AssertionError(f"operator_tools: replay's plane {report['installed']}, stats {report['stats']}")
    return {
        "answers": got, "heights": heights, "routes": routes,
        "inspect": {"refused_locked_s": refused_s, "ready_s": ready_s, "s": inspect_s, "ms_per_route": ms,
                    "routes": len(routes), "equal_to": ["rpc_server_over_the_stores", "stored_light_blocks"]},
        "replay": {"s": replay_s, "blocks": tip, "app_hash": states[tip - 1].app_hash.hex(),
                   "launches": {k: n for k, n in child.items() if n}, "rule": {"sha256_tree": tip + 1}},
    }


def ops_inspect_check(node_start: dict, served: dict, res: dict) -> None:
    """(c)'s check, in this process with no plane installed: each answer
    `inspect` gave equals an RPC server's over the same stores, and each
    light block the stored bytes."""
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.rpc.core import Environment
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore
    from tendermint_tpu_torch.store.kv import SqliteKV
    from tendermint_tpu_torch.workloads import rpc_serving, stored_light_blocks

    home = node_start["home"]
    dbs = [SqliteKV(os.path.join(home, "data", f"{n}.sqlite")) for n in ("blockstore", "state")]
    try:
        bs, ss = BlockStore(dbs[0]), StateStore(dbs[1])

        async def in_process() -> dict:
            async with rpc_serving([Environment(chain_id=served["states"][0].chain_id, block_store=bs,
                                                state_store=ss)]) as (addr,):
                client = HTTPClient(addr, timeout=OPS_TIMEOUT_S)
                try:
                    return {f"{m} {h}": await client.call(m, height=h) for m, h in res["routes"]}
                finally:
                    await client.close()

        want = asyncio_ops(in_process())
        stored = stored_light_blocks(bs, ss, res["heights"])
    finally:
        for db in dbs:
            db.close()
    got = res["answers"]
    if got != want:
        bad = [k for k in got if got[k] != want[k]]
        raise AssertionError(f"operator_tools: inspect answered {bad[:6]} unlike the stores")
    for h in res["heights"]:
        if got[f"light_block {h}"]["light_block"] != stored[h].to_proto().hex():
            raise AssertionError(f"operator_tools: inspect's light block {h} is not the stored one")


def ops_process_net(tmp: str) -> dict:
    """(d) a ProcessRunner net of config 1 (e2e/process_runner.py): four
    validators as `start --device cuda` processes with their `abci
    kvstore` processes over TCP, validator02 SIGKILLed at OPS_NET_KILL_AT
    and started again, and full01 state-syncing from OPS_NET_JOIN_AT, to
    OPS_NET_HEIGHT. The runner's invariants hold (one chain over RPC, the
    joiner restored and holds no genesis block), every start of a child
    installed its plane, every node exits 0 on the runner's SIGTERM, and
    the block-interval stats are reported.
    Under the gate of 32 its commits verify on the CPU plane (no
    launch, by rule)."""
    import asyncio

    from tendermint_tpu_torch.e2e import Manifest
    from tendermint_tpu_torch.e2e.process_runner import ProcessRunner

    m = Manifest.parse({
        "chain_id": "chip-smoke-e2e",
        "target_height": OPS_NET_HEIGHT,
        "validators": {f"validator{i:02d}": 10 for i in range(1, 5)},
        "node": {
            "validator02": {"perturb": [f"kill:{OPS_NET_KILL_AT}"]},
            "full01": {"mode": "full", "start_at": OPS_NET_JOIN_AT, "state_sync": True},
        },
    })
    runner = ProcessRunner(m, os.path.join(tmp, "net"), timeout=OPS_TIMEOUT_S, device=OPS_DEVICE)
    t0 = time.perf_counter()
    rep = asyncio.run(runner.run())
    net_s = time.perf_counter() - t0
    if not rep.ok:
        raise AssertionError(f"operator_tools: the process net failed: {rep.failures}")
    installs = {}
    for name, h in runner.handles.items():
        with open(h.log_path, errors="replace") as f:
            installs[name] = (f.read().count("device plane installed"), h.starts)
    if any(n != starts for n, starts in installs.values()) or installs["validator02"][1] != 2:
        raise AssertionError(f"operator_tools: plane installs / starts by node {installs}")
    if rep.state_synced != {"full01": True}:
        raise AssertionError(f"operator_tools: the joiner {rep.state_synced}")
    exits = {name: h.node_proc.returncode for name, h in runner.handles.items()}
    if any(rc != 0 for rc in exits.values()):
        raise AssertionError(f"operator_tools: the nodes' exits on SIGTERM {exits}")
    return {"s": net_s, "nodes": len(installs), "reached_height": rep.reached_height,
            "starts": {n: s for n, (_i, s) in installs.items()}, "state_synced": rep.state_synced,
            "blocks": rep.blocks, "interval_avg_s": rep.interval_avg, "interval_stddev_s": rep.interval_stddev,
            "interval_min_s": rep.interval_min, "interval_max_s": rep.interval_max, "launches": 0}


def phase_operator_tools(torch, seed: int, served: dict, node_start: dict) -> dict:
    """The operator's tools as processes of the CLI on the card (ROADMAP
    item 21b): (a) `light` over config 4's ed25519 and mixed chains with
    the launches of the rule, (b) the same under TM_TPU_FAULT, (c)
    `inspect` and `replay` on node_start's stopped home, (d) a
    ProcessRunner net of config 1 across a SIGKILL and a state-synced
    joiner (ops_light, ops_inspect_replay and ops_inspect_check,
    ops_process_net). (c)'s processes and (d) run on threads of their own
    beside (a) (the script's time): their processes count their own
    launches (replay's exit line) or launch nothing, and this process
    launches only in (a)'s in-process clients (the threads run no check
    here; (c)'s comparison with the stores runs after (a), with the plane
    uninstalled), so every count stays exact; the hosts' timings are
    taken under each other's load. The in-process light clients run with this process's
    plane installed (install_device_plane(GPUConfig()),
    settle_probes()). Reports each part's seconds."""
    import shutil
    import threading

    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import gpu_verifier, merkle
    from tendermint_tpu_torch.node.device import install_device_plane, uninstall_device_plane

    if gpu_verifier.installed() is not None or merkle._device_root_hook is not None:
        raise AssertionError("the device plane is installed before operator_tools")
    t_phase = time.perf_counter()
    out = {"phase": "operator_tools", "device": OPS_DEVICE}
    parts: dict = {}

    def run_part(name: str, fn, *args) -> None:
        t0 = time.perf_counter()
        try:
            parts[name] = fn(*args)
            parts[name]["s"] = time.perf_counter() - t0
        except BaseException as e:  # raised by the phase once the thread is joined
            parts[name] = e

    try:
        with kept_on_success("operator_tools_") as tmp:
            threads = [
                threading.Thread(target=run_part, args=("process_net", ops_process_net, tmp)),
                threading.Thread(target=run_part, args=("inspect_replay", ops_inspect_replay,
                                                        node_start, served)),
            ]
            for thread in threads:
                thread.start()
            try:
                t0 = time.perf_counter()
                chains = {"ed25519": ops_light_chain(seed + 90, 0),
                          "mixed": ops_light_chain(seed + 91, LIGHT_VALIDATORS // 2)}
                install_device_plane(GPUConfig())
                settle_probes()
                try:
                    light = ops_light(torch, chains, tmp)
                finally:
                    uninstall_device_plane()
                out["light"] = {"s": time.perf_counter() - t0, **light}
            finally:
                for thread in threads:
                    thread.join(4 * OPS_TIMEOUT_S)
                if any(thread.is_alive() for thread in threads):
                    raise AssertionError("operator_tools: a part on a thread did not end")
                shutil.rmtree(tmp, ignore_errors=True)
            for name in ("inspect_replay", "process_net"):
                if isinstance(parts[name], BaseException):
                    raise parts[name]
            ops_inspect_check(node_start, served, parts["inspect_replay"])
            for key in ("answers", "heights", "routes"):
                del parts["inspect_replay"][key]
            out["inspect_replay"] = parts["inspect_replay"]
            out["process_net"] = parts["process_net"]
    finally:
        shutil.rmtree(node_start["tmp"], ignore_errors=True)
    out["ok"] = True
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"launches": {"light_ed25519": light["ed25519"]["launches_child"],
                         "light_mixed": light["mixed"]["launches_child"],
                         "replay": out["inspect_replay"]["replay"]["launches"]}}


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
            "plain_ms": _PLAIN_MS.pop(plain),
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
        for a, b in zip(got, plain_once(torch, x1_plain))
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
    got, plain = k2(), plain_once(torch, k2_plain)
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
    err = max(projective_err(torch, a, b) for a, b in zip(k1(), plain_once(torch, k1_plain)))
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
    got, plain = x3(), plain_once(torch, x3_plain)
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
    err = int((got.int() - plain_once(torch, x4_plain).int()).abs().max().item())
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
    (r_k, ok_k), (r_p, ok_p) = x5(), plain_once(torch, x5_plain)
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
    sharding = phase_sharding(torch, dev, args.seed, main_run, mixed_run)
    phase_compile_probe(torch)
    phase_secp256k1(torch, args.seed)
    phase_config4(torch, args.seed)
    votes = phase_vote_path(torch, dev, args.seed)
    block_exec = phase_block_exec(torch, args.seed)
    heights = phase_consensus_heights(torch, args.seed)
    mempool = phase_mempool_proposer(torch, args.seed)
    gossip = phase_consensus_gossip(torch, args.seed)
    served = catchup_chain(args.seed)
    block_sync = phase_block_sync(torch, args.seed, served)
    state_sync = phase_state_sync(torch, args.seed, served)
    rpc = phase_rpc(torch, args.seed, served)
    node_start = phase_node_start(torch, args.seed, served, block_sync)
    operator_tools = phase_operator_tools(torch, args.seed, served, node_start)
    del served
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
    # every kernel's launches in each height of phase consensus_heights
    for r in kernels["kernels"]:
        r["consensus_heights"] = {
            "launches_per_height": {
                str(h): c.get(r["name"], 0) for h, c in heights["launches"].items()
            },
            "launches_per_height_150": {
                str(h): c.get(r["name"], 0) for h, c in heights["light_launches"].items()
            },
        }
    # every kernel's launches in each height of phase mempool_proposer
    for r in kernels["kernels"]:
        r["mempool_proposer"] = {
            "launches_per_height": {
                str(h): c.get(r["name"], 0) for h, c in mempool["launches"].items()
            },
        }
    # every kernel's launches in each height of phase consensus_gossip
    for r in kernels["kernels"]:
        r["consensus_gossip"] = {
            "launches_per_height": {
                str(h): c.get(r["name"], 0) for h, c in gossip["launches"].items()
            },
        }
    # every kernel's launches in one mixed 10k verify_commit split over k
    # virtual shards (phase sharding)
    for r in kernels["kernels"]:
        r["sharding"] = {
            "launches_per_verify_commit": {
                k: c.get(r["name"], 0) for k, c in sharding["mixed_10k_launches_per_verify_commit"].items()
            }
        }
    # every kernel's launches in the catch-up phases' runs
    for r in kernels["kernels"]:
        r["block_sync"] = {"launches": block_sync["launches"].get(r["name"], 0)}
        r["state_sync"] = {"launches": state_sync["launches"].get(r["name"], 0)}
        r["rpc"] = {run: c.get(r["name"], 0) for run, c in rpc["launches"].items()}
        r["node_start"] = {run: c.get(r["name"], 0) for run, c in node_start["launches"].items()}
        r["operator_tools"] = {run: c.get(r["name"], 0) for run, c in operator_tools["launches"].items()}
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
