"""The port's bench: one JSON line of its end-to-end numbers on the card.

    python3 -m tendermint_tpu_torch.bench [--seed S] [--cells a,b,...]
        [--headers N] [--device cpu]

Counterpart of the JAX package's bench.py cells (that script stays as it
is), each run through the port's entry points with the device plane
installed from its config (node.device.install_device_plane(GPUConfig())):

- batch_curve: microseconds a signature through the BatchVerifier seam
  (crypto.batch.create_batch_verifier with the batch's size hint, add,
  verify) at 1, 8, 64 and 1024 signatures, per key type (BASELINE.md
  config 2; bench.py:1291 bench_batch_curve). Below the min-batch gate
  the seam answers from the native CPU plane, as it does for callers;
- throughput_8192: sig-verifies/s of 8192-signature windows of the ops
  verifiers, four in flight, per key type (BASELINE.md's primary metric;
  bench.py:74 bench_throughput);
- commit10k_ed25519, commit10k_mixed: p50 and p95 of verify_commit on a
  10,000-validator Commit (all ed25519; 5,000 + 5,000 sr25519), and the
  p50 of its stages timed inside the call: sign-bytes, the batch
  verifiers' add loop (which dispatches full windows), their verify, and
  the scan, the vector plan's tally (bench.py:242, :365);
- light150_ed25519, light150_mixed: p50 and p95 of verify_commit_light on
  a 150-validator Commit (75 + 75 mixed; BASELINE.md config 3);
- light_sync: headers/s of a fresh sequential light client verifying a
  chain of `--headers` headers at 150 validators from its trust root,
  with merged windows (affinity 32) and one commit a window (affinity
  1), each twice in turns (the mean, and the readings), BASELINE.md
  config 4 (bench.py:1230 bench_light_sync). When
  building the chain would take longer than --chain-budget-s, the
  header count is cut to the largest multiple of 32 that fits, and
  `reduced` says so;
- sign_keygen: microseconds of one keygen and one signature per key
  type, on the host (bench.py:140 bench_sign_keygen): what building the
  chains and commits above costs;
- config5_merkle: p50 and p95 of the mixed 10k set's root and its
  Commit's, txs_hash of 10,000 transactions of 100-300 bytes, and
  verify_proofs_batch of their proofs (BASELINE.md config 5; bench.py
  :1461), each root and bitmap checked against the host's first;
- commit10k_mixed_cpu_plane: the mixed 10k verify_commit with both key
  types' breakers held open, all of it on the native CPU plane
  (bench.py:454 bench_commit_fallback);
- vote_ingest: votes/s of the consensus vote path, from VoteMessage wire
  bytes to every vote in its VoteSet, for the prevotes then the
  precommits of one height (workloads.build_vote_traffic) fed in bursts
  of 256 (one pre-verify each) into a fresh ConsensusState, the cache
  emptied before each run: at 150 ed25519 validators and at the 10k
  mixed set; the mean of VOTE_REPS runs after one warm-up, and one run with the cache
  disabled (every vote verified alone on the CPU). Each run must add
  every vote and reach +2/3 of the precommits; the commit made of them
  must verify;
- block_exec: blocks/s and the p50 and p95 of
  state.execution.BlockExecutor.apply_block on the kvstore app at the
  mixed 10k set: a chain of BLOCK_HEIGHTS blocks of 10,000 kvstore
  transactions of 100-300 bytes, each LastCommit signed by every
  validator (workloads.build_block_chain), replayed BLOCK_REPS times on
  a fresh node with SqliteKV stores after one warm-up; blocks/s over
  every height's apply_block, the percentiles over heights 2 and up.
  Each replay's app hash after a height must be the one the next block
  names.

Every cell checks its outputs (a verified commit, a full bitmap, equal
roots, every header verified) and fails otherwise; no device fault and
no rerouted signature may occur outside the CPU-plane cell. The line
holds the card's name and power limit as nvidia-smi gives them, the
seed, each cell and the wall time. Inputs come from --seed
(tendermint_tpu_torch.workloads). Without CUDA it exits 2, unless
--device cpu is given: the kernels' plain versions, which take about a
second a device window, so only for small sizes (its test sets the
module's size constants).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

__all__ = ["CELLS", "CELL_KEYS", "main", "run"]

CHAIN_ID = "bench-chain"
HEIGHT = 1234
# the commit cells' validators (BASELINE.md config 5's), the light ones'
# (configs 3 and 4), the light chain's headers (config 4) and config 5's
# transactions
VALIDATORS = 10_000
LIGHT_VALIDATORS = 150
HEADERS = 10_000
TXS = 10_000
THROUGHPUT_BATCH = 8192
CURVE_SIZES = (1, 8, 64, 1024)
# repetitions: end-to-end calls, stages, curve points, CPU-plane commits,
# keygens and signatures, vote ingests
REPS, STAGE_REPS, CURVE_REPS, CPU_REPS, SIGN_REPS, VOTE_REPS = 20, 5, 5, 3, 300, 3
# block_exec's chain and replays
BLOCK_HEIGHTS, BLOCK_REPS = 3, 5
# the most light_sync may spend building its chain before it cuts it
CHAIN_BUDGET_S = 240.0

# each cell and the keys of its object
CELL_KEYS = {
    "batch_curve": ("us_per_sig", "sizes", "reps", "min_batch"),
    "throughput_8192": ("sig_verifies_per_s", "batch", "in_flight", "reps"),
    "commit10k_ed25519": ("validators", "p50_ms", "p95_ms", "reps", "stages_p50_ms"),
    "commit10k_mixed": ("validators", "p50_ms", "p95_ms", "reps", "stages_p50_ms"),
    "light150_ed25519": ("validators", "p50_ms", "p95_ms", "reps"),
    "light150_mixed": ("validators", "p50_ms", "p95_ms", "reps"),
    "light_sync": (
        "headers_per_s",
        "headers_per_s_readings",
        "headers",
        "validators",
        "window",
        "chain_build_s",
        "reduced",
    ),
    "sign_keygen": ("us", "reps"),
    "config5_merkle": ("ms", "txs", "reps"),
    "vote_ingest": ("votes_per_s", "votes_per_s_cache_off", "votes", "burst", "reps"),
    "block_exec": (
        "blocks_per_s",
        "p50_ms",
        "p95_ms",
        "heights",
        "txs",
        "validators",
        "reps",
        "chain_build_s",
    ),
    # last: it leaves both breakers open
    "commit10k_mixed_cpu_plane": ("validators", "p50_ms", "p95_ms", "reps"),
}
CELLS = tuple(CELL_KEYS)


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _timed(fn, reps: int) -> list:
    """Host-clock ms of `reps` calls of fn after one warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _p50_p95(times) -> dict:
    return {
        "p50_ms": float(np.percentile(times, 50)),
        "p95_ms": float(np.percentile(times, 95)),
    }


class Ctx:
    """What the cells share: the arguments, the device and the commits
    built so far."""

    def __init__(self, args) -> None:
        self.args = args
        self.device = args.device
        self.cache: dict = {}

    def commit(self, n: int, mixed: bool):
        from .workloads import build_commit

        key = ("commit", n, mixed)
        if key not in self.cache:
            seed = self.args.seed + (0 if n == VALIDATORS else 1)
            self.cache[key] = build_commit(
                n, seed, CHAIN_ID, HEIGHT, n // 2 if mixed else 0
            )
        return self.cache[key]


def _stats():
    from .crypto import gpu_verifier

    return gpu_verifier.stats()


def _no_fault(before: dict, where: str) -> None:
    after = _stats()
    for key in ("faults", "rerouted_sigs"):
        if after[key] != before[key]:
            raise AssertionError(f"{where}: {key} rose by {after[key] - before[key]}")


def cell_batch_curve(ctx: Ctx) -> dict:
    from .crypto.batch import create_batch_verifier
    from .crypto.gpu_verifier import installed
    from .crypto.sr25519 import sign_batch
    from .workloads import seeded_keys

    reps = CURVE_REPS
    out = {}
    for kt in ("ed25519", "sr25519"):
        curve = {}
        for n in CURVE_SIZES:
            k = min(n, 64)
            privs = seeded_keys(k, ctx.args.seed + 7, k if kt == "sr25519" else 0)
            msgs = [b"curve-%d" % i for i in range(n)]
            signers = [privs[i % k] for i in range(n)]
            if kt == "sr25519":
                witness = np.random.default_rng([ctx.args.seed, 7])
                sigs = sign_batch(signers, msgs, rng=witness.bytes)
            else:
                sigs = [p.sign(m) for p, m in zip(signers, msgs)]
            triples = [(p.pub_key(), m, s) for p, m, s in zip(signers, msgs, sigs)]

            def once():
                bv = create_batch_verifier(triples[0][0], size_hint=n)
                for pk, msg, sig in triples:
                    bv.add(pk, msg, sig)
                ok, _bits = bv.verify()
                if not ok:
                    raise AssertionError(f"batch_curve: a {kt} batch of {n} failed")

            curve[str(n)] = float(np.mean(_timed(once, reps))) * 1e3 / n
        out[kt] = curve
    return {
        "us_per_sig": out,
        "sizes": list(CURVE_SIZES),
        "reps": reps,
        "min_batch": installed(),
    }


def cell_throughput(ctx: Ctx) -> dict:
    from .crypto.sr25519 import sign_batch
    from .ops.ed25519_kernel import Ed25519Verifier
    from .ops.sr25519_kernel import Sr25519Verifier
    from .workloads import seeded_keys

    n = THROUGHPUT_BATCH
    depth, reps = 4, 8
    out = {}
    for kt, cls in (("ed25519", Ed25519Verifier), ("sr25519", Sr25519Verifier)):
        k = min(n, 64)
        privs = seeded_keys(k, ctx.args.seed + 8, k if kt == "sr25519" else 0)
        rng = np.random.default_rng([ctx.args.seed, 8])
        msgs = [rng.bytes(64) for _ in range(n)]
        signers = [privs[i % k] for i in range(n)]
        if kt == "sr25519":
            sigs = sign_batch(signers, msgs, rng=rng.bytes)
        else:
            sigs = [p.sign(m) for p, m in zip(signers, msgs)]
        pks = [p.pub_key().bytes() for p in signers]
        verifier = cls(bucket_sizes=[n], device=ctx.device)
        if not verifier.verify(pks, msgs, sigs).all():
            raise AssertionError(f"throughput: the {kt} warm-up batch failed")
        all_ok = True
        handles = []
        t0 = time.perf_counter()
        for _ in range(reps):
            handles.append(verifier.dispatch(pks, msgs, sigs))
            if len(handles) >= depth:
                all_ok &= bool(verifier.gather(handles.pop(0)).all())
        for h in handles:
            all_ok &= bool(verifier.gather(h).all())
        dt = (time.perf_counter() - t0) / reps
        if not all_ok:
            raise AssertionError(f"throughput: a pipelined {kt} batch failed")
        out[kt] = n / dt
    return {"sig_verifies_per_s": out, "batch": n, "in_flight": depth, "reps": reps}


@contextlib.contextmanager
def _clocked(spots):
    """For the block, each (owner, attribute, list) in `spots` is wrapped
    to append its calls' host ms to the list; the calls are unchanged."""
    saved = []

    def clock(fn, into):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                into.append((time.perf_counter() - t0) * 1e3)

        return wrapper

    for owner, attr, into in spots:
        saved.append((owner, attr, vars(owner)[attr]))
        setattr(owner, attr, clock(getattr(owner, attr), into))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _stages(vals, commit, reps: int) -> dict:
    """p50 ms of verify_commit's stages inside the real call (its vector
    plan), each timed by wrapping a function it calls: sign_bytes
    (Commit.sign_bytes_batch), assemble (types.validation._drain_pending,
    each key type's add loop, which dispatches full windows, less verify),
    verify (the batch verifiers' verify(): the last windows and the
    gathers) and scan (the rest: the plan's tally and its triples)."""
    from .crypto.gpu_verifier import _GpuBatchVerifier
    from .types import validation

    times = {"sign_bytes": [], "assemble": [], "verify": [], "scan": []}
    spent = {"sign_bytes": [], "drain": [], "verify": []}
    spots = (
        (type(commit), "sign_bytes_batch", spent["sign_bytes"]),
        (validation, "_drain_pending", spent["drain"]),
        (_GpuBatchVerifier, "verify", spent["verify"]),
    )
    with _clocked(spots):
        for _ in range(reps + 1):
            for v in spent.values():
                v.clear()
            t0 = time.perf_counter()
            validation.verify_commit(CHAIN_ID, vals, commit.block_id, HEIGHT, commit)
            total = (time.perf_counter() - t0) * 1e3
            sb, drain, verify = (sum(spent[k]) for k in ("sign_bytes", "drain", "verify"))
            times["sign_bytes"].append(sb)
            times["assemble"].append(drain - verify)
            times["verify"].append(verify)
            times["scan"].append(total - sb - drain)
    return {k: float(np.median(v[1:])) for k, v in times.items()}


def _cell_commit(ctx: Ctx, mixed: bool) -> dict:
    from .types.validation import verify_commit

    n = VALIDATORS
    vals, bid, commit = ctx.commit(n, mixed)
    before = _stats()
    times = _timed(lambda: verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit), REPS)
    stages = _stages(vals, commit, STAGE_REPS)
    _no_fault(before, "commit10k")
    return {
        "validators": n,
        **_p50_p95(times),
        "reps": REPS,
        "stages_p50_ms": stages,
    }


def _cell_light(ctx: Ctx, mixed: bool) -> dict:
    from .types.validation import verify_commit_light

    n = LIGHT_VALIDATORS
    vals, bid, commit = ctx.commit(n, mixed)
    before = _stats()
    times = _timed(
        lambda: verify_commit_light(CHAIN_ID, vals, bid, HEIGHT, commit), REPS
    )
    _no_fault(before, "light150")
    return {"validators": n, **_p50_p95(times), "reps": REPS}


def cell_light_sync(ctx: Ctx) -> dict:
    from .light.client import SEQUENTIAL_BATCH_HOPS
    from .workloads import build_light_chain, light_client, light_sync

    want = ctx.args.headers
    nv = LIGHT_VALIDATORS
    # project the build from 32 headers; cut to what fits the budget
    t0 = time.perf_counter()
    build_light_chain(CHAIN_ID, 33, nv, ctx.args.seed + 4)
    per_header = (time.perf_counter() - t0) / 33
    headers, reduced = want, None
    budget = CHAIN_BUDGET_S
    if per_header * (want + 1) > budget:
        fit = int(budget / per_header) - 1
        headers = max(SEQUENTIAL_BATCH_HOPS, fit // SEQUENTIAL_BATCH_HOPS * SEQUENTIAL_BATCH_HOPS)
        reduced = {
            "headers": [want, headers],
            "reason": (
                f"building {want} headers at {per_header * 1e3:.2f} ms a header "
                f"would take {per_header * (want + 1):.0f} s, over the "
                f"{budget:.0f} s budget"
            ),
        }
    t0 = time.perf_counter()
    blocks = build_light_chain(CHAIN_ID, headers + 1, nv, ctx.args.seed + 4)
    build_s = time.perf_counter() - t0
    before = _stats()
    # merged, a commit at a time, then both again in reverse order
    sizes = {"merged": SEQUENTIAL_BATCH_HOPS, "per_commit": 1}
    readings = {name: [] for name in sizes}
    for name in [*sizes, *reversed(sizes)]:
        seconds = light_sync(light_client(blocks, CHAIN_ID), sizes[name])
        readings[name].append(headers / seconds)
    _no_fault(before, "light_sync")
    return {
        "headers_per_s": {k: float(np.mean(v)) for k, v in readings.items()},
        "headers_per_s_readings": readings,
        "headers": headers,
        "validators": nv,
        "window": SEQUENTIAL_BATCH_HOPS,
        "chain_build_s": build_s,
        "reduced": reduced,
    }


def cell_sign_keygen(ctx: Ctx) -> dict:
    from .crypto.ed25519 import PrivKeyEd25519
    from .crypto.sr25519 import PrivKeySr25519

    reps = SIGN_REPS
    rng = np.random.default_rng([ctx.args.seed, 9])
    seeds = [rng.bytes(32) for _ in range(reps)]
    msg = rng.bytes(120)  # a vote's sign-bytes are 116-118 bytes
    out = {}
    for kt, cls in (("ed25519", PrivKeyEd25519), ("sr25519", PrivKeySr25519)):
        cls(seeds[0]).sign(msg)  # the native plane and its tables, untimed
        t0 = time.perf_counter()
        keys = [cls(s) for s in seeds]
        keygen = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        sigs = [k.sign(msg) for k in keys]
        sign = (time.perf_counter() - t0) / reps
        if not all(k.pub_key().verify_signature(msg, s) for k, s in zip(keys, sigs)):
            raise AssertionError(f"sign_keygen: a {kt} signature does not verify")
        out[kt] = {"keygen_us": keygen * 1e6, "sign_us": sign * 1e6}
    return {"us": out, "reps": reps}


def cell_config5(ctx: Ctx) -> dict:
    from .crypto import merkle
    from .node.device import install_device_plane, uninstall_device_plane
    from .config import GPUConfig
    from .types.tx import txs_hash, txs_proofs, tx_hash
    from .workloads import block_txs

    vals, _bid, commit = ctx.commit(VALIDATORS, True)
    txs = block_txs(ctx.args.seed, TXS, (100, 300))
    leaves = [tx_hash(t) for t in txs]

    def set_root():
        # the root as hash() computes it on a new set (no memo)
        return merkle.hash_from_byte_slices([v.hash_bytes() for v in vals.validators])

    calls = {
        "validator_set_hash": set_root,
        "commit_hash": commit.hash,
        "txs_hash": lambda: txs_hash(txs),
    }
    # the host's answers, the device plane off
    uninstall_device_plane()
    want = {name: fn() for name, fn in calls.items()}
    proofs = txs_proofs(txs)
    data = want["txs_hash"]
    install_device_plane(GPUConfig(), device=ctx.device)
    out = {}
    for name, fn in calls.items():
        if fn() != want[name]:
            raise AssertionError(f"config5: {name} differs from the host's")
        out[name] = _p50_p95(_timed(fn, REPS))

    def proofs_batch():
        return merkle.verify_proofs_batch(proofs, data, leaves)

    if not np.asarray(proofs_batch()).all():
        raise AssertionError("config5: a valid proof was rejected")
    out["verify_proofs_batch"] = _p50_p95(_timed(proofs_batch, REPS))
    return {"ms": out, "txs": len(txs), "reps": REPS}


def cell_cpu_plane(ctx: Ctx) -> dict:
    from .crypto import breaker, gpu_verifier
    from .types.validation import verify_commit

    n = VALIDATORS
    vals, bid, commit = ctx.commit(n, True)
    reps = CPU_REPS
    for kt in gpu_verifier.KEY_TYPES:
        breaker.breaker_for(kt).open_now()
    s0 = _stats()
    times = _timed(lambda: verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit), reps)
    s1 = _stats()
    if s1["batches"] != s0["batches"] or s1["faults"] != s0["faults"]:
        raise AssertionError("cpu_plane: an open breaker let a window through")
    return {"validators": n, **_p50_p95(times), "reps": reps}


def cell_vote_ingest(ctx: Ctx) -> dict:
    from .consensus.state import PEER_DRAIN
    from .crypto import sigcache
    from .types.validation import verify_commit
    from .workloads import build_vote_traffic, ingest, vote_state

    out = {"votes_per_s": {}, "votes_per_s_cache_off": {}, "votes": {}}
    for n, n_sr in ((LIGHT_VALIDATORS, 0), (VALIDATORS, VALIDATORS // 2)):
        t = build_vote_traffic(CHAIN_ID, HEIGHT, n, ctx.args.seed + 10, n_sr)

        def once():
            sigcache.reset()
            cs = vote_state(CHAIN_ID, t.vals, HEIGHT)
            t0 = time.perf_counter()
            ingest(cs, t.wires, PEER_DRAIN)
            seconds = time.perf_counter() - t0
            votes = cs.rs.votes
            if not (votes.prevotes(0).has_all() and votes.precommits(0).has_all()):
                raise AssertionError(f"vote_ingest: a vote of {n} validators was not added")
            return len(t.wires) / seconds, votes

        before = _stats()
        once()  # warm-up: the first windows of each bucket, untimed
        rates = []
        for _ in range(VOTE_REPS):
            rate, votes = once()
            rates.append(rate)
        _no_fault(before, "vote_ingest")
        bid, ok = votes.precommits(0).two_thirds_majority()
        if not ok or bid != t.block_id:
            raise AssertionError("vote_ingest: no +2/3 for the block")
        verify_commit(CHAIN_ID, t.vals, bid, HEIGHT, votes.precommits(0).make_commit())
        with sigcache.disabled():
            cold, _votes = once()
        out["votes_per_s"][str(n)] = float(np.mean(rates))
        out["votes_per_s_cache_off"][str(n)] = cold
        out["votes"][str(n)] = len(t.wires)
    sigcache.reset()
    return {**out, "burst": PEER_DRAIN, "reps": VOTE_REPS}


def cell_block_exec(ctx: Ctx) -> dict:
    import asyncio
    import tempfile

    from .workloads import block_exec_node, build_block_chain, kv_genesis, kv_txs, seeded_keys

    seed = ctx.args.seed + 20
    privs = seeded_keys(VALIDATORS, seed, VALIDATORS // 2)
    genesis = kv_genesis(CHAIN_ID, privs)
    t0 = time.perf_counter()
    txs = [kv_txs(seed, h, TXS, (100, 300)) for h in range(1, BLOCK_HEIGHTS + 1)]
    chain = build_block_chain(genesis, privs, txs, seed)
    build_s = time.perf_counter() - t0
    before = _stats()
    rates, applies = [], []
    for rep in range(BLOCK_REPS + 1):  # the first: warm-up, untimed
        with tempfile.TemporaryDirectory(prefix="bench-block-exec-") as tmp:
            node = block_exec_node(genesis, tmp)
            state, spent = node.state, 0.0
            for h, cb in enumerate(chain, start=1):
                node.block_store.save_block(cb.block, cb.parts, cb.seen_commit)
                t0 = time.perf_counter()
                state = asyncio.run(node.executor.apply_block(state, cb.block_id, cb.block))
                ms = (time.perf_counter() - t0) * 1e3
                spent += ms / 1e3
                if rep and h >= 2:
                    applies.append(ms)
                if h < len(chain) and node.app.app_hash != chain[h].block.header.app_hash:
                    raise AssertionError(f"block_exec: the app hash after height {h} differs")
            node.close()
        if rep:
            rates.append(len(chain) / spent)
    _no_fault(before, "block_exec")
    return {
        "blocks_per_s": float(np.mean(rates)),
        **_p50_p95(applies),
        "heights": len(chain),
        "txs": TXS,
        "validators": VALIDATORS,
        "reps": BLOCK_REPS,
        "chain_build_s": build_s,
    }


RUNNERS = {
    "batch_curve": cell_batch_curve,
    "throughput_8192": cell_throughput,
    "commit10k_ed25519": lambda ctx: _cell_commit(ctx, False),
    "commit10k_mixed": lambda ctx: _cell_commit(ctx, True),
    "light150_ed25519": lambda ctx: _cell_light(ctx, False),
    "light150_mixed": lambda ctx: _cell_light(ctx, True),
    "light_sync": cell_light_sync,
    "sign_keygen": cell_sign_keygen,
    "config5_merkle": cell_config5,
    "commit10k_mixed_cpu_plane": cell_cpu_plane,
    "vote_ingest": cell_vote_ingest,
    "block_exec": cell_block_exec,
}


def _nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            check=True,
        ).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def run(args) -> dict:
    """Every cell of args.cells, in CELLS order; the line's object."""
    import torch

    from .config import GPUConfig
    from .node.device import install_device_plane, uninstall_device_plane

    cells = [c for c in CELLS if c in args.cells]
    t_start = time.perf_counter()
    smi = _nvidia_smi() if args.device == "cuda" else None
    if args.device == "cuda" and smi is None:
        raise RuntimeError("nvidia-smi does not answer on a CUDA host")
    ctx = Ctx(args)
    results = {}
    install_device_plane(GPUConfig(), device=args.device)
    try:
        for name in cells:
            _log(f"{name} ...")
            t0 = time.perf_counter()
            results[name] = RUNNERS[name](ctx)
            results[name]["cell_s"] = time.perf_counter() - t0
            _log(f"{name} done in {results[name]['cell_s']:.1f} s")
    finally:
        uninstall_device_plane()
    device = {"platform": "cpu", "kind": "cpu", "count": 0}
    if args.device == "cuda":
        device = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }
    return {
        "bench": "tendermint_tpu_torch",
        "nvidia_smi": smi,
        "device": device,
        "seed": args.seed,
        "cells": results,
        "wall_s": time.perf_counter() - t_start,
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--cells",
        type=lambda s: [c for c in s.split(",") if c],
        default=list(CELLS),
        help=f"comma-separated, of: {','.join(CELLS)}",
    )
    ap.add_argument("--headers", type=int, default=HEADERS, help="light_sync's chain")
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cpu: the kernels' plain versions (small sizes only)",
    )
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    unknown = set(args.cells) - set(CELLS)
    if unknown:
        print(f"bench: unknown cells {sorted(unknown)}", file=sys.stderr)
        return 2
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: CUDA is not available (--device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
