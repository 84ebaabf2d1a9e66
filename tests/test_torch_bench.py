"""The port's bench entry point, in-process on the CPU at tiny sizes.

`python3 -m tendermint_tpu_torch.bench --device cpu`, its size
constants set small: the batch_curve at 1 and 8 signatures (the native CPU plane, below the
min-batch gate), one 4-validator light commit, and a 34-header
light_sync (two merged windows through the device verifier's plain
versions, then the same chain a commit at a time), and the keygen and
signing times of each key type: the one line it
prints parses, carries every key its cells declare, and its numbers are
positive and finite. Without CUDA and without --device cpu it exits 2
and prints nothing.
"""

import json
import math

import pytest
import torch

from tendermint_tpu_torch import bench

ARGS = [
    "--device", "cpu",
    "--cells", "batch_curve,light150_ed25519,light_sync,sign_keygen",
    "--headers", "34",
]


def _numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield obj


def test_bench_prints_one_line_with_every_key(capsys, monkeypatch):
    monkeypatch.setattr(bench, "CURVE_SIZES", (1, 8))
    monkeypatch.setattr(bench, "LIGHT_VALIDATORS", 4)
    assert bench.main(ARGS) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert line["nvidia_smi"] is None and line["seed"] == 0
    cells = line["cells"]
    assert sorted(cells) == ["batch_curve", "light150_ed25519", "light_sync", "sign_keygen"]
    for name, cell in cells.items():
        assert set(cell) == set(bench.CELL_KEYS[name]) | {"cell_s"}, name
    curve = cells["batch_curve"]["us_per_sig"]
    assert sorted(curve) == ["ed25519", "sr25519"]
    assert all(sorted(c) == ["1", "8"] for c in curve.values())
    sync = cells["light_sync"]
    assert sync["headers"] == 34 and sync["validators"] == 4
    assert sync["reduced"] is None and sorted(sync["headers_per_s"]) == ["merged", "per_commit"]
    assert sorted(cells["sign_keygen"]["us"]) == ["ed25519", "sr25519"]
    assert all(math.isfinite(x) and x >= 0 for x in _numbers(line))
    assert line["wall_s"] > 0


def test_bench_without_cuda_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    assert bench.main(["--cells", "batch_curve"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err


def test_bench_vote_ingest_cell(capsys, monkeypatch):
    """The vote_ingest cell at 6 ed25519 and 8 mixed validators (below
    the min-batch gate: the native CPU plane): every key it declares,
    each size's votes counted and its rates positive."""
    monkeypatch.setattr(bench, "LIGHT_VALIDATORS", 6)
    monkeypatch.setattr(bench, "VALIDATORS", 8)
    monkeypatch.setattr(bench, "VOTE_REPS", 2)
    assert bench.main(["--device", "cpu", "--cells", "vote_ingest"]) == 0
    cell = json.loads(capsys.readouterr().out)["cells"]["vote_ingest"]
    assert set(cell) == set(bench.CELL_KEYS["vote_ingest"]) | {"cell_s"}
    assert cell["votes"] == {"6": 12, "8": 16}
    assert cell["burst"] == 256 and cell["reps"] == 2
    for key in ("votes_per_s", "votes_per_s_cache_off"):
        assert sorted(cell[key]) == ["6", "8"]
        assert all(math.isfinite(x) and x > 0 for x in cell[key].values())


def test_bench_block_exec_cell(capsys, monkeypatch):
    """The block_exec cell at 8 mixed validators and 40 transactions a
    block (the native CPU plane below the gate): every key it declares,
    its rates and times positive."""
    monkeypatch.setattr(bench, "VALIDATORS", 8)
    monkeypatch.setattr(bench, "TXS", 40)
    monkeypatch.setattr(bench, "BLOCK_REPS", 2)
    assert bench.main(["--device", "cpu", "--cells", "block_exec"]) == 0
    cell = json.loads(capsys.readouterr().out)["cells"]["block_exec"]
    assert set(cell) == set(bench.CELL_KEYS["block_exec"]) | {"cell_s"}
    assert (cell["heights"], cell["txs"], cell["validators"], cell["reps"]) == (3, 40, 8, 2)
    for key in ("blocks_per_s", "p50_ms", "p95_ms", "chain_build_s"):
        assert math.isfinite(cell[key]) and cell[key] > 0


def test_bench_consensus_height_cell(capsys, monkeypatch):
    """The consensus_height cell at 8 mixed validators and 40
    transactions a block (the native CPU plane below the gate): every key
    it declares, each height in round 0, its rates and times positive."""
    monkeypatch.setattr(bench, "VALIDATORS", 8)
    monkeypatch.setattr(bench, "TXS", 40)
    monkeypatch.setattr(bench, "CONSENSUS_HEIGHTS", 3)
    monkeypatch.setattr(bench, "CONSENSUS_REPS", 1)
    assert bench.main(["--device", "cpu", "--cells", "consensus_height"]) == 0
    cell = json.loads(capsys.readouterr().out)["cells"]["consensus_height"]
    assert set(cell) == set(bench.CELL_KEYS["consensus_height"]) | {"cell_s"}
    assert (cell["heights"], cell["txs"], cell["validators"], cell["reps"]) == (3, 40, 8, 1)
    for key in ("heights_per_s", "p50_ms", "p95_ms", "p50_through_apply_ms", "chain_build_s"):
        assert math.isfinite(cell[key]) and cell[key] > 0


def test_bench_mempool_proposer_cell(capsys, monkeypatch):
    """The mempool_proposer cell at 8 mixed validators and 40
    transactions gossiped to the node that proposes (the native CPU
    plane below the gate): every key it declares, the own block the
    gossiped txs, each height in round 0, its rates and times positive."""
    monkeypatch.setattr(bench, "VALIDATORS", 8)
    monkeypatch.setattr(bench, "TXS", 40)
    monkeypatch.setattr(bench, "CONSENSUS_REPS", 2)
    monkeypatch.setattr(bench, "MEMPOOL_TIMEOUT_COMMIT_S", 0.2)
    assert bench.main(["--device", "cpu", "--cells", "mempool_proposer"]) == 0
    cell = json.loads(capsys.readouterr().out)["cells"]["mempool_proposer"]
    assert set(cell) == set(bench.CELL_KEYS["mempool_proposer"]) | {"cell_s"}
    assert (cell["txs"], cell["validators"], cell["reps"]) == (40, 8, 2)
    assert cell["heights"] == cell["proposer_height"] + 1 >= 3
    for key in ("admission_txs_per_s", "gossip_txs_per_s", "p50_ms", "p95_ms", "chain_build_s"):
        assert math.isfinite(cell[key]) and cell[key] > 0
