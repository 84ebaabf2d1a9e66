"""Manifest-driven end-to-end testnets (counterpart:
tendermint_tpu/e2e/__init__.py; reference: test/e2e/). TOML manifests
describe networks; the in-process runner (runner.py) runs their
setup, start, load, perturb, wait, test and benchmark phases over real
port Nodes on a MemoryNetwork, the process runner (process_runner.py)
over `start` processes and TCP, and a seeded generator permutes
manifests."""

from .generator import generate
from .manifest import LoadSpec, Manifest, NodeSpec, Perturbation
from .runner import Runner, RunReport, run_manifest

__all__ = [
    "generate",
    "LoadSpec",
    "Manifest",
    "NodeSpec",
    "Perturbation",
    "Runner",
    "RunReport",
    "run_manifest",
]
