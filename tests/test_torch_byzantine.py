"""The port's Byzantine plane held against the JAX package's.

- the TM_TPU_BYZ grammar (tests/test_byz_plane.py:42-145's cases):
  specs parse to equal rules (behavior, height window, p, seed, times,
  victim, step), a malformed spec raises once in both and leaves both
  disarmed, bad options raise the same errors, seeded rules fire on the
  same consults, and the window, victim, step and times filters answer
  alike;
- the hooks: maybe_install wraps the step machine's decide_proposal,
  do_prevote and _sign_add_vote, as the JAX harness wraps the JAX
  step machine's, and a disarmed process installs nothing;
- a live equivocation on the port's four-validator localnet: the
  victim's second prevote goes to half its peers, the conflict becomes
  DuplicateVoteEvidence, the evidence reactor gossips it, and every node
  commits it in the same block (tests/test_byz_plane.py:169's arc).
Tolerance: zero.
"""

import asyncio

import pytest

from tendermint_tpu.consensus import byzantine as jax_byz
from tendermint_tpu.types.canonical import PRECOMMIT_TYPE as JAX_PRECOMMIT
from tendermint_tpu_torch.consensus import byzantine as port_byz
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

from .test_torch_consensus_reactor import _localnet
from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

SPECS = [
    "equivocate:h=4..7:seed=9:step=precommit;withhold:h=5:p=0.5:times=2:victim=load2",
    "conflicting_proposal:h=2..3:victim=node-c",
    "amnesia:h=1..9:p=0.25:seed=3",
    "withhold:h=5..6;equivocate:h=8..9:step=precommit",
    "equivocate:h=4",
    "",
]
BAD_SPECS = [
    "equivocate:warp=9",
    "equivocate:h",
    "teleport",
    "equivocate:step=commit",
    "equivocate:h=4..6;teleport:h=5",
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TM_TPU_BYZ", raising=False)
    for mod in (port_byz, jax_byz):
        mod.reset()
    yield
    for mod in (port_byz, jax_byz):
        mod.reset()
    monkeypatch.delenv("TM_TPU_BYZ", raising=False)
    for mod in (port_byz, jax_byz):
        mod.load_env()


def _rule_tuple(r) -> tuple:
    return (r.behavior, r.h_lo, r.h_hi, r.p, r.seed, r.times, r.victim, r.step, r.fired)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)


@pytest.mark.parametrize("spec", SPECS)
def test_env_specs_parse_to_equal_rules(monkeypatch, spec):
    monkeypatch.setenv("TM_TPU_BYZ", spec)
    for mod in (port_byz, jax_byz):
        mod.load_env()
    assert port_byz.armed() == jax_byz.armed() == bool(spec)
    assert [_rule_tuple(r) for r in port_byz.rules()] == [_rule_tuple(r) for r in jax_byz.rules()]
    assert [repr(r) for r in port_byz.rules()] == [repr(r) for r in jax_byz.rules()]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_alike(spec):
    assert _outcome(lambda: port_byz._parse_rule(spec.split(";")[-1])) == _outcome(
        lambda: jax_byz._parse_rule(spec.split(";")[-1]))
    assert _outcome(lambda: port_byz._parse_rule(spec.split(";")[-1]))[0] == "ValueError"


def test_malformed_env_spec_raises_once_then_both_disarmed(monkeypatch):
    monkeypatch.setenv("TM_TPU_BYZ", "equivocate:h=4..6;teleport:h=5")
    for mod in (port_byz, jax_byz):
        monkeypatch.setattr(mod, "_ENV_LOADED", False)
        with pytest.raises(ValueError) as err:
            mod.armed()
        assert "teleport" in str(err.value)
        assert not mod.armed()  # latched: no second raise
        assert mod.rules() == []
    monkeypatch.setenv("TM_TPU_BYZ", "equivocate:h=4..6")
    for mod in (port_byz, jax_byz):
        mod.load_env()
        assert mod.armed()


def test_bad_rule_arguments_raise_alike():
    for kwargs in ({"behavior": "teleport"}, {"behavior": "equivocate", "step": "commit"}):
        assert _outcome(lambda: port_byz.ByzRule(**kwargs)) == _outcome(lambda: jax_byz.ByzRule(**kwargs))


@pytest.mark.parametrize("seed", [7, 8, 41])
def test_seeded_rules_fire_on_the_same_consults(seed):
    def pattern(mod, vote_type):
        fired = []
        with mod.inject("equivocate", h_lo=1, p=0.5, seed=seed) as rule:
            for i in range(60):
                if mod._plan("equivocate", 5, "load1", vote_type) is not None:
                    fired.append(i)
            assert rule.fired == len(fired)
        return fired

    port, jax = pattern(port_byz, PREVOTE_TYPE), pattern(jax_byz, PREVOTE_TYPE)
    assert port == jax and port
    assert port_byz.consults() == jax_byz.consults() == 60


def test_window_victim_step_and_times_filters_alike():
    consults = [
        ("equivocate", 3, "load1", None), ("equivocate", 7, "load1", None),
        ("equivocate", 5, "load0", None), ("equivocate", 5, "load1", PREVOTE_TYPE),
        ("equivocate", 5, "load1", PRECOMMIT_TYPE), ("equivocate", 5, "load1", PRECOMMIT_TYPE),
        ("withhold", 5, "load1", PRECOMMIT_TYPE),
    ]
    got = {}
    for mod in (port_byz, jax_byz):
        with mod.inject("equivocate", h_lo=4, h_hi=6, step="precommit", times=1):
            got[mod] = [mod._plan(*c) is not None for c in consults]
        assert not mod.armed()
    assert got[port_byz] == got[jax_byz] == [False, False, False, False, True, False, False]
    assert PRECOMMIT_TYPE == JAX_PRECOMMIT


def test_harness_wraps_the_step_machine_hooks():
    """maybe_install on a stand-in step machine and reactor: the three
    seams are replaced by the harness's, the originals kept; a victim
    with no matching rule gets no harness."""

    class _Key:
        priv_key = object()

    class _CS:
        privval = type("PV", (), {"key": _Key()})()

        async def _sign_add_vote(self, *a):
            return None

        async def do_prevote(self, *a):
            return None

        async def decide_proposal(self, *a):
            return None

    cs = _CS()
    originals = (cs._sign_add_vote, cs.do_prevote, cs.decide_proposal)
    assert port_byz.maybe_install(cs, object(), "node-c") is None
    with port_byz.inject("withhold", victim="node-c"):
        h = port_byz.maybe_install(cs, object(), "node-c")
    assert h is not None and port_byz.harnesses() == [h]
    assert (h._orig_sign_add_vote, h._orig_do_prevote, h._orig_decide_proposal) == originals
    assert cs._sign_add_vote == h._byz_sign_add_vote
    assert cs.do_prevote == h._byz_do_prevote
    assert cs.decide_proposal == h._byz_decide_proposal


def test_live_equivocation_commits_evidence_on_the_port_localnet():
    installed = []

    def byz(nodes):
        victim = nodes[1]
        installed.append(port_byz.maybe_install(victim.cs, victim.cs_reactor, "node1"))
        installed.append(victim)

    with port_byz.inject("equivocate", h_lo=2, h_hi=3, step="prevote", victim="node1"):
        nodes = asyncio.run(_localnet("port", heights=5, byz=byz))
    harness, victim = installed
    assert [f[0] for f in harness.fired] == ["equivocate", "equivocate"]
    addr = victim.cs.privval.priv_key.pub_key().address()
    found = {}
    for n in nodes:
        for h in range(1, n.block_store.height() + 1):
            for ev in n.block_store.load_block(h).evidence:
                assert isinstance(ev, DuplicateVoteEvidence)
                found.setdefault(ev.hash(), set()).add((h, ev.vote_a.validator_address == addr))
    assert found, "no evidence committed"
    heights = {ev_h for seen in found.values() for ev_h, _ in seen}
    for seen in found.values():
        assert all(named for _, named in seen)
    # each evidence item committed at one height, by every node holding it
    for h in heights:
        assert len({n.block_store.load_block(h).hash() for n in nodes if n.block_store.height() >= h}) == 1
