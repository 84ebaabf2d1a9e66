"""The Byzantine adversary plane: seeded, switchable misbehavior.

Counterpart: tendermint_tpu/consensus/byzantine.py:1-520. Up to a third
of the voting power may lie, and the evidence pipeline (a VoteSet's
conflict, DuplicateVoteEvidence, the pool, evidence gossip, a block
carrying it) earns its keep only against a validator that equivocates
on purpose. This module makes one named validator misbehave on a seeded
schedule, behind the armed() / env-spec / inject() contract of
crypto/faults.py. Behaviors:

    equivocate            after the victim signs its honest vote A, a
                          ByzantinePrivVal (no double-sign protection)
                          signs a second vote B at the same height,
                          round and type for a made-up block and sends
                          it straight to half the peer set; honest
                          gossip spreads A everywhere, so the targeted
                          half holds conflicting votes and raises
                          ConflictingVoteError, which becomes evidence.
    conflicting_proposal  when the victim proposes, a second signed
                          Proposal for a made-up BlockID follows the
                          honest one to half the peers.
    amnesia               at round > 0 the victim forgets its lock
                          before prevoting (no duplicate-vote evidence:
                          the rounds differ).
    withhold              the victim signs nothing in the window.

Rules use the crypto/faults.py grammar, armed through TM_TPU_BYZ:

    TM_TPU_BYZ="equivocate:h=4..7:seed=7:victim=load1"
    TM_TPU_BYZ="withhold:h=5..6;equivocate:h=8..9:step=precommit"

`behavior[:h=LO..HI][:p=..][:seed=..][:times=..][:victim=..][:step=..]`;
`victim` names the node's moniker (default load1), `step` restricts
equivocation and withholding to prevote or precommit. Every rule owns a
random.Random(seed) advanced once a matching consult, so the schedule is
a function of (seed, consult index). A disarmed process installs no hook
and consults no rule (consults() stays 0). The victim's own signer
(FilePV) keeps its double-sign protection: only the ByzantinePrivVal, a
MockPV, signs the conflicting messages.

The hooks are the step machine's `decide_proposal`, `do_prevote` and
`_sign_add_vote` (consensus/state.py), wrapped as the JAX harness wraps
them (:400-408); the duplicates go out through the victim's consensus
reactor channels. No device call runs here.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import threading
from typing import List, Optional

from ..p2p.types import Envelope
from ..privval.types import MockPV
from ..types.block_id import BlockID, PartSetHeader
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.proposal import Proposal
from ..types.vote import Vote
from .msgs import ProposalMessage, VoteMessage

__all__ = [
    "BEHAVIORS",
    "ByzRule",
    "ByzantineHarness",
    "ByzantinePrivVal",
    "armed",
    "consults",
    "harnesses",
    "inject",
    "load_env",
    "maybe_install",
    "reset",
    "rules",
]

logger = logging.getLogger(__name__)

BEHAVIORS = frozenset(
    {"equivocate", "conflicting_proposal", "amnesia", "withhold"}
)

# fabricated BlockID the evil votes/proposals point at — can never
# collide with a real block hash (blocks hash through SHA-256 merkle)
EVIL_BLOCK_ID = BlockID(
    hash=b"\xde" * 32,
    part_set_header=PartSetHeader(total=1, hash=b"\xad" * 32),
)

_STEPS = {"prevote": PREVOTE_TYPE, "precommit": PRECOMMIT_TYPE}


class ByzRule:
    """One armed misbehavior: a behavior, a height window, a victim
    moniker, and a seeded RNG that decides — reproducibly — which
    consults fire."""

    def __init__(
        self,
        behavior: str,
        h_lo: int = 1,
        h_hi: Optional[int] = None,
        p: float = 1.0,
        seed: int = 0,
        times: Optional[int] = None,
        victim: str = "load1",
        step: Optional[str] = None,
    ) -> None:
        if behavior not in BEHAVIORS:
            raise ValueError(f"unknown byzantine behavior {behavior!r}")
        if step is not None and step not in _STEPS:
            raise ValueError(f"unknown byzantine step {step!r}")
        self.behavior = behavior
        self.h_lo = int(h_lo)
        self.h_hi = int(h_hi) if h_hi is not None else None
        self.p = float(p)
        self.seed = int(seed)
        self.times = times  # None = unlimited
        self.victim = victim
        self.step = step  # prevote/precommit filter (None = both)
        self.rng = random.Random(self.seed)
        self.fired = 0  # consults that actually misbehaved

    def matches(
        self, behavior: str, height: int, vote_type: Optional[int] = None
    ) -> bool:
        if self.behavior != behavior:
            return False
        if height < self.h_lo:
            return False
        if self.h_hi is not None and height > self.h_hi:
            return False
        if (
            self.step is not None
            and vote_type is not None
            and _STEPS[self.step] != vote_type
        ):
            return False
        return True

    def _roll(self) -> bool:
        """One seeded decision. The RNG advances on every matching
        consult — fired or not — so the misbehavior pattern depends
        only on (seed, consult index), never on wall time (same
        contract as crypto/faults.py Rule._roll)."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p < 1.0 and self.rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def __repr__(self) -> str:  # failure messages name the seed
        hi = "inf" if self.h_hi is None else self.h_hi
        return (
            f"ByzRule({self.behavior}:h={self.h_lo}..{hi} p={self.p} "
            f"seed={self.seed} victim={self.victim} fired={self.fired})"
        )


_RULES: List[ByzRule] = []
_LOCK = threading.Lock()
_ARMED = False  # mirrors bool(_RULES); read lock-free at assembly
_ENV_LOADED = False
_CONSULTS = 0  # every rule-list consult; 0 while disarmed (pinned)
# installed harnesses, for scenario runners to read fired logs.
# one per victim node (maybe_install appends when a node is assembled),
# cleared by reset()
_HARNESSES: List["ByzantineHarness"] = []


def armed() -> bool:
    """Cheap assembly-time gate: False means no rule is armed and no
    byzantine code is installed at all. The env var is parsed on the
    first call so test processes that set TM_TPU_BYZ after import
    still arm (same latch ordering as crypto/faults.py armed())."""
    if not _ENV_LOADED:
        load_env()
    return _ARMED


def load_env() -> None:
    """(Re-)parse TM_TPU_BYZ into armed rules. Idempotent per value:
    clears previously env-loaded rules first (inject() rules survive).
    A malformed spec raises ONCE — the latch and _ARMED refresh run in
    the finally so the plane then stays disarmed instead of re-raising
    from every armed() check."""
    global _ENV_LOADED
    spec = os.environ.get("TM_TPU_BYZ", "")
    with _LOCK:
        _RULES[:] = [r for r in _RULES if not getattr(r, "_from_env", False)]
        try:
            parsed = []
            for part in spec.split(";"):
                part = part.strip()
                if not part:
                    continue
                rule = _parse_rule(part)
                rule._from_env = True
                parsed.append(rule)
            # all-or-nothing: a spec that fails mid-list arms none
            _RULES.extend(parsed)
        finally:
            _refresh_armed()
            _ENV_LOADED = True


def _parse_rule(spec: str) -> ByzRule:
    """`behavior[:h=LO..HI][:p=..][:seed=..][:times=..][:victim=..]
    [:step=..]` — `h=N` pins a single height."""
    fields = spec.split(":")
    kwargs = {}
    for opt in fields[1:]:
        if "=" not in opt:
            raise ValueError(f"bad TM_TPU_BYZ option {opt!r} in {spec!r}")
        k, v = opt.split("=", 1)
        if k == "h":
            lo, _, hi = v.partition("..")
            kwargs["h_lo"] = int(lo)
            kwargs["h_hi"] = int(hi) if hi else int(lo)
        elif k == "p":
            kwargs["p"] = float(v)
        elif k == "seed":
            kwargs["seed"] = int(v)
        elif k == "times":
            kwargs["times"] = int(v)
        elif k == "victim":
            kwargs["victim"] = v
        elif k == "step":
            kwargs["step"] = v
        else:
            raise ValueError(f"unknown byzantine option {k!r} in {spec!r}")
    return ByzRule(fields[0], **kwargs)


def _refresh_armed() -> None:
    global _ARMED
    _ARMED = bool(_RULES)


@contextlib.contextmanager
def inject(
    behavior: str,
    h_lo: int = 1,
    h_hi: Optional[int] = None,
    p: float = 1.0,
    seed: int = 0,
    times: Optional[int] = None,
    victim: str = "load1",
    step: Optional[str] = None,
):
    """Arm one rule for the duration of the scope (byzantine tests).
    Yields the ByzRule so the test can assert how often it fired. Note
    hooks are installed when a node is assembled: arm before that."""
    rule = ByzRule(behavior, h_lo=h_lo, h_hi=h_hi, p=p, seed=seed,
                   times=times, victim=victim, step=step)
    with _LOCK:
        _RULES.append(rule)
        _refresh_armed()
    try:
        yield rule
    finally:
        with _LOCK:
            try:
                _RULES.remove(rule)
            except ValueError:  # pragma: no cover - double-removal
                pass
            _refresh_armed()


def reset() -> None:
    """Disarm everything — rules, harness registry, consult counter
    (tests). Installed hooks on still-running nodes become inert (their
    consults find no rules) but are not unwrapped; stop the nodes."""
    global _CONSULTS
    with _LOCK:
        _RULES.clear()
        _HARNESSES.clear()
        _CONSULTS = 0
        _refresh_armed()


def rules() -> List[ByzRule]:
    """Snapshot of the armed rules (diagnostics/tests)."""
    with _LOCK:
        return list(_RULES)


def consults() -> int:
    """How many times an installed hook consulted the rule list. The
    zero-overhead contract: a disarmed process never installs a hook,
    so this stays 0."""
    with _LOCK:
        return _CONSULTS


def harnesses() -> List["ByzantineHarness"]:
    """Snapshot of installed harnesses (scenario runners read the
    per-victim fired logs for accountability verdicts)."""
    with _LOCK:
        return list(_HARNESSES)


def _plan(
    behavior: str,
    height: int,
    victim: str,
    vote_type: Optional[int] = None,
) -> Optional[ByzRule]:
    """Consult the rule list at a misbehavior point. Returns the fired
    rule (first match wins) or None. Only installed hooks call this,
    so the disarmed consult count is exactly 0."""
    global _CONSULTS
    with _LOCK:
        _CONSULTS += 1
        for r in _RULES:
            if r.victim != victim:
                continue
            if not r.matches(behavior, height, vote_type):
                continue
            if not r._roll():
                continue
            return r
    return None


class ByzantinePrivVal(MockPV):
    """The adversary's signer: a MockPV over the victim's REAL key,
    counting signatures. Deliberately no last-sign-state — producing a
    conflicting signature at an already-signed HRS is its entire job.
    The victim's FilePV is untouched; this signer only ever signs the
    harness's fabricated votes/proposals."""

    def __init__(self, priv_key) -> None:
        super().__init__(priv_key)
        self.signed_votes = 0
        self.signed_proposals = 0

    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        self.signed_votes += 1
        await super().sign_vote(chain_id, vote)

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        self.signed_proposals += 1
        await super().sign_proposal(chain_id, proposal)


class ByzantineHarness:
    """Installed hooks on ONE victim node: wraps the consensus state's
    overridable seams (decide_proposal/do_prevote, the state.go
    function-field pattern) plus _sign_add_vote, and sends the evil
    duplicates through the victim's own reactor channels to a
    deterministic half of the peer set."""

    def __init__(self, cs, reactor, moniker: str) -> None:
        self.cs = cs
        self.reactor = reactor
        self.moniker = moniker
        self.signer: Optional[ByzantinePrivVal] = None
        # (behavior, height, round, vote_type) per misbehavior, read by
        # a run's accountability verdict; bounded by the rules' height
        # windows and times caps
        self.fired: List[tuple] = []
        self._orig_sign_add_vote = None
        self._orig_do_prevote = None
        self._orig_decide_proposal = None

    # -- install ---------------------------------------------------------

    def install(self) -> None:
        key = getattr(self.cs.privval, "key", None)
        priv_key = (
            key.priv_key if key is not None
            else getattr(self.cs.privval, "priv_key", None)
        )
        if priv_key is None:  # pragma: no cover - no signer to steal
            logger.error("byzantine install: victim %s has no priv key", self.moniker)
            return
        self.signer = ByzantinePrivVal(priv_key)
        self._orig_sign_add_vote = self.cs._sign_add_vote
        self._orig_do_prevote = self.cs.do_prevote
        self._orig_decide_proposal = self.cs.decide_proposal
        self.cs._sign_add_vote = self._byz_sign_add_vote
        self.cs.do_prevote = self._byz_do_prevote
        self.cs.decide_proposal = self._byz_decide_proposal
        logger.info("byzantine harness installed (victim=%s, rules=%s)", self.moniker,
                    [repr(r) for r in rules()])

    # -- targeted sends --------------------------------------------------

    def _target_peers(self) -> List[str]:
        """The lexicographically-first half of the connected peers —
        the disjoint subset that receives the conflicting message while
        honest gossip carries the real one everywhere."""
        peers = sorted(self.reactor.peers)
        return peers[: max(1, len(peers) // 2)] if peers else []

    # -- hooks -----------------------------------------------------------

    async def _byz_sign_add_vote(self, msg_type, hash_, header):
        """equivocate + withhold seam: runs instead of the victim's
        _sign_add_vote for BOTH prevotes and precommits."""
        cs = self.cs
        height = cs.rs.height
        if _plan("withhold", height, self.moniker, msg_type) is not None:
            self.fired.append(("withhold", height, cs.rs.round, msg_type))
            logger.info("byzantine: withholding vote %d/%d type %d", height, cs.rs.round, msg_type)
            return None
        vote = await self._orig_sign_add_vote(msg_type, hash_, header)
        if vote is None:
            return None
        rule = _plan("equivocate", height, self.moniker, msg_type)
        if rule is not None:
            await self._send_equivocation(vote, rule)
        return vote

    async def _send_equivocation(self, vote: Vote, rule: ByzRule) -> None:
        evil = Vote(
            type=vote.type,
            height=vote.height,
            round=vote.round,
            block_id=EVIL_BLOCK_ID,
            timestamp_ns=vote.timestamp_ns,
            validator_address=vote.validator_address,
            validator_index=vote.validator_index,
        )
        await self.signer.sign_vote(self.cs.state.chain_id, evil)
        targets = self._target_peers()
        for pid in targets:
            self.reactor.vote_ch.try_send(
                Envelope(message=VoteMessage(vote=evil), to=pid)
            )
        self.fired.append(
            ("equivocate", vote.height, vote.round, vote.type)
        )
        logger.info(
            "byzantine: equivocated %d/%d type %d (seed=%d, targets=%d)",
            vote.height, vote.round, vote.type, rule.seed, len(targets),
        )

    async def _byz_do_prevote(self, height, round_):
        """amnesia seam: forget the lock before prevoting."""
        cs = self.cs
        if (
            round_ > 0
            and cs.rs.locked_block is not None
            and _plan("amnesia", height, self.moniker) is not None
        ):
            self.fired.append(("amnesia", height, round_, PREVOTE_TYPE))
            logger.info("byzantine: amnesia, dropping the lock of round %d at %d/%d",
                        cs.rs.locked_round, height, round_)
            cs.rs.locked_block = None
            cs.rs.locked_block_parts = None
            cs.rs.locked_round = -1
        await self._orig_do_prevote(height, round_)

    async def _byz_decide_proposal(self, height, round_):
        """conflicting_proposal seam: a second signed proposal chases
        the honest one to half the peers."""
        await self._orig_decide_proposal(height, round_)
        rule = _plan("conflicting_proposal", height, self.moniker)
        if rule is None:
            return
        cs = self.cs
        evil = Proposal(
            height=height,
            round=round_,
            pol_round=cs.rs.valid_round,
            block_id=EVIL_BLOCK_ID,
        )
        await self.signer.sign_proposal(cs.state.chain_id, evil)
        targets = self._target_peers()
        for pid in targets:
            self.reactor.data_ch.try_send(
                Envelope(message=ProposalMessage(proposal=evil), to=pid)
            )
        self.fired.append(("conflicting_proposal", height, round_, None))
        logger.info("byzantine: conflicting proposal sent %d/%d (targets=%d)",
                    height, round_, len(targets))


def maybe_install(cs, reactor, moniker: str) -> Optional[ByzantineHarness]:
    """Install misbehavior hooks when a rule names this node as victim.
    Called once as a node is assembled, after its consensus reactor exists;
    a disarmed process (armed() False) never reaches this. Returns the
    harness, or None when this node is honest."""
    with _LOCK:
        mine = [r for r in _RULES if r.victim == moniker]
    if not mine:
        return None
    harness = ByzantineHarness(cs, reactor, moniker)
    harness.install()
    with _LOCK:
        _HARNESSES.append(harness)
    return harness
