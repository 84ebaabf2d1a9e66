"""Light client: verify headers without executing the chain.

Counterpart: tendermint_tpu/light/client.py, whole (reference:
light/client.go): the operator's trust root, sequential and skipping
(bisection) verification, backwards verification, divergence detection
against witnesses, primary failover and store pruning.

The sequential sync verifies min(SEQUENTIAL_BATCH_HOPS,
crypto.batch.group_affinity()) hops at a time: the window's interim
blocks are fetched together, every header check runs in hop order on
the host, then every commit's signatures go to the verifier as one
merged batch. With crypto/gpu_verifier installed on the card (affinity
32) that is one device window of 32 light commits (3,232 ed25519
signatures at 150 equal-power validators, two 2048-wide windows) where
the hop-at-a-time form pays a device round trip a header. When a window
fails, its hops are fetched and verified again one at a time, for the
reference's error at the failing height and the store it leaves.

ERRORS. A window is re-run hop by hop only for what a header or commit
check raises (light.verifier.CHECK_ERRORS) and for the light errors,
fetch failures included (LightClientError); any other error raises to
the caller unchanged, so a failed kernel launch is neither reported as a
bad header nor quietly re-run. The JAX package catches every exception
there. Provider calls are the boundary where a fetch may fail in any
way, and there, as in the JAX package, any error moves on to the next
provider or to the per-height fetch.

The client is async, as the JAX package's is; a device gather blocks
inside the coroutine, with no executor.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import List, Optional

from ..crypto.batch import group_affinity
from ..types.evidence import LightClientAttackEvidence
from ..types.light import LightBlock
from ..types.validation import Fraction
from .errors import (
    DivergenceError,
    InvalidHeaderError,
    LightClientError,
    NewValSetCantBeTrustedError,
    NoWitnessesError,
)
from .provider import Provider
from .store import LightStore
from .verifier import (
    CHECK_ERRORS,
    DEFAULT_TRUST_LEVEL,
    MAX_CLOCK_DRIFT_NS,
    header_expired,
    verify,
    verify_adjacent_batch,
    verify_backwards,
)

__all__ = ["Client", "SEQUENTIAL_BATCH_HOPS", "TrustOptions"]

_log = logging.getLogger(__name__)

_DEFAULT_PRUNING_SIZE = 1000  # reference: client.go defaultPruningSize

# The most hops a sequential window merges into one batch; the window is
# min(this, crypto.batch.group_affinity()).
SEQUENTIAL_BATCH_HOPS = 32


@dataclass
class TrustOptions:
    """The operator's trust root; `period_ns` should be well below the
    chain's unbonding period."""

    period_ns: int
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period_ns <= 0:
            raise ValueError("trusting period must be positive")
        if self.height <= 0:
            raise ValueError("trust height must be positive")
        if len(self.hash) != 32:
            raise ValueError("trust hash must be 32 bytes")


class Client:
    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: List[Provider],
        store: LightStore,
        sequential: bool = False,
        trust_level: Fraction = DEFAULT_TRUST_LEVEL,
        max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
        pruning_size: int = _DEFAULT_PRUNING_SIZE,
    ) -> None:
        trust_options.validate()
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store
        self.sequential = sequential
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.pruning_size = pruning_size
        self._initialized = False

    # -- setup

    async def initialize(self, now_ns: Optional[int] = None) -> None:
        """Fetch and pin the trust root's light block, or resume from a
        stored one that matches it."""
        if self._initialized:
            return
        now_ns = now_ns if now_ns is not None else time.time_ns()
        existing = self.store.light_block(self.trust_options.height)
        if existing is not None:
            if existing.signed_header.hash() != self.trust_options.hash:
                raise LightClientError(
                    "stored light block at trust height does not match "
                    "the configured trust hash"
                )
            self._initialized = True
            return
        lb = await self._from_primary(self.trust_options.height)
        lb.validate_basic(self.chain_id)
        if lb.signed_header.hash() != self.trust_options.hash:
            raise LightClientError(
                f"trusted header hash mismatch at height "
                f"{self.trust_options.height}: got "
                f"{lb.signed_header.hash().hex()[:16]}, want "
                f"{self.trust_options.hash.hex()[:16]}"
            )
        if header_expired(
            lb.signed_header, self.trust_options.period_ns, now_ns
        ):
            raise LightClientError("trust-root header is already expired")
        self.store.save_light_block(lb)
        self._initialized = True

    # -- public verification API

    async def verify_light_block_at_height(
        self, height: int, now_ns: Optional[int] = None
    ) -> LightBlock:
        await self.initialize(now_ns)
        now_ns = now_ns if now_ns is not None else time.time_ns()
        stored = self.store.light_block(height) if height > 0 else None
        if stored is not None:
            return stored
        latest = self.store.latest_light_block()
        if height == 0 or (latest is not None and height > latest.height):
            return await self._verify_forwards(height, now_ns)
        first = self.store.first_light_block()
        if first is not None and height < first.height:
            return await self._verify_backwards_to(height)
        # between stored blocks: forwards from the closest one below
        return await self._verify_forwards(height, now_ns)

    async def update(self, now_ns: Optional[int] = None) -> Optional[LightBlock]:
        """Verify the primary's latest header; None when it is not newer
        than the latest trusted one."""
        await self.initialize(now_ns)
        now_ns = now_ns if now_ns is not None else time.time_ns()
        latest_primary = await self._from_primary(0)
        latest_trusted = self.store.latest_light_block()
        if (
            latest_trusted is not None
            and latest_primary.height <= latest_trusted.height
        ):
            return None
        return await self._verify_forwards(
            latest_primary.height, now_ns, target=latest_primary
        )

    def trusted_light_block(self, height: int) -> Optional[LightBlock]:
        return self.store.light_block(height)

    # -- forwards (sequential or skipping)

    async def _verify_forwards(
        self,
        height: int,
        now_ns: int,
        target: Optional[LightBlock] = None,
    ) -> LightBlock:
        trusted = self.store.light_block_before(height + 1)
        if trusted is None:
            raise LightClientError("no trusted state to verify from")
        if header_expired(
            trusted.signed_header, self.trust_options.period_ns, now_ns
        ):
            raise LightClientError(
                "closest trusted header is outside the trusting period"
            )
        if target is None:
            target = await self._from_primary(height)
            target.validate_basic(self.chain_id)
        if self.sequential:
            verified = await self._verify_sequential(trusted, target, now_ns)
        else:
            verified = await self._verify_skipping(trusted, target, now_ns)
        await self._detect_divergence(verified, now_ns)
        self.store.save_light_block(verified)
        self.store.prune(self.pruning_size)
        return verified

    async def _verify_sequential(
        self, trusted: LightBlock, target: LightBlock, now_ns: int
    ) -> LightBlock:
        """Every header from trusted to target, in windows (module
        docstring); window 1 is the reference's hop-at-a-time loop."""
        window = max(1, min(SEQUENTIAL_BATCH_HOPS, group_affinity()))
        if window == 1:
            cur = trusted
            for h in range(trusted.height + 1, target.height):
                interim = await self._from_primary(h)
                interim.validate_basic(self.chain_id)
                self._verify_hop(cur, interim, now_ns)
                self.store.save_light_block(interim)
                cur = interim
            self._verify_hop(cur, target, now_ns)
            return target
        cur = trusted
        while cur.height < target.height:
            first = cur.height + 1
            last = min(first + window - 1, target.height)
            try:
                chunk = await self._fetch_range(
                    first, min(last, target.height - 1)
                )
                if last == target.height:
                    chunk.append(target)
                for b in chunk:
                    if b.height < target.height:
                        b.validate_basic(self.chain_id)
                verify_adjacent_batch(
                    self.chain_id,
                    cur.signed_header,
                    chunk,
                    self.trust_options.period_ns,
                    now_ns,
                    self.max_clock_drift_ns,
                )
            except (*CHECK_ERRORS, LightClientError) as e:
                # fetch and verify the window again a hop at a time: the
                # first failing height raises its own error, with every
                # hop before it verified and stored. Logged, so that a
                # path where every window falls back shows.
                _log.info(
                    "sequential window fell back to per-hop verify "
                    "first=%d last=%d err=%r",
                    first,
                    last,
                    e,
                )
                for h in range(first, last + 1):
                    if h == target.height:
                        interim = target
                    else:
                        interim = await self._from_primary(h)
                        interim.validate_basic(self.chain_id)
                    self._verify_hop(cur, interim, now_ns)
                    if h < target.height:
                        self.store.save_light_block(interim)
                    cur = interim
                continue
            for b in chunk:
                if b.height < target.height:
                    self.store.save_light_block(b)
            cur = chunk[-1]
        return target

    async def _fetch_range(self, first: int, last: int) -> List[LightBlock]:
        """Heights first..last, ascending: one bulk fetch from the
        primary, or, when that fails or returns other heights, a fetch a
        height with failover to the witnesses."""
        if last < first:
            return []
        try:
            got = list(await self.primary.light_blocks(first, last))
            if [b.height for b in got] == list(range(first, last + 1)):
                return got
            _log.info(
                "bulk light_blocks returned wrong heights; refetching "
                "primary=%s first=%d last=%d",
                self.primary.id(),
                first,
                last,
            )
        except Exception as e:  # a provider may fail any way: refetch
            _log.info(
                "bulk light_blocks fetch failed; per-height fallback "
                "primary=%s first=%d last=%d err=%r",
                self.primary.id(),
                first,
                last,
                e,
            )
        fetched = await asyncio.gather(
            *(self._from_primary(h) for h in range(first, last + 1)),
            return_exceptions=True,
        )
        for f in fetched:
            if isinstance(f, BaseException):
                raise f
        return list(fetched)

    async def _verify_skipping(
        self, trusted: LightBlock, target: LightBlock, now_ns: int
    ) -> LightBlock:
        """Bisection: try the direct hop; when less than the trust level
        of the trusted set signed the target, fetch the midpoint and
        recurse."""
        cache: List[LightBlock] = [target]
        cur = trusted
        while True:
            candidate = cache[-1]
            try:
                self._verify_hop(cur, candidate, now_ns)
            except NewValSetCantBeTrustedError:
                pivot = (cur.height + candidate.height) // 2
                if pivot in (cur.height, candidate.height):
                    raise InvalidHeaderError(
                        "bisection exhausted without trustable hop"
                    )
                pivot_block = await self._from_primary(pivot)
                pivot_block.validate_basic(self.chain_id)
                cache.append(pivot_block)
                continue
            self.store.save_light_block(candidate)
            cur = candidate
            cache.pop()
            if not cache:
                return cur

    def _verify_hop(
        self, trusted: LightBlock, untrusted: LightBlock, now_ns: int
    ) -> None:
        verify(
            self.chain_id,
            trusted.signed_header,
            trusted.validator_set,
            untrusted.signed_header,
            untrusted.validator_set,
            self.trust_options.period_ns,
            now_ns,
            self.max_clock_drift_ns,
            self.trust_level,
        )

    # -- backwards

    async def _verify_backwards_to(self, height: int) -> LightBlock:
        """Hash-chain back from the first trusted block."""
        cur = self.store.first_light_block()
        if cur is None:
            raise LightClientError("no trusted state to verify from")
        for h in range(cur.height - 1, height - 1, -1):
            interim = await self._from_primary(h)
            interim.validate_basic(self.chain_id)
            verify_backwards(
                self.chain_id, interim.signed_header, cur.signed_header
            )
            self.store.save_light_block(interim)
            cur = interim
        return cur

    # -- divergence detection (reference: light/detector.go)

    async def _detect_divergence(
        self, verified: LightBlock, now_ns: int
    ) -> None:
        """Cross-check a newly verified header with every witness. A
        witness serving another header at that height that verifies from
        the trusted state is evidence of an attack; one serving a header
        that does not verify is dropped."""
        if not self.witnesses:
            return
        remaining: List[Provider] = []
        evidence: List[LightClientAttackEvidence] = []
        for witness in self.witnesses:
            try:
                w_lb = await witness.light_block(verified.height)
            except Exception:  # a provider may fail any way
                # unresponsive: kept, as a transient failure
                remaining.append(witness)
                continue
            if w_lb.signed_header.hash() == verified.signed_header.hash():
                remaining.append(witness)
                continue
            # a conflicting header: does it verify from a trusted block
            # strictly below the verified height? (the verified block is
            # stored already and must not anchor its own cross-check)
            common = self.store.light_block_before(verified.height)
            try:
                w_lb.validate_basic(self.chain_id)
                self._verify_conflicting(common, w_lb, now_ns)
            except (LightClientError, ValueError):
                _log.info(
                    "witness sent invalid conflicting header; removing "
                    "witness=%s",
                    witness.id(),
                )
                continue
            evidence.append(
                LightClientAttackEvidence(
                    conflicting_block=w_lb,
                    common_height=common.height if common else 0,
                    timestamp_ns=w_lb.signed_header.header.time_ns,
                )
            )
            remaining.append(witness)
        self.witnesses = remaining
        if not self.witnesses:
            raise NoWitnessesError(
                "all witnesses removed during divergence detection"
            )
        if evidence:
            for provider in [self.primary] + self.witnesses:
                for ev in evidence:
                    try:
                        await provider.report_evidence(ev)
                    except Exception:  # best effort, as the reference's
                        pass
            raise DivergenceError(
                f"conflicting verifiable header at height "
                f"{verified.height}: possible light-client attack",
                evidence=evidence,
            )

    def _verify_conflicting(
        self, trusted: Optional[LightBlock], w_lb: LightBlock, now_ns: int
    ) -> None:
        if trusted is None:
            raise InvalidHeaderError("no trusted root for cross-check")
        if trusted.height == w_lb.height:
            if trusted.signed_header.hash() != w_lb.signed_header.hash():
                raise InvalidHeaderError("conflicts with trusted root")
            return
        self._verify_hop(trusted, w_lb, now_ns)

    # -- providers

    async def _from_primary(self, height: int) -> LightBlock:
        """Fetch from the primary; when it fails, from the first witness
        that answers, which becomes the primary (the old one goes to the
        back of the witnesses). No provider is dropped for a failed
        fetch: a height nobody serves yet must not empty the client."""
        last_err: Optional[Exception] = None
        for provider in [self.primary] + list(self.witnesses):
            try:
                lb = await provider.light_block(height)
            except Exception as e:  # a provider may fail any way
                last_err = e
                continue
            if height != 0 and lb.height != height:
                last_err = InvalidHeaderError(
                    f"provider {provider.id()} returned height "
                    f"{lb.height}, requested {height}"
                )
                continue
            if provider is not self.primary:
                _log.info(
                    "promoting witness to primary old=%s new=%s",
                    self.primary.id(),
                    provider.id(),
                )
                self.witnesses = [
                    w for w in self.witnesses if w is not provider
                ] + [self.primary]
                self.primary = provider
            return lb
        raise NoWitnessesError(
            f"no provider could serve height {height}: {last_err}"
        )
