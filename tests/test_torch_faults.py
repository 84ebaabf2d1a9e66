"""The port's device-fault containment, on device="cpu".

The cases of the JAX package's tests/test_faults.py (the fault plane,
the circuit breakers and the containment paths of the device batch
verifier) run against tendermint_tpu_torch: crypto/faults.py,
crypto/breaker.py and crypto/gpu_verifier.py, whose device is here the
kernels' plain versions. Every injected fault (a dispatch that raises, a
gather that hangs past its deadline, a mis-shaped bitmap, a flipped
lane) must be answered from the native CPU plane with the healthy
bitmap and the same wrong-signature index; a tripped breaker routes new
work to the CPU without touching the device and re-arms through one
probe; the counters count only work the device finished. Every wait is
bounded: on an Event, or a join of the probe thread, never a sleep.
Tolerance: zero (exact bitmaps and messages).
"""

import threading
import time

import pytest
import torch

from tendermint_tpu.types import InvalidCommitError as JaxInvalidCommitError
from tendermint_tpu.types import validation as jax_validation
from tendermint_tpu_torch.crypto import batch
from tendermint_tpu_torch.crypto import breaker as B
from tendermint_tpu_torch.crypto import faults
from tendermint_tpu_torch.crypto import gpu_verifier as G
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.crypto.sr25519 import (
    PrivKeySr25519,
    Sr25519BatchVerifier,
    sign_batch,
)
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.ops.sr25519_kernel import Sr25519Verifier
from tendermint_tpu_torch.types import validation as port_validation

from .test_torch_validation import CHAIN_ID, HEIGHT, _carry, _jax_commit


def _triples(n, tag=b"fault", seed0=41):
    out = []
    for i in range(n):
        priv = PrivKeyEd25519.from_seed(bytes([seed0 + i]) * 32)
        msg = tag + b"-%d" % i
        out.append((priv.pub_key(), msg, priv.sign(msg)))
    return out


def _fill(v, triples):
    for pk, msg, sig in triples:
        v.add(pk, msg, sig)
    return v


def _wait_probe(b):
    """Join the breaker's probe thread, bounded."""
    t = b._probe_thread
    if t is not None:
        t.join(10.0)
        assert not t.is_alive()


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    B.reset_all()
    yield
    G.uninstall()
    faults.reset()
    B.reset_all()


@pytest.fixture
def installed():
    """The device plane on the plain versions, min_batch 2 so the small
    batches here reach it, a short gather deadline."""
    G.install(device="cpu", min_batch=2, gather_deadline_s=2.0)
    _wait_probe(G.sr_single_breaker())


def _device_ed():
    return G.GpuEd25519BatchVerifier(Ed25519Verifier(device="cpu"))


# -- the fault plane ---------------------------------------------------


def test_rules_are_seed_reproducible():
    def pattern(seed):
        fired = []
        with faults.inject("p", mode="raise", p=0.5, seed=seed) as rule:
            for i in range(50):
                try:
                    faults.fire("p")
                except faults.DeviceFault:
                    fired.append(i)
            assert rule.fired == len(fired)
        return fired

    a, b, c = pattern(7), pattern(7), pattern(8)
    assert a == b and a != c and a


def test_inject_scope_and_times_budget():
    with faults.inject("p", mode="raise", times=2) as rule:
        for _ in range(2):
            with pytest.raises(faults.DeviceFault):
                faults.fire("p")
        faults.fire("p")  # budget spent
        assert rule.fired == 2
    faults.fire("p")
    assert not faults.armed()


def test_key_filter_scopes_rule():
    with faults.inject("p", mode="raise", key="sr25519"):
        faults.fire("p", key="ed25519")
        with pytest.raises(faults.DeviceFault):
            faults.fire("p", key="sr25519")


def test_mangle_modes():
    bits = [True, True, True, True]
    with faults.inject("g", mode="misshape"):
        assert len(faults.mangle("g", bits)) == 3
    with faults.inject("g", mode="bitflip", seed=3):
        flipped = faults.mangle("g", bits)
        assert len(flipped) == 4 and flipped != bits
    # the WAL's short_write is a mode since the WAL came, the network
    # modes since the router came: neither mangles a bitmap
    with faults.inject("g", mode="short_write", seed=9):
        assert faults.mangle("g", bits) == bits
        assert len(faults.clip("g", b"0123456789")) < 10
    with faults.inject("g", mode="drop"):
        assert faults.mangle("g", bits) == bits
        assert faults.clip("g", b"0123") == b"0123"
    with pytest.raises(ValueError, match="unknown fault mode"):
        faults.Rule("g", "teleport")


# -- the circuit breaker ----------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def test_breaker_trips_and_backs_off_exponentially():
    clk = FakeClock()
    b = B.CircuitBreaker("t1", backoff_base_s=10.0, clock=clk)
    assert b.state() == B.CLOSED and b.allow()
    b.record_failure()
    assert b.state() == B.OPEN and b.stats()["code"] == 1
    assert not b.allow()
    clk.now += 9.9
    assert not b.allow()
    clk.now += 0.2
    assert b.allow()  # probe-less: ONE half-open ticket
    assert not b.allow()
    assert b.stats()["code"] == 2
    b.record_failure()
    assert b.stats()["retry_in_s"] == pytest.approx(20.0, abs=0.1)
    clk.now += 20.1
    assert b.allow()
    b.record_success()
    assert b.state() == B.CLOSED and b.stats()["code"] == 0
    b.record_failure()
    assert b.stats()["retry_in_s"] == pytest.approx(10.0, abs=0.1)


def test_breaker_backoff_is_capped():
    clk = FakeClock()
    b = B.CircuitBreaker("t2", backoff_base_s=10.0, backoff_max_s=60.0, clock=clk)
    for _ in range(10):
        b.record_failure()
    assert b.stats()["retry_in_s"] <= 60.0


def test_breaker_probe_is_single_flight():
    """With a probe armed, callers are never admitted while open or
    half-open; one background probe decides, and a storm of allow()
    starts no second one."""
    started, gate = threading.Event(), threading.Event()
    in_flight, peak = [], []

    def probe():
        in_flight.append(1)
        peak.append(len(in_flight))
        started.set()
        gate.wait(5.0)
        in_flight.pop()
        return True

    b = B.CircuitBreaker("t3", backoff_base_s=0.01, probe=probe)
    b.record_failure()
    assert started.wait(5.0)  # the timer fired and the probe parked
    assert b.state() == B.HALF_OPEN
    for _ in range(50):
        assert not b.allow()
    assert b.stats()["probes"] == 1
    gate.set()
    _wait_probe(b)
    assert b.state() == B.CLOSED
    assert max(peak) == 1
    assert b.allow()


def test_breaker_failed_probe_reopens_with_backoff():
    """A failed probe re-opens the breaker with a doubled window, so a
    dead device sees one probe per growing backoff, not one per caller."""
    calls = []
    second = threading.Event()

    def probe():
        calls.append(1)
        if len(calls) == 2:
            second.set()
        return False

    b = B.CircuitBreaker("t4", backoff_base_s=0.02, probe=probe)
    b.record_failure()
    assert second.wait(5.0)  # two probes: the first failed and re-opened
    _wait_probe(b)
    st = b.stats()  # one snapshot: a later timer may start a third probe
    assert st["state"] in (B.OPEN, B.HALF_OPEN)
    assert st["trips"] >= 3 and 2 <= st["probes"] <= st["trips"]
    assert not b.allow()  # with a probe set, callers never pilot it


def test_start_open_breaker_closes_via_probe():
    b = B.CircuitBreaker("t5", backoff_base_s=5.0, start_open=True, probe=lambda: True)
    assert not b.allow()
    b.probe_now()
    _wait_probe(b)
    assert b.state() == B.CLOSED


def test_half_open_ticket_expires_and_reissues():
    clk = FakeClock()
    b = B.CircuitBreaker("t6", backoff_base_s=10.0, clock=clk)
    b.record_failure()
    clk.now += 10.1
    assert b.allow()
    assert not b.allow()
    clk.now += 10.1
    assert b.allow()
    b.record_success()
    assert b.state() == B.CLOSED


def test_open_now_wins_over_inflight_probe():
    started, release = threading.Event(), threading.Event()

    def probe():
        started.set()
        release.wait(5.0)
        return True

    b = B.CircuitBreaker("t7", backoff_base_s=0.01, probe=probe)
    b.record_failure()
    assert started.wait(5.0)
    assert b.probe_in_flight()
    b.open_now()
    release.set()
    _wait_probe(b)
    assert b.state() == B.OPEN


# -- verifier containment ---------------------------------------------


def test_dispatch_raise_contained(installed, caplog):
    triples = _triples(5)
    before = G.stats()
    with faults.inject("gpu.dispatch", mode="raise"):
        v = _fill(_device_ed(), triples)
        with caplog.at_level("WARNING", logger=G.__name__):
            ok, bits = v.verify()
    assert (ok, bits) == (True, [True] * 5)
    assert v.faulted
    after = G.stats()
    assert after["faults"] - before["faults"] == 1
    assert after["rerouted_sigs"] - before["rerouted_sigs"] == 5
    assert after["sigs"] == before["sigs"]  # the device finished nothing
    assert after["breaker_ed25519"] == 1
    assert B.breaker_for("ed25519").state() == B.OPEN
    rec = [r for r in caplog.records if "fault contained" in r.getMessage()]
    assert len(rec) == 1 and rec[0].levelname == "WARNING"
    assert "key=ed25519 sigs=5" in rec[0].getMessage()
    assert "injected device fault" in rec[0].getMessage()


def test_gather_hang_surfaces_as_timeout_and_falls_back():
    """A 30 s hang inside the gather never reaches the caller: the 0.2 s
    deadline turns it into DeviceTimeout and the CPU answers."""
    G.install(device="cpu", min_batch=2, gather_deadline_s=0.2)
    triples = _triples(4)
    assert _fill(_device_ed(), triples).verify()[0]
    t0 = time.perf_counter()
    with faults.inject("gpu.gather", mode="hang", hang_s=30.0):
        v = _fill(_device_ed(), triples)
        ok, bits = v.verify()
    wall = time.perf_counter() - t0
    assert (ok, bits) == (True, [True] * 4)
    assert v.faulted
    assert wall < 15.0  # the hang never reached the caller
    assert G.stats()["faults"] >= 1


def test_misshaped_gather_contained(installed):
    with faults.inject("gpu.gather", mode="misshape"):
        v = _fill(_device_ed(), _triples(4))
        ok, bits = v.verify()
    assert (ok, bits) == (True, [True] * 4)
    assert v.faulted


def test_bitflipped_lane_disproven_and_contained(installed):
    """A device that invalidates a good lane is caught by the host-only
    verify and treated as a faulted device, not a bad vote."""
    with faults.inject("gpu.gather", mode="bitflip", seed=3):
        v = _fill(_device_ed(), _triples(6))
        ok, bits = v.verify()
    assert (ok, bits) == (True, [True] * 6)
    assert v.faulted


def test_sr25519_bitflip_disproven_by_the_host_only_verify(installed):
    privs = [PrivKeySr25519(bytes([90 + i]) * 32) for i in range(3)]
    msgs = [b"sr-%d" % i for i in range(3)]
    sigs = sign_batch(privs, msgs, lambda n: bytes(n))
    v = G.GpuSr25519BatchVerifier(Sr25519Verifier(device="cpu"))
    with faults.inject("gpu.gather", mode="bitflip", key="sr25519"):
        for p, m, s in zip(privs, msgs, sigs):
            v.add(p.pub_key(), m, s)
        ok, bits = v.verify()
    assert (ok, bits) == (True, [True] * 3)
    assert v.faulted
    assert G.stats()["breaker_sr25519"] == 1
    assert G.stats()["breaker_ed25519"] == 0


def test_genuinely_bad_signature_not_a_device_fault(installed):
    triples = _triples(5)
    pk, msg, sig = triples[3]
    triples[3] = (pk, msg, sig[:6] + bytes([sig[6] ^ 1]) + sig[7:])
    before = G.stats()
    v = _fill(_device_ed(), triples)
    ok, bits = v.verify()
    assert not ok and bits == [True, True, True, False, True]
    assert not v.faulted
    assert B.breaker_for("ed25519").state() == B.CLOSED
    assert G.stats()["faults"] == before["faults"]


def test_open_breaker_routes_silently_without_device_touch(installed):
    touched = []

    class SpyBacking:
        bucket_sizes = [8]
        device = torch.device("cpu")

        def dispatch(self, pks, msgs, sigs):  # pragma: no cover - guard
            touched.append(len(pks))
            raise AssertionError("device touched through open breaker")

        def gather(self, handle):  # pragma: no cover - guard
            raise AssertionError("device touched through open breaker")

    B.breaker_for("ed25519").open_now()
    before = G.stats()
    v = _fill(G.GpuEd25519BatchVerifier(SpyBacking()), _triples(4))
    ok, bits = v.verify()
    assert (ok, bits) == (True, [True] * 4)
    assert not touched
    assert not v.faulted  # a quiet reroute is not a fault
    assert G._factory(64) is None  # new batches are born on the CPU
    after = G.stats()
    assert after["rerouted_sigs"] - before["rerouted_sigs"] == 4 + 64
    assert after["batches"] == before["batches"]
    assert after["faults"] == before["faults"]


def test_streaming_dispatch_fault_does_not_raise_from_add(installed, monkeypatch):
    """add() raises on malformed input only; a fault in a streamed
    window's launch is deferred to verify()'s CPU re-verify."""
    monkeypatch.setattr(G._GpuBatchVerifier, "STREAM_CHUNK", 2)
    with faults.inject("gpu.dispatch", mode="raise"):
        v = _device_ed()
        for pk, msg, sig in _triples(5):
            v.add(pk, msg, sig)
            assert len(v) <= 5
        ok, bits = v.verify()
    assert (ok, bits) == (True, [True] * 5)
    assert v.faulted


def test_midloop_gather_fault_counts_only_completed_work(installed, monkeypatch):
    """Three streamed windows in flight, the second gather faults:
    "sigs" rises by the one window the device finished, and the whole
    batch is answered from the CPU."""
    monkeypatch.setattr(G._GpuBatchVerifier, "STREAM_CHUNK", 2)

    class FlakyBacking:
        bucket_sizes = [8]
        device = torch.device("cpu")

        def __init__(self):
            self.gathers = 0

        def dispatch(self, pks, msgs, sigs):
            return [True] * len(pks)

        def gather(self, handle):
            self.gathers += 1
            if self.gathers == 2:
                raise G.DeviceFault("device died mid-flight")
            return handle

    before = G.stats()
    v = G.GpuEd25519BatchVerifier(FlakyBacking())
    for pk, msg, sig in _triples(6):
        v.add(pk, msg, sig)
    ok, bits = v.verify()
    assert (ok, bits) == (True, [True] * 6)
    assert v.faulted
    after = G.stats()
    assert after["sigs"] == before["sigs"] + 2
    assert after["faults"] == before["faults"] + 1
    assert after["batches"] == before["batches"] + 3
    assert len(v) == 0 and v.verify() == (False, [])


def _launch_error(*_a, **_k):
    raise RuntimeError("tm_ed25519_verify_tile: launch failed: an illegal memory access")


@pytest.mark.parametrize("method", ["dispatch", "gather"])
def test_launch_error_raises_out_of_verify_uncontained(installed, monkeypatch, method):
    """Only DeviceFault is contained: a launch error (check_launch's
    RuntimeError) or a sticky CUDA error out of a dispatch or a gather
    raises to the caller, with no CPU re-verify, no fault counted and
    the breaker left closed."""
    monkeypatch.setattr(Ed25519Verifier, method, _launch_error)
    before = G.stats()
    v = _fill(_device_ed(), _triples(4))
    with pytest.raises(RuntimeError, match="illegal memory access") as ei:
        v.verify()
    assert not isinstance(ei.value, faults.DeviceFault)
    assert not v.faulted
    after = G.stats()
    assert after["faults"] == before["faults"]
    assert after["rerouted_sigs"] == before["rerouted_sigs"]
    assert B.breaker_for("ed25519").state() == B.CLOSED


def test_streaming_launch_error_raises_out_of_add(installed, monkeypatch):
    """A streamed window whose launch fails outside the fault policy
    raises from the add() that dispatched it, not deferred."""
    monkeypatch.setattr(G._GpuBatchVerifier, "STREAM_CHUNK", 2)
    monkeypatch.setattr(Ed25519Verifier, "dispatch", _launch_error)
    before = G.stats()["faults"]
    v = _device_ed()
    (pk, msg, sig), (pk2, msg2, sig2) = _triples(2)
    v.add(pk, msg, sig)
    with pytest.raises(RuntimeError, match="launch failed"):
        v.add(pk2, msg2, sig2)
    assert G.stats()["faults"] == before


def test_probe_launch_error_is_raised_by_the_next_admission(installed, monkeypatch):
    """A breaker opened by a contained fault whose background probe then
    meets a launch error stays open, and the route's next admission
    raises that error instead of serving the batch from the CPU in
    silence; probe_now raises it on the caller's thread."""
    b = B.breaker_for("ed25519")
    with faults.inject("gpu.dispatch", mode="raise"):
        assert _fill(_device_ed(), _triples(3)).verify() == (True, [True] * 3)
    assert b.state() == B.OPEN
    monkeypatch.setattr(Ed25519Verifier, "dispatch", _launch_error)
    b.probe_now()  # the background probe, as the retry timer runs it
    _wait_probe(b)
    assert b.state() == B.OPEN
    pk = _triples(1)[0][0]
    with pytest.raises(RuntimeError, match="probe failed outside the fault policy"):
        batch.create_batch_verifier(pk, 8)
    with pytest.raises(RuntimeError, match="launch failed"):
        G.probe_now("ed25519")
    G.install(device="cpu", min_batch=2)  # a new install starts clean
    _wait_probe(G.sr_single_breaker())
    monkeypatch.undo()
    assert isinstance(batch.create_batch_verifier(pk, 8), G.GpuEd25519BatchVerifier)


def test_verify_commit_error_parity_across_fault_paths():
    """The wrong-signature index and message are byte-identical on the
    device path, the device-fault-then-CPU path, the port's CPU path and
    the JAX package's."""
    vals, bid, commit = _jax_commit(set(range(6)), bad=2)
    pvals, pbid, pcommit = _carry(vals, bid, commit)

    def run():
        with pytest.raises(port_validation.InvalidCommitError) as ei:
            port_validation.verify_commit(CHAIN_ID, pvals, pbid, HEIGHT, pcommit)
        return str(ei.value)

    G.install(device="cpu", min_batch=2)
    try:
        assert isinstance(
            batch.create_batch_verifier(pvals.validators[0].pub_key, 6),
            G.GpuEd25519BatchVerifier,
        )
        device = run()
        with faults.inject("gpu.dispatch", mode="raise"):
            mid_fault = run()
        assert G.stats()["breaker_ed25519"] == 1
    finally:
        G.uninstall()
    cpu = run()
    with pytest.raises(JaxInvalidCommitError) as ei:
        jax_validation.verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit)
    assert device == mid_fault == cpu == str(ei.value)
    assert "wrong signature (#2)" in cpu


def test_probe_rearms_route_after_faults_clear(installed):
    """A fault trips the breaker; once it clears, the timer-scheduled
    probe (one device verify of a self-signed signature) closes it, and
    the route serves the device again."""
    b = B.breaker_for("ed25519")
    b.configure(backoff_base_s=0.05)
    triples = _triples(3)
    with faults.inject("gpu.dispatch", mode="raise"):
        assert _fill(_device_ed(), triples).verify() == (True, [True] * 3)
        assert b.state() == B.OPEN
        timer = b._probe_timer  # fires after the backoff, then probes
    timer.join(10.0)
    assert not timer.is_alive()
    _wait_probe(b)
    assert b.state() == B.CLOSED
    v = _fill(_device_ed(), triples)
    assert v.verify() == (True, [True] * 3)
    assert not v.faulted


def test_probe_now_closes_the_route_with_one_device_verify(installed):
    b = B.breaker_for("sr25519")
    b.open_now()
    before = G.stats()
    assert G.probe_now("sr25519")
    assert b.state() == B.CLOSED and G.stats()["breaker_sr25519"] == 0
    assert G.stats()["batches"] == before["batches"]  # a probe is no batch
    with faults.inject("gpu.dispatch", mode="raise"):
        assert not G.probe_now("ed25519")
    assert B.breaker_for("ed25519").state() == B.OPEN


def test_factory_admission_pays_back_the_ticket(installed):
    """The factory's allow() takes the half-open ticket; verify() then
    tries the device and reports, instead of asking again, rerouting and
    leaving the breaker half-open for ever."""
    b = B.fresh("ed25519", backoff_base_s=0.0)  # probe-less
    b.record_failure()
    assert b.state() == B.OPEN
    v = G._factory(8)
    assert v is not None and b.state() == B.HALF_OPEN
    ok, bits = _fill(v, _triples(3)).verify()
    assert (ok, bits) == (True, [True] * 3)
    assert not v.faulted
    assert b.state() == B.CLOSED


def test_min_batch_gate_and_the_sr25519_single_route(monkeypatch):
    """Below the gate either key type stays on the native CPU plane, so
    with the default gate a single sr25519 verify never reaches the
    device; at a gate of 1 the single route takes it once its probe
    has closed the route, and reports to its own breaker."""
    G.install(device="cpu")
    _wait_probe(G.sr_single_breaker())
    pk = PrivKeySr25519(bytes([7]) * 32)
    sig = pk.sign(b"one", rng=lambda n: bytes(n))
    assert G.installed() == G.DEFAULT_MIN_BATCH > 1
    small = batch.create_batch_verifier(pk.pub_key(), G.DEFAULT_MIN_BATCH - 1)
    assert isinstance(small, Sr25519BatchVerifier)
    big = batch.create_batch_verifier(pk.pub_key(), G.DEFAULT_MIN_BATCH)
    assert isinstance(big, G.GpuSr25519BatchVerifier)
    ed = PrivKeyEd25519.from_seed(bytes(32)).pub_key()
    assert isinstance(
        batch.create_batch_verifier(ed, G.DEFAULT_MIN_BATCH), G.GpuEd25519BatchVerifier
    )
    assert G.single_sr_verifier() is None
    before = G.stats()
    assert pk.pub_key().verify_signature(b"one", sig)
    assert G.stats()["batches"] == before["batches"]
    G.install(device="cpu", min_batch=1)
    _wait_probe(G.sr_single_breaker())
    assert G.stats()["breaker_sr25519_single"] == 0
    assert isinstance(G.single_sr_verifier(), G.GpuSr25519BatchVerifier)
    assert pk.pub_key().verify_signature(b"one", sig)
    assert not pk.pub_key().verify_signature(b"two", sig)
    assert G.stats()["batches_sr25519"] == before["batches_sr25519"] + 2
