"""Device-backed BatchVerifiers: the GPU side of the plugin boundary,
and the fault policy of the device plane.

Counterpart: tendermint_tpu/crypto/tpu_verifier.py: `_TpuBatchVerifier`
add/verify (:387-655) with `_disprove_invalid_lanes` (:657) and
`_cpu_fallback` (:686), the gather deadline and its watchdog
(:232-377), the ed25519 and sr25519 subclasses (:721-742), `stats`
(:773), the factories and the sr25519 single-verify route (:783-893),
`install` with its mesh and `uninstall` (:894-997) with the group
affinity they set (:950-969, :976-997), and the dispatch telemetry
(:40-95, 130-157): integer counters (`stats()`) and, on
libs/metrics.DEFAULT_REGISTRY, the JAX `tpu_*` family under the
subsystem `gpu` (`tendermint_tpu_gpu_verify_batches_total`, ...), each
counter fed where its stats() key is, so the two agree. The three
timings come from host clocks around verify()'s dispatch and gathers;
no synchronization, event or launch is added for them. install() registers a factory
per key type with crypto.batch: create_batch_verifier then returns a
GpuEd25519BatchVerifier or GpuSr25519BatchVerifier for a batch of at
least `min_batch` signatures while the key type's breaker is closed;
they run ops/ed25519_kernel.Ed25519Verifier and
ops/sr25519_kernel.Sr25519Verifier on the installed device, in
STREAM_CHUNK windows dispatched from add() as they fill, gathered in add
order by verify().

THE FAULT POLICY. The device is a coprocessor that can fail at run time;
such a failure is contained, and nothing else is.

- Contained: a window whose dispatch raises a DeviceFault, a gather
  that passes its deadline (60 s unless install() is told otherwise: a
  hung device surfaces as DeviceTimeout instead of wedging the caller),
  a bitmap of the wrong length, and a lane the device calls invalid
  that the host verifies (every invalid lane is cross-examined by the
  host-only verify). The whole batch is then re-verified through the
  registered CPU factory (crypto.batch.cpu_factory: the native C plane,
  crypto/ed25519.py and crypto/sr25519.py), so the caller gets the
  CPU's bitmap with the same index attribution; the batch is marked
  `faulted`; stats() counts one fault and the batch's signatures as
  rerouted; a WARNING is logged with the key type, the signature count
  and the error; and the key type's breaker (crypto/breaker.py) opens.
  While it is open, new batches of that key type go to the CPU factory
  with no device touch (their signatures counted as rerouted) until a
  single-flight background probe verifies one self-signed signature on
  the device and closes it. A fault raised while add() streams a window
  is deferred to verify(). Only DeviceFault (DeviceTimeout is one) is
  contained: the fault plane's injections raise it, and so do the
  deadline, the mis-shape and the disproven-lane checks.
- Not contained: any other error of a dispatch or a gather, which
  raises to the caller of add() or verify(): a launch that fails
  (ops/build.check_launch's RuntimeError), a sticky CUDA error such as
  an illegal address; the same error met by a breaker's background
  probe, which is kept and raised by the route's next admission
  (create_batch_verifier, single_sr_verifier), so a poisoned context
  never serves traffic from the CPU in silence; a kernel that fails to
  build or load (install() builds every kernel of its program and the
  native plane before it registers a factory, and raises);
  install(device="cuda") where there is no CUDA; a fault when no CPU
  factory is registered. The plain PyTorch versions beside the kernels
  are never a catch branch: they run only for tensors on the CPU
  (device="cpu", the tests' device), and a re-verify goes to the native
  C plane.
- Seen by: `faulted` on the batch; stats() "faults", "rerouted_sigs" and
  "breaker_<route>" (0 closed, 1 open, 2 half-open); the log line.

STREAMS. A window's kernels run on the stream current on the thread
that dispatched it; its gather runs on a watchdog thread under that
same stream, so the bitmap's copy to the host is ordered after them
whatever stream the caller verifies on.

THE MESH. install(mesh=...) splits every window of both key types over
the mesh's devices (parallel/sharding.py): one handle then carries a
stream a shard, its gather waits on each in turn, and the gather
deadline covers the whole of it. A window is still one dispatch: the
fault point `gpu.dispatch` fires once a window, so the seeded draws of
TM_TPU_FAULT stay those of one card, and a fault contained in any shard
re-verifies the whole batch. The min-batch gate applies to the batch,
and stats() books the window's rounded bucket.

MIN-BATCH ROUTING. A batch of fewer than `min_batch` signatures of
either key type stays on the CPU factory: the default (32, config.py) is
where one device window stops losing to the native CPU batch, measured
on the card for both key types (PERF.md §5, chip_smoke.py phase
`min_batch`). The sr25519 single-verify route
(PubKeySr25519.verify_signature) rides the device only where the gate
admits one signature.

Ported here and not before: the breakers, the watchdog, the CPU
re-verify, the single-verify route and the counters above; the metrics
family followed with the port's metrics library. The
verified-signature cache (crypto/sigcache.py) serves the consensus vote
path; crypto.batch.drain_and_cache records nothing of a batch marked
`faulted`. Still not ported: the commit memo (no port path keeps one),
trace spans (the port has no tracing library).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

from ..config import DEFAULT_MIN_BATCH
from ..libs import metrics as M
from . import breaker as _breaker_mod
from . import faults
from .batch import (
    cpu_factory,
    native_cpu_affinity,
    register_device_factory,
    set_group_affinity_fn,
    unregister_device_factory,
)
from .faults import DeviceFault, DeviceTimeout
from .keys import BatchVerifier, PubKey

__all__ = [
    "DEFAULT_GATHER_DEADLINE_S",
    "DEVICE_GROUP_AFFINITY",
    "DEFAULT_MIN_BATCH",
    "DeviceFault",
    "DeviceTimeout",
    "GpuEd25519BatchVerifier",
    "GpuSr25519BatchVerifier",
    "install",
    "installed",
    "probe_now",
    "report_single",
    "single_sr_verifier",
    "sr_single_breaker",
    "stats",
    "uninstall",
]

_log = logging.getLogger(__name__)

# A gather of a launched window on a healthy card takes milliseconds;
# 60 s of silence is a wedged device, not a slow batch.
DEFAULT_GATHER_DEADLINE_S = 60.0

KEY_TYPES = ("ed25519", "sr25519")
_SR_SINGLE = "sr25519-single"
ROUTES = (*KEY_TYPES, _SR_SINGLE)

_STATS_LOCK = threading.Lock()
# windows dispatched and signatures the device finished, in all and per
# key type; contained faults; signatures sent to the CPU by a fault or an
# open breaker; bucket lanes padded; dispatches into a bucket already
# (warm) or not yet (cold) dispatched this install
_STATS = {
    **{
        f"{count}{suffix}": 0
        for count in ("batches", "sigs")
        for suffix in ("", *(f"_{kt}" for kt in KEY_TYPES))
    },
    "faults": 0,
    "rerouted_sigs": 0,
    "pad_waste": 0,
    "warm_buckets": 0,
    "cold_buckets": 0,
}
_WARM: set = set()  # (key type, bucket) dispatched since install()
# the installed ops verifiers by key type (Ed25519Verifier, Sr25519Verifier)
_VERIFIERS: dict = {}
# the installed gate, both key types
_MIN_BATCH = DEFAULT_MIN_BATCH
_GATHER_DEADLINE_S: Optional[float] = DEFAULT_GATHER_DEADLINE_S
_PROBE_TRIPLES: dict = {}
# by route: an error outside the fault policy that a background probe
# met, raised by the route's next admission (module docstring)
_PROBE_ERRORS: dict = {}


# the device-offload family (tendermint_tpu/crypto/tpu_verifier.py:44-93),
# process-wide on DEFAULT_REGISTRY: one device runtime a process, shared
# by every node in it. Names, HELP texts and buckets are the JAX ones,
# under the subsystem `gpu`.
_m_batches = M.new_counter(
    "gpu", "verify_batches_total", "Device batch-verify invocations."
)
_m_sigs = M.new_counter(
    "gpu", "verify_sigs_total", "Signatures verified on device."
)
_m_device_faults = M.new_counter(
    "gpu",
    "device_faults_total",
    "Device faults contained (raise/timeout/mis-shape/disproven result).",
)
_m_verify_time = M.new_histogram(
    "gpu",
    "verify_seconds",
    "Wall time of one batch verification.",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5),
)
_m_host_prep = M.new_histogram(
    "gpu",
    "host_prep_seconds",
    "Host-side packing + async dispatch of one batch.",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25),
)
_m_device_wall = M.new_histogram(
    "gpu",
    "device_wall_seconds",
    "Device wall time (gather barrier) of one batch.",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5),
)
_m_pad_waste = M.new_counter(
    "gpu",
    "pad_waste_slots_total",
    "Signature slots wasted padding batches to bucket shapes.",
)
_m_warm_hits = M.new_counter(
    "gpu",
    "warm_bucket_hits_total",
    "Dispatches into a bucket already run this install generation.",
)
_m_warm_misses = M.new_counter(
    "gpu",
    "warm_bucket_misses_total",
    "First dispatches into a bucket (likely paying an XLA compile).",
)
# the stats() key each counter mirrors
_SERIES = {
    "batches": _m_batches,
    "sigs": _m_sigs,
    "faults": _m_device_faults,
    "pad_waste": _m_pad_waste,
    "warm_buckets": _m_warm_hits,
    "cold_buckets": _m_warm_misses,
}


def _count(**deltas) -> None:
    with _STATS_LOCK:
        for k, v in deltas.items():
            _STATS[k] += v
            series = _SERIES.get(k)
            if series is not None and v:
                series.inc(v)


def _breaker(route: str) -> _breaker_mod.CircuitBreaker:
    return _breaker_mod.breaker_for(route)


# -- the gather deadline ------------------------------------------------

# Abandoned watchdog workers still blocked in a wedged gather, capped:
# past the cap a gather fails at once with DeviceTimeout instead of
# parking another thread forever (the breaker's probes against a dead
# device would otherwise leak one a probe). Healthy workers go back to a
# small free list, so a gather costs an Event handshake, not a thread.
_MAX_WEDGED_GATHERS = 8
_MAX_IDLE_WATCHDOGS = 4
_IDLE_WATCHDOGS: list = []  # guarded by _wedged_lock
_wedged_gathers = 0
_wedged_lock = threading.Lock()


class _Watchdog:
    """One reusable daemon worker: runs one job at a time and parks on
    an Event between jobs. A worker whose job wedged is abandoned and
    retires if the job ever finishes."""

    __slots__ = ("_job", "_wake", "thread")

    def __init__(self) -> None:
        self._job = None
        self._wake = threading.Event()
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name="gpu-gather-watchdog"
        )
        self.thread.start()

    def run(self, job: tuple) -> None:
        self._job = job
        self._wake.set()

    def _loop(self) -> None:
        global _wedged_gathers
        while True:
            self._wake.wait()
            self._wake.clear()
            fn, result, done, state = self._job
            self._job = None
            try:
                result["val"] = fn()
            except BaseException as e:  # delivered to the caller
                result["exc"] = e
            with _wedged_lock:
                done.set()  # under the lock: atomic with the timeout path
                if state["abandoned"]:
                    _wedged_gathers -= 1
                    return
                if len(_IDLE_WATCHDOGS) >= _MAX_IDLE_WATCHDOGS:
                    return
                _IDLE_WATCHDOGS.append(self)


def _deadline_call(fn, deadline_s: float):
    """fn() on a watchdog worker, bounded by deadline_s: on expiry the
    worker is abandoned (a blocked gather cannot be interrupted) and
    DeviceTimeout raises here."""
    global _wedged_gathers
    with _wedged_lock:
        if _wedged_gathers >= _MAX_WEDGED_GATHERS:
            raise DeviceTimeout(
                f"device gather skipped: {_wedged_gathers} wedged "
                f"gathers already outstanding"
            )
        w = _IDLE_WATCHDOGS.pop() if _IDLE_WATCHDOGS else None
    if w is None:
        w = _Watchdog()
    result: dict = {}
    state = {"abandoned": False}
    done = threading.Event()
    w.run((fn, result, done, state))
    if not done.wait(deadline_s):
        with _wedged_lock:
            if not done.is_set():  # wedged, not a photo finish
                state["abandoned"] = True
                _wedged_gathers += 1
        if state["abandoned"]:
            raise DeviceTimeout(
                f"device gather exceeded its {deadline_s}s deadline"
            )
    if "exc" in result:
        raise result["exc"]
    return result["val"]


def _dispatch_stream(v):
    """The stream v's kernels were just enqueued on (the calling
    thread's current one), or None: for the CPU, and for a verifier split
    over a mesh, whose handle carries its shards' streams."""
    if v.device.type != "cuda" or getattr(v, "mesh", None) is not None:
        return None
    import torch

    return torch.cuda.current_stream(v.device)


def _gather_guarded(v, handle, key_type: str, stream) -> List[bool]:
    """One gather, on `stream` (the dispatch's, _dispatch_stream), under
    the containment stack: the fault plane's control modes inside the
    deadline (so an injected hang surfaces as DeviceTimeout), the
    deadline, and its data modes on the bitmap."""

    def call():
        if faults.armed():
            faults.fire("gpu.gather", key=key_type)
        if stream is None:
            return v.gather(handle)
        import torch

        with torch.cuda.stream(stream):
            return v.gather(handle)

    dl = _GATHER_DEADLINE_S
    out = call() if not dl else _deadline_call(call, dl)
    bits = [bool(b) for b in out]
    if faults.armed():
        bits = faults.mangle("gpu.gather", bits, key=key_type)
    return bits


class _RoutedToCpu(Exception):
    """The breaker opened after this verifier was admitted: reroute
    quietly, no fault."""


# -- the batch verifiers ------------------------------------------------


class _GpuBatchVerifier(BatchVerifier):
    """Queues triples on the host, verifies them on the device in
    STREAM_CHUNK windows, each one dispatch of the ops verifier. Every
    triple is kept until verify() returns, so any contained fault can
    re-verify the whole batch on the CPU (module docstring)."""

    KEY_TYPE = ""  # subclasses set
    STREAM_CHUNK = 2048  # == a DEFAULT_BUCKET_SIZES entry

    def __init__(self, verifier) -> None:
        self._verifier = verifier
        self._all: List[Tuple[PubKey, bytes, bytes]] = []  # add order
        self._pks: List[bytes] = []  # the window not yet dispatched
        self._msgs: List[bytes] = []
        self._sigs: List[bytes] = []
        self._handles: List[tuple] = []  # (handle, n, stream), add order
        self._stream_fault: Optional[BaseException] = None
        self.faulted = False  # True once a device fault was contained

    def _dispatch_pending(self) -> None:
        """Launch the pending window and clear it; gathered in verify()."""
        v = self._verifier
        if faults.armed():
            faults.fire("gpu.dispatch", key=self.KEY_TYPE)
        n = len(self._pks)
        handle = v.dispatch(self._pks, self._msgs, self._sigs)
        self._handles.append((handle, n, _dispatch_stream(v)))
        self._pks, self._msgs, self._sigs = [], [], []
        self._account(v, n)

    def _account(self, v, n: int) -> None:
        from ..ops.ed25519_kernel import bucket_for

        # the window's padded width; a verifier split over a mesh rounds
        # it to a multiple of the mesh's size
        bucket = v._bucket(n) if getattr(v, "mesh", None) is not None else bucket_for(n, v.bucket_sizes)
        key = (self.KEY_TYPE, bucket)
        with _STATS_LOCK:
            warm = key in _WARM
            _WARM.add(key)
        _count(
            batches=1,
            **{f"batches_{self.KEY_TYPE}": 1},
            pad_waste=bucket - n,
            warm_buckets=int(warm),
            cold_buckets=int(not warm),
        )

    def add(self, pub_key: PubKey, message: bytes, signature: bytes) -> None:
        if pub_key.type() != self.KEY_TYPE:
            raise TypeError(
                f"{type(self).__name__} requires {self.KEY_TYPE} keys"
            )
        if len(signature) != 64:
            raise ValueError("malformed signature size")
        message = bytes(message)
        signature = bytes(signature)
        self._all.append((pub_key, message, signature))
        self._pks.append(pub_key.bytes())
        self._msgs.append(message)
        self._sigs.append(signature)
        if (
            len(self._pks) >= self.STREAM_CHUNK
            and self._stream_fault is None
            and _breaker(self.KEY_TYPE).state() == _breaker_mod.CLOSED
        ):
            try:
                self._dispatch_pending()
            except DeviceFault as e:
                # a contained fault is verify()'s to answer: the window
                # stays queued and everything is re-verified on the CPU
                self._stream_fault = e

    def verify(self) -> Tuple[bool, List[bool]]:
        """Dispatch the remainder, gather every window in add order; on
        a contained fault the CPU factory's answer (module docstring).
        One-shot: a second call without new add()s returns (False, [])."""
        if not self._all:
            return False, []
        with _m_verify_time.time():
            return self._verify_timed()

    def _verify_timed(self) -> Tuple[bool, List[bool]]:
        t0 = time.perf_counter()
        work = self._all
        total = len(work)
        bits: Optional[List[bool]] = None
        fault: Optional[BaseException] = None
        device_sigs = 0  # lanes with a finished device verdict
        host_prep: Optional[float] = None  # s to the last dispatch
        try:
            if self._stream_fault is not None:
                raise self._stream_fault
            # a side-effect-free check: this verifier was admitted at
            # creation, possibly holding the route's one half-open
            # ticket, which a second allow() would burn
            if (
                not self._handles
                and _breaker(self.KEY_TYPE).state() == _breaker_mod.OPEN
            ):
                raise _RoutedToCpu()
            if self._pks:
                self._dispatch_pending()
            host_prep = time.perf_counter() - t0
            got: List[bool] = []
            try:
                for handle, n, stream in self._handles:
                    lane = _gather_guarded(
                        self._verifier, handle, self.KEY_TYPE, stream
                    )
                    if len(lane) != n:
                        raise DeviceFault(
                            f"mis-shaped device result: {len(lane)} lanes "
                            f"for {n} signatures"
                        )
                    got.extend(lane)
                    device_sigs += n
            finally:
                self._handles = []
            if not all(got):
                self._disprove_invalid_lanes(work, got)
            bits = got
        except _RoutedToCpu:
            pass
        except DeviceFault as e:  # DeviceTimeout too; anything else raises
            fault = e
        finally:
            self._handles = []
            self._pks, self._msgs, self._sigs = [], [], []
            self._all = []
            self._stream_fault = None
        _count(sigs=device_sigs, **{f"sigs_{self.KEY_TYPE}": device_sigs})
        if bits is None:
            return self._cpu_fallback(work, fault, total)
        _breaker(self.KEY_TYPE).record_success()
        _m_host_prep.observe(host_prep)
        _m_device_wall.observe(time.perf_counter() - t0 - host_prep)
        return all(bits), bits

    def _disprove_invalid_lanes(self, work, bits: List[bool]) -> None:
        """Cross-examine every lane the device called invalid with a
        host-only verify: a wrong signature fails both ways (one CPU
        verify a bad lane); a lane the host verifies is a device lie, and
        the batch is a fault. A bad signature reported good is not caught
        this way; on a correct kernel the equation itself excludes it."""
        for i, ok in enumerate(bits):
            if ok:
                continue
            pub_key, msg, sig = work[i]
            oracle = getattr(
                pub_key, "verify_signature_cpu", pub_key.verify_signature
            )
            if oracle(msg, sig):
                raise DeviceFault(
                    f"device invalidated lane {i} but the CPU verifies "
                    f"it: result disproven"
                )

    def _cpu_fallback(self, work, fault, total: int) -> Tuple[bool, List[bool]]:
        """Re-verify `work` through the registered CPU factory. With a
        fault: containment (batch marked, fault counted and logged,
        breaker opened); without one the breaker was already open and
        this is the quiet CPU route."""
        if fault is not None:
            self.faulted = True
            _count(faults=1)
            _breaker(self.KEY_TYPE).record_failure()
            _log.warning(
                "device batch fault contained; re-verifying on CPU "
                "key=%s sigs=%d err=%r",
                self.KEY_TYPE,
                total,
                fault,
            )
        cpu = cpu_factory(self.KEY_TYPE)
        if cpu is None:  # no CPU plane to contain the fault with
            if fault is not None:
                raise fault
            raise RuntimeError(f"no CPU batch factory for {self.KEY_TYPE!r}")
        _count(rerouted_sigs=total)
        bv = cpu()
        for pub_key, msg, sig in work:
            bv.add(pub_key, msg, sig)
        return bv.verify()

    def __len__(self) -> int:
        return len(self._all)


class GpuEd25519BatchVerifier(_GpuBatchVerifier):
    """ed25519 on the device: kernels X1 and K2 (or K1, hybrid)."""

    KEY_TYPE = "ed25519"


class GpuSr25519BatchVerifier(_GpuBatchVerifier):
    """sr25519 on the device: merlin challenges on the host, then kernel
    X3 (or K1, hybrid)."""

    KEY_TYPE = "sr25519"


_CLASSES = {"ed25519": GpuEd25519BatchVerifier, "sr25519": GpuSr25519BatchVerifier}


def _raise_probe_error(route: str) -> None:
    err = _PROBE_ERRORS.get(route)
    if err is not None:
        raise RuntimeError(
            f"the {route} device probe failed outside the fault policy: "
            f"{err!r}"
        ) from err


def _make(key_type: str, size_hint: int) -> Optional[BatchVerifier]:
    if 0 < size_hint < _MIN_BATCH:
        return None  # a small batch stays on the native CPU plane
    _raise_probe_error(key_type)
    if not _breaker(key_type).allow():
        _count(rerouted_sigs=max(size_hint, 0))
        return None  # an open breaker: the CPU, quietly
    return _CLASSES[key_type](_VERIFIERS[key_type])


def _factory(size_hint: int) -> Optional[BatchVerifier]:
    return _make("ed25519", size_hint)


def _factory_sr(size_hint: int) -> Optional[BatchVerifier]:
    return _make("sr25519", size_hint)


# -- the sr25519 single-verify route ------------------------------------


def sr_single_breaker() -> _breaker_mod.CircuitBreaker:
    """The breaker of the sr25519 single-verify route (cold, i.e. open,
    until install()'s probe closes it)."""
    return _breaker_mod.breaker_for(_SR_SINGLE, start_open=True)


def single_sr_verifier() -> Optional[BatchVerifier]:
    """A device batch verifier for one sr25519 signature, or None: not
    installed, the route's breaker open, or the min-batch gate keeping
    one signature on the CPU."""
    if not _VERIFIERS:
        return None
    _raise_probe_error(_SR_SINGLE)
    if not sr_single_breaker().allow():
        return None
    return _factory_sr(1)


def report_single(ok: bool) -> None:
    """The device outcome of one single verify, for its route's breaker
    (verify() reports only to the batch breaker): a half-open ticket is
    paid back either way."""
    if ok:
        sr_single_breaker().record_success()
    else:
        sr_single_breaker().record_failure()


# -- probes -------------------------------------------------------------


def _probe_triple(key_type: str) -> tuple:
    """One self-signed (pk, msg, sig) a key type, made once."""
    cached = _PROBE_TRIPLES.get(key_type)
    if cached is None:
        msg = b"breaker-probe-" + key_type.encode()
        if key_type == "sr25519":
            from .sr25519 import PrivKeySr25519

            priv = PrivKeySr25519.from_seed(b"\x77" * 32)
            sig = priv.sign(msg, rng=lambda n: bytes(n))
        else:
            from .ed25519 import PrivKeyEd25519

            priv = PrivKeyEd25519.from_seed(b"\x77" * 32)
            sig = priv.sign(msg)
        cached = _PROBE_TRIPLES[key_type] = (priv.pub_key().bytes(), msg, sig)
    return cached


def _device_probe(key_type: str) -> bool:
    """One self-signed signature through the device path, with the same
    fault points and gather deadline as a batch: a probe of a device
    still at fault fails as its traffic would. Run by the breakers'
    single-flight probe threads."""
    v = _VERIFIERS[key_type]
    pk, msg, sig = _probe_triple(key_type)
    if faults.armed():
        faults.fire("gpu.dispatch", key=key_type)
    handle = v.dispatch([pk], [msg], [sig])
    bits = _gather_guarded(v, handle, key_type, _dispatch_stream(v))
    return len(bits) == 1 and bits[0]


def _background_probe(route: str, fn):
    """`fn` as a breaker's background probe: a DeviceFault is a failed
    probe; any other error is kept for the route's next admission to
    raise, and fails the probe (the breaker stays open meanwhile)."""

    def probe() -> bool:
        try:
            return bool(fn())
        except DeviceFault:
            return False
        except Exception as e:
            _PROBE_ERRORS[route] = e
            raise

    return probe


def _sr_single_probe() -> bool:
    """The single route's probe: where the min-batch gate keeps one
    signature on the CPU there is nothing to prove; else one device
    verify."""
    if _MIN_BATCH > 1:
        return True
    return _device_probe("sr25519")


def probe_now(route: str) -> bool:
    """Run `route`'s probe on this thread and report it to its breaker
    (an operator's or a test's immediate re-arm): True when the device
    verified the probe signature and the breaker closed. An error other
    than a DeviceFault raises here."""
    fn = _sr_single_probe if route == _SR_SINGLE else lambda: _device_probe(route)
    try:
        ok = bool(fn())
    except DeviceFault:  # a failed probe is data
        ok = False
    b = _breaker(route)
    if ok:
        b.close_now()
    else:
        b.record_failure()
    return ok


# -- install ------------------------------------------------------------

# Commits merged into one batch by a caller with several (crypto.batch
# group affinity): on the card a merged window amortizes one dispatch
# over up to 32 light commits; on the CPU device (the plain versions) a
# window is plain torch, whose cost grows with its padded bucket, so
# each commit goes alone, as the JAX package does on a CPU-backed JAX.
DEVICE_GROUP_AFFINITY = {"cuda": 32, "cpu": 1}


def install(
    device="cuda",
    min_batch: int = DEFAULT_MIN_BATCH,
    program: str = "tile",
    bucket_sizes=None,
    gather_deadline_s: Optional[float] = DEFAULT_GATHER_DEADLINE_S,
    mesh=None,
) -> None:
    """Register the device factories for ed25519 and sr25519 on `device`
    (CUDA by default; raises when there is none), after building and
    loading every kernel and the native CPU plane (raises when one fails
    to build). `program` is "tile" (kernels K2 and X3) or "hybrid"
    (kernel K1 inside plain torch); `min_batch` gates both key types;
    `gather_deadline_s` bounds every gather (None or 0: no watchdog);
    `mesh` (parallel.make_mesh) splits every window over its devices,
    which then take the place of `device` (module docstring). Each
    install is a new breaker generation. It also sets the group affinity
    for the device (DEVICE_GROUP_AFFINITY) unless an operator pinned
    one."""
    global _GATHER_DEADLINE_S, _MIN_BATCH
    import torch

    from .. import native

    if mesh is not None:
        from ..parallel.sharding import ShardedEd25519Verifier, ShardedSr25519Verifier

        verifiers = {
            "ed25519": ShardedEd25519Verifier(mesh, bucket_sizes, program=program),
            "sr25519": ShardedSr25519Verifier(mesh, bucket_sizes, program=program),
        }
        device = mesh.devices[0]
    else:
        from ..ops.ed25519_kernel import Ed25519Verifier
        from ..ops.sr25519_kernel import Sr25519Verifier

        verifiers = {
            "ed25519": Ed25519Verifier(bucket_sizes, device=device, program=program),
            "sr25519": Sr25519Verifier(bucket_sizes, device=device, program=program),
        }
    if torch.device(device).type == "cuda":
        from ..ops.build import kernels

        kernels()
    native.ed25519_batch_lib()
    _VERIFIERS.clear()
    _VERIFIERS.update(verifiers)
    _MIN_BATCH = min_batch
    _GATHER_DEADLINE_S = gather_deadline_s
    with _STATS_LOCK:
        _WARM.clear()
    _PROBE_ERRORS.clear()
    for key_type in KEY_TYPES:
        b = _breaker_mod.fresh(key_type)
        b.set_probe(
            _background_probe(key_type, lambda kt=key_type: _device_probe(kt))
        )
    single = _breaker_mod.fresh(_SR_SINGLE, start_open=True)
    single.set_probe(_background_probe(_SR_SINGLE, _sr_single_probe))
    single.probe_now()  # off this thread: warms or closes the route
    register_device_factory("ed25519", _factory)
    register_device_factory("sr25519", _factory_sr)
    affinity = DEVICE_GROUP_AFFINITY[torch.device(device).type]
    set_group_affinity_fn(lambda: affinity)


def uninstall() -> None:
    """Remove the device factories: batches go back to the CPU default,
    and the group affinity to crypto.batch.native_cpu_affinity unless an
    operator pinned one. The breakers are discarded; a probe in flight
    reports to an orphan."""
    global _GATHER_DEADLINE_S, _MIN_BATCH
    for key_type in KEY_TYPES:
        unregister_device_factory(key_type)
    _VERIFIERS.clear()
    _MIN_BATCH = DEFAULT_MIN_BATCH
    _GATHER_DEADLINE_S = DEFAULT_GATHER_DEADLINE_S
    _PROBE_ERRORS.clear()
    with _STATS_LOCK:
        _WARM.clear()
    for route in ROUTES:
        _breaker_mod.discard(route)
    set_group_affinity_fn(native_cpu_affinity)


def installed() -> Optional[int]:
    """The installed min_batch, or None when not installed."""
    return _MIN_BATCH if _VERIFIERS else None


def stats() -> dict:
    """Integer counters since the process started: device windows
    dispatched ("batches") and signatures the device finished ("sigs"),
    in all and per key type ("batches_sr25519", "sigs_ed25519", ...);
    contained faults ("faults"); signatures sent to the CPU by a fault
    or an open breaker ("rerouted_sigs"); bucket lanes padded
    ("pad_waste"); dispatches into a bucket already or not yet dispatched
    since install() ("warm_buckets", "cold_buckets"); and each route's
    breaker state, 0 closed, 1 open, 2 half-open ("breaker_ed25519",
    "breaker_sr25519", "breaker_sr25519_single")."""
    with _STATS_LOCK:
        out = dict(_STATS)
    for route in ROUTES:
        b = _breaker_mod.breaker_for(route, start_open=route == _SR_SINGLE)
        out["breaker_" + route.replace("-", "_")] = b.stats()["code"]
    return out
