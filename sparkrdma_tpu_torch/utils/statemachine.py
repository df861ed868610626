"""Runtime lifecycle state-machine validator + schedule shaker.

The runtime half of the state discipline (the static half is
tools/statecheck.py — the dbglock/ledger split applied to lifecycle
state).  Each lifecycle-bearing class declares its machine as class
attributes — ``MACHINE`` (registry name), ``STATES``, ``INITIAL``,
``TERMINAL``, and a ``TRANSITIONS`` table mapping each state to the
tuple of states reachable from it — and annotates the state field's
``__init__`` seeding line with ``# state: <machine>``.  Every state
change then flows through the declared ``_transition()`` helper
(:class:`StateMachine` provides the canonical one).

Off by default: ``_transition()`` is one module-global attribute read,
a false branch, and the plain assignment — identity-tested against raw
assignment.  ``spark.shuffle.tpu.stateDebug`` (the manager flips the
process-global :data:`GLOBAL_STATE_DEBUG` on BEFORE building its node,
the lockDebug/resourceDebug shape) validates every transition against
the table: an edge absent from ``TRANSITIONS`` raises
:class:`IllegalTransition` carrying both states and a 4-frame call
site, and every legal edge counts
``state_transitions_total{machine=,from=,to=}`` (terminal entries also
count ``state_terminal_total{machine=,state=}``) plus a flight-recorder
``state``-plane event when the recorder is armed.

On top of validation, ``spark.shuffle.tpu.schedShake=<seed>`` arms the
deterministic schedule shaker: at every validated transition a seeded
0–2ms yield/sleep widens the race window around exactly the points
where lifecycle races live.  Per-machine streams are seeded
``seed ^ crc32(machine)`` (the faults/injector.py shape), so a fixed
seed replays the same perturbation schedule run over run.

State values may be strings, ints, enums or booleans; validation maps
them to string tokens via :func:`state_token` (enum members by
lowercased name), so tables are written in readable lowercase tokens.
"""

from __future__ import annotations

import random
import sys
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

from sparkrdma_tpu_torch.metrics import counter


def _call_site(frames: int = 4, skip: int = 2) -> str:
    """Compact ``file:line`` chain of the transition call site (the
    dbglock idiom, deepened to 4 frames — lifecycle bugs usually sit
    one or two callers above the helper)."""
    out = []
    try:
        f = sys._getframe(skip)
    except (ValueError, AttributeError):
        return "<unknown>"
    while f is not None and len(out) < frames:
        out.append(
            f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
            f":{f.f_code.co_name}"
        )
        f = f.f_back
    return " <- ".join(out) if out else "<unknown>"


def state_token(value) -> str:
    """Canonical string token of one state value: strings pass
    through, enum members map to their lowercased name, booleans and
    ints stringify (tables for those machines use string states, so a
    raw int here is itself the drift being reported)."""
    if isinstance(value, str):
        return value
    name = getattr(value, "name", None)
    if isinstance(name, str):
        return name.lower()
    return str(value).lower()


class IllegalTransition(RuntimeError):
    """A state change absent from the machine's declared TRANSITIONS
    table (terminal states declare no outgoing edges, so a write after
    terminal raises here too)."""

    def __init__(self, machine: str, frm: str, to: str, site: str):
        super().__init__(
            f"illegal transition {machine}: {frm!r} -> {to!r} at {site}"
        )
        self.machine = machine
        self.frm = frm
        self.to = to
        self.site = site


class StateDebug:
    """Process-global validator/shaker state (the LockFactory shape):
    ``enabled`` flips validation on, ``shake_seed`` non-zero arms the
    schedule shaker on top of it."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.shake_seed = 0
        self._lock = threading.Lock()  # lock-order: 97
        self._rngs: Dict[str, random.Random] = {}  # guarded-by: _lock

    # -- validation (callers gate on .enabled) -------------------------------
    def check(self, obj, to, frm=None, *, name: str, field: str,
              transitions: Dict[str, Tuple[str, ...]],
              terminal: Tuple[str, ...] = ()) -> None:
        """Validate one proposed transition of ``obj``'s machine.
        Same-state re-assertions are legal no-ops (idempotent stop()
        patterns) and are neither counted nor shaken."""
        from sparkrdma_tpu_torch.obs import RECORDER, fr_event

        cur = state_token(getattr(obj, field))
        dst = state_token(to)
        if frm is not None and state_token(frm) != cur:
            site = _call_site()
            counter("state_transitions_illegal_total", machine=name).inc()
            if RECORDER.enabled:
                fr_event("state", "illegal", machine=name, src=cur, dst=dst,
                         site=site)
            raise IllegalTransition(name, cur, dst,
                                    f"expected from={state_token(frm)!r} "
                                    f"saw {cur!r} at {site}")
        if dst == cur:
            return
        if dst not in transitions.get(cur, ()):
            site = _call_site()
            counter("state_transitions_illegal_total", machine=name).inc()
            if RECORDER.enabled:
                fr_event("state", "illegal", machine=name, src=cur, dst=dst,
                         site=site)
            raise IllegalTransition(name, cur, dst, site)
        counter("state_transitions_total", machine=name,
                **{"from": cur, "to": dst}).inc()
        if dst in terminal:
            counter("state_terminal_total", machine=name, state=dst).inc()
        if RECORDER.enabled:
            fr_event("state", "transition", machine=name, src=cur, dst=dst)
        if self.shake_seed:
            self._shake(name)

    # -- the schedule shaker -------------------------------------------------
    def _shake(self, machine: str) -> None:
        """One seeded 0–2ms yield/sleep AFTER a validated transition:
        three of four transitions bare-yield (releases the GIL, lets a
        racing thread in), the fourth sleeps up to 2ms — enough to
        reorder any two racing lifecycle paths without drowning the
        suite.  Deterministic per (seed, machine, call index)."""
        with self._lock:
            rng = self._rngs.get(machine)
            if rng is None:
                rng = self._rngs[machine] = random.Random(
                    self.shake_seed ^ (zlib.crc32(machine.encode()) &
                                       0x7FFFFFFF)
                )
            u = rng.random()
        if u < 0.75:
            time.sleep(0)  # bare yield
        else:
            time.sleep((u - 0.75) * 0.008)  # uniform 0–2ms

    def reset(self) -> None:
        """Drop the per-machine rng streams (tests re-seed between
        runs; a fresh arm must replay the same schedule)."""
        with self._lock:
            self._rngs.clear()


GLOBAL_STATE_DEBUG = StateDebug(enabled=False)


def get_state_debug() -> StateDebug:
    """The process-global validator the manager arms from conf."""
    return GLOBAL_STATE_DEBUG


class StateMachine:
    """Mixin providing the canonical ``_transition()`` helper.

    Subclasses declare the machine (``MACHINE``/``STATES``/``INITIAL``/
    ``TERMINAL``/``TRANSITIONS``, plus ``STATE_FIELD`` when the field
    is not ``_state``) and seed the field in ``__init__`` with a
    ``# state: <machine>`` annotation; every later write goes through
    ``_transition()``.  Empty ``__slots__`` so slotted value classes
    (descriptors, per-op records) can mix it in for free.

    A class hosting a SECOND machine (AsyncTcpChannel's recv machine
    next to the inherited lifecycle) declares the extra table under a
    prefix (``RX_STATES``...), binds it with ``# state: <machine>
    table: RX`` on the field, and routes writes through its own
    ``_transition_<suffix>`` helper calling :func:`check_named`.
    """

    __slots__ = ()

    MACHINE = ""
    STATES: Tuple[str, ...] = ()
    INITIAL: Optional[str] = None
    TERMINAL: Tuple[str, ...] = ()
    TRANSITIONS: Dict[str, Tuple[str, ...]] = {}
    STATE_FIELD = "_state"

    def _transition(self, to, frm=None) -> None:
        if GLOBAL_STATE_DEBUG.enabled:
            GLOBAL_STATE_DEBUG.check(
                self, to, frm, name=self.MACHINE, field=self.STATE_FIELD,
                transitions=self.TRANSITIONS, terminal=self.TERMINAL,
            )
        setattr(self, self.STATE_FIELD, to)


def check_named(obj, to, frm=None, *, name: str, field: str,
                transitions: Dict[str, Tuple[str, ...]],
                terminal: Tuple[str, ...] = ()) -> None:
    """Validation entry for hand-rolled ``_transition_<suffix>``
    helpers (second machines on one class).  Callers gate on
    ``GLOBAL_STATE_DEBUG.enabled`` and do their own assignment."""
    GLOBAL_STATE_DEBUG.check(obj, to, frm, name=name, field=field,
                             transitions=transitions, terminal=terminal)


def shake_confs_from_env(env=None) -> Dict[str, object]:
    """Conf overlay for the shaken harnesses (``make chaos-shake``):
    ``SCHED_SHAKE=<seed>`` in the environment layers
    ``schedShake`` (which implies ``stateDebug``) onto a soak's conf
    dict, so ONE env var turns any chaos soak or push drill into a
    shaken run without forking the test."""
    import os

    seed = (os.environ if env is None else env).get("SCHED_SHAKE", "")
    if not seed:
        return {}
    return {
        "spark.shuffle.tpu.stateDebug": True,
        "spark.shuffle.tpu.schedShake": seed,
    }
