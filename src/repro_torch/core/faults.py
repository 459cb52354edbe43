"""Deterministic fault injection for the streaming/serving stack (the
port's own copy of the reference's ``core/faults.py``: the same points,
the same registry contract).

A process-wide registry of **named fault points** (DESIGN.md §12).
Production code declares a point once at import time
(:func:`register_point`) and calls :func:`fire` at the seam; the call is
a dictionary lookup and costs nothing unless a test has **armed** the
point (:func:`arm`) with a trigger spec — an exception to raise, a delay
to sleep, or both, gated by a deterministic seeded coin so multi-fault
schedules replay bit-identically across runs.

This exists because the recovery paths it exercises — failed background
compaction builds, stuck build threads, delta overflow under mutation
bursts (:mod:`repro_torch.core.segments`) — are exactly the code that
nothing exercises in the happy path. The registry is thread-safe (faults fire
from background build threads) and test-scoped via the
:func:`injected` context manager, which always disarms on exit.

Typical test usage::

    from repro_torch.core import faults

    with faults.injected("compaction.build", error=RuntimeError,
                         times=3):
        ...   # the next 3 compaction builds raise inside the builder

    faults.arm("compaction.stall", delay_s=0.5)   # one slow build
    faults.arm("delta.overflow", p=0.5, times=8, seed=7)  # burst coin

Fault points registered by the core (see the call sites for exact
semantics):

================== ========================================================
``compaction.build``   raises inside the compaction builder, before the
                       snapshot swap — the build fails, the L0 chain stays
``compaction.stall``   sleeps inside the builder — a slow/stuck build for
                       the watchdog to detect
``compaction.warm``    raises during the post-build readiness warmup
``delta.overflow``     trigger-style (no error): reports the delta as full
                       on an append, forcing an early seal + compaction
``compaction.fold_l1`` raises inside an L0 -> L1 per-shard fold, before any
                       slab is touched — the chain stays queryable
``compaction.promote`` raises at the L1-overflow promotion decision, before
                       the full base rebuild launches
================== ========================================================
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Dict, Optional, Type

from repro_torch import obs

__all__ = [
    "FaultInjected", "register_point", "list_points", "arm", "disarm",
    "disarm_all", "fire", "counters", "injected",
]


class FaultInjected(RuntimeError):
    """Default error raised by an armed fault point."""


class _Armed:
    """Trigger spec + mutable counters for one armed point."""

    def __init__(self, error, delay_s: float, times: Optional[int],
                 after: int, p: float, seed: int):
        self.error = error
        self.delay_s = float(delay_s)
        self.times = None if times is None else int(times)
        self.after = int(after)
        self.p = float(p)
        self.rng = random.Random(seed)
        self.hits = 0      # fire() calls observed while armed
        self.fired = 0     # times the trigger actually went off


_LOCK = threading.Lock()
_POINTS: Dict[str, str] = {}
_ARMED: Dict[str, _Armed] = {}
#: cumulative per-point counters, surviving disarm (tests read them after
#: the context manager exits)
_TOTALS: Dict[str, Dict[str, int]] = {}


def register_point(name: str, description: str) -> str:
    """Declare a fault point. Idempotent; returns ``name`` for reuse."""
    with _LOCK:
        _POINTS[name] = description
        _TOTALS.setdefault(name, {"hits": 0, "fired": 0})
    return name


def list_points() -> Dict[str, str]:
    """All registered fault points, name -> description."""
    with _LOCK:
        return dict(_POINTS)


def arm(point: str, *, error: Optional[Type[BaseException]] = None,
        delay_s: float = 0.0, times: Optional[int] = 1, after: int = 0,
        p: float = 1.0, seed: int = 0) -> None:
    """Arm ``point`` to trigger on upcoming :func:`fire` calls.

    Args:
      error: exception TYPE to raise when the trigger goes off (called
        with a descriptive message). ``None`` makes the point
        trigger-style: :func:`fire` sleeps/returns ``True`` but raises
        nothing — for seams that branch on the return value.
      delay_s: sleep this long when triggered (before raising, if both).
      times: trigger at most this many times, then auto-disarm
        (``None`` = until :func:`disarm`).
      after: skip this many :func:`fire` calls before becoming eligible.
      p: per-call trigger probability, drawn from a ``random.Random(seed)``
        private to this arming — deterministic across runs and immune to
        global-RNG reseeding.
      seed: seed for that coin.
    """
    if point not in _POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; registered: "
            f"{sorted(_POINTS)}")
    if not 0.0 < p <= 1.0:
        raise ValueError(f"p must be in (0, 1], got {p}")
    with _LOCK:
        _ARMED[point] = _Armed(error, delay_s, times, after, p, seed)


def disarm(point: str) -> None:
    """Disarm one point (no-op if it is not armed)."""
    with _LOCK:
        _ARMED.pop(point, None)


def disarm_all() -> None:
    """Disarm every point (test teardown safety net)."""
    with _LOCK:
        _ARMED.clear()


def fire(point: str) -> bool:
    """Production-side seam: trigger the point if a test armed it.

    Returns ``True`` when the trigger went off (after sleeping
    ``delay_s`` and raising ``error`` if one was armed), ``False``
    otherwise — including always-``False`` for the un-armed fast path,
    which is a single locked dict lookup.
    """
    with _LOCK:
        spec = _ARMED.get(point)
        if spec is None:
            return False
        totals = _TOTALS[point]
        spec.hits += 1
        totals["hits"] += 1
        if spec.hits <= spec.after:
            return False
        if spec.times is not None and spec.fired >= spec.times:
            _ARMED.pop(point, None)
            return False
        if spec.p < 1.0 and spec.rng.random() >= spec.p:
            return False
        spec.fired += 1
        totals["fired"] += 1
        if spec.times is not None and spec.fired >= spec.times:
            _ARMED.pop(point, None)
        error, delay = spec.error, spec.delay_s
    # observability: a trigger going off is exactly the kind of rare
    # state transition the event journal exists for — emitted OFF the
    # registry lock (journal takes only its own lock)
    obs.on_fault_fired(point)
    # sleep/raise OUTSIDE the lock: a stalled build must not block other
    # threads' (un-armed) fire() calls
    if delay > 0.0:
        time.sleep(delay)
    if error is not None:
        raise error(f"injected fault at {point!r}")
    return True


def counters() -> Dict[str, Dict[str, int]]:
    """Cumulative ``{point: {"hits": n, "fired": n}}`` since import."""
    with _LOCK:
        return {k: dict(v) for k, v in _TOTALS.items()}


@contextlib.contextmanager
def injected(point: str, **kw):
    """Arm ``point`` for the duration of a ``with`` block, then disarm."""
    arm(point, **kw)
    try:
        yield
    finally:
        disarm(point)


# LSM-ladder seams (DESIGN.md §15), registered here so tests can arm them
# before the LSM ladder is imported (the port's comes with a later slice;
# nothing fires these two yet). The fold seam fires before any L1 slab is
# touched, so an injected failure can never half-apply a fold; the
# promote seam fires at the overflow decision, before the full base
# rebuild launches.
FAULT_FOLD_L1 = register_point(
    "compaction.fold_l1",
    "raise inside an L0 -> L1 per-shard fold, before any slab is touched")
FAULT_PROMOTE = register_point(
    "compaction.promote",
    "raise at the L1-overflow promotion decision, before the full base "
    "rebuild launches")
