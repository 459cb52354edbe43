"""Bounded structured event journal.

The registry (``repro_torch.obs.metrics``) answers "how much/how fast"; the
journal answers "WHAT happened, in what order, against which catalogue
state". Producers emit small structured records — compaction
start/success/fail/retry/backoff, fault-seam firings, admission-ladder
degradations, cache invalidations, epoch bumps, engine traces — and
each record carries whatever join keys the producer knows, in
particular the snapshot ``version`` and mutation ``epoch``: a request
span whose ``dispatch`` stage recorded ``(version, epoch)`` joins the
journal on equality to recover exactly which compactions, mutations and
invalidations shaped the catalogue it scanned (DESIGN.md §14).

Emission is safe from ANY context the producers run in: a locked
dict-append under the journal's own lock, never calling back into
producer code — so the segmented catalogue can emit while holding its
own lock (the invalidation-listener constraint, see
``SegmentedCatalogue.add_invalidation_listener``) and a fault seam can
emit from a background build thread. The journal is bounded
(``capacity`` events, oldest evicted) and carries both a wall-clock
timestamp (for humans and exports) and a monotonic one (for ordering
against span times).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Event", "EventJournal"]


class Event:
    """One journal record: ``kind`` + structured ``fields``."""

    __slots__ = ("ts_unix", "t_mono", "seq", "kind", "fields")

    def __init__(self, seq: int, kind: str, fields: Dict[str, object]):
        self.ts_unix = time.time()
        self.t_mono = time.perf_counter()
        self.seq = seq
        self.kind = kind
        self.fields = fields

    def as_dict(self) -> Dict[str, object]:
        return {"seq": self.seq, "ts_unix": self.ts_unix,
                "t_mono": self.t_mono, "kind": self.kind, **self.fields}

    def __repr__(self) -> str:
        kv = " ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"[{self.seq}] {self.kind}" + (f" {kv}" if kv else "")


class EventJournal:
    """Thread-safe bounded journal with per-kind counters."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._events: "collections.deque[Event]" = collections.deque(
            maxlen=int(capacity))
        self._counts: Dict[str, int] = {}
        self._seq = 0

    def emit(self, kind: str, /, **fields) -> None:
        """Append one event. Cheap (one lock, one deque append) and
        reentrancy-free: never calls producer code, so it is safe under
        any producer lock."""
        if not self.enabled:
            return
        with self._lock:
            self._seq += 1
            self._events.append(Event(self._seq, kind, fields))
            self._counts[kind] = self._counts.get(kind, 0) + 1

    def tail(self, n: int = 20) -> List[Event]:
        """The ``n`` most recent events, oldest first."""
        with self._lock:
            evs = list(self._events)
        return evs[-int(n):]

    def events(self, kind: Optional[str] = None, **match) -> List[Event]:
        """Every retained event, optionally filtered by ``kind`` and by
        field equality (``events("compaction.success", version=3)``)."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        for k, v in match.items():
            evs = [e for e in evs if e.fields.get(k) == v]
        return evs

    def counts(self) -> Dict[str, int]:
        """Cumulative per-kind emit counts (survive ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counts.clear()
            self._seq = 0
