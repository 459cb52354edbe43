"""Per-request trace spans for the serving pipeline.

A *trace* is the story of one request: a tree of named *spans*, each
with a monotonic-clock start/end and a small attribute dict. The async
pipeline (the reference's ``serving/pipeline.py``; the port's comes with
the async tier) opens a trace at ``submit()`` and
threads it through every stage, so a sampled request yields

::

    topk.request 1843us  engine=bta version=3 epoch=17
      queue_wait 612us
      coalesce 48us
      route 21us  engine=bta cost_entry=bta|8| predicted_us=310
      dispatch 95us  batch_size=5 bucket=8 sign=nonneg
      device 988us
      harvest 41us
      merge 9us

The (snapshot version, mutation epoch) attributes are the JOIN KEYS
into the event journal (``repro_torch.obs.events``): the compaction event
that produced version ``v`` and the spans that ran against ``v`` share
the value, so "why was this request slow" can be answered against the
catalogue state it actually saw (DESIGN.md §14).

Overhead model: cheap counters are ALWAYS on (the metrics registry);
full span trees are SAMPLED (``Tracer.sample_rate``). An unsampled
request costs one lock + one comparison at submit and nothing
afterwards — ``start_trace`` returns ``None`` and every stage guards on
that. Span timestamps come from ``time.perf_counter()``; stages that
measured a boundary once per micro-batch pass explicit ``start=`` /
``end=`` instead of re-reading the clock per request.

The span store is BOUNDED (``capacity`` finished traces, oldest
evicted) so a long-lived server never grows its tracing footprint.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Trace", "Tracer"]

_ids = itertools.count(1)


class Span:
    """One named, timed node in a trace tree."""

    __slots__ = ("name", "span_id", "parent_id", "t_start", "t_end",
                 "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t_start: float):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.attrs: Dict[str, object] = {}

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, at: Optional[float] = None) -> "Span":
        self.t_end = time.perf_counter() if at is None else at
        return self

    @property
    def duration_s(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return end - self.t_start

    @property
    def duration_us(self) -> float:
        return 1e6 * self.duration_s

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_us:.0f}us, "
                f"attrs={self.attrs})")


class Trace:
    """A span tree for one request. ``spans[0]`` is the root; children
    link to parents by span id. Built by exactly one thread at a time
    (pipeline stages hand the request off through a queue), so no lock
    is needed on the spans list itself."""

    __slots__ = ("trace_id", "name", "spans", "_tracer")

    def __init__(self, name: str, trace_id: int, tracer: "Tracer",
                 start: Optional[float] = None):
        self.trace_id = trace_id
        self.name = name
        self._tracer = tracer
        root = Span(name, next(_ids), None,
                    time.perf_counter() if start is None else start)
        self.spans: List[Span] = [root]

    @property
    def root(self) -> Span:
        return self.spans[0]

    def span(self, name: str, start: Optional[float] = None,
             end: Optional[float] = None, parent: Optional[Span] = None,
             **attrs) -> Span:
        """Add a child span (of the root unless ``parent`` is given).
        With ``end=`` the span is recorded already-closed — the pipeline
        measures stage boundaries once per micro-batch and stamps them
        onto every traced request in the batch."""
        p = self.root if parent is None else parent
        s = Span(name, next(_ids), p.span_id,
                 time.perf_counter() if start is None else start)
        if attrs:
            s.attrs.update(attrs)
        if end is not None:
            s.t_end = end
        self.spans.append(s)
        return s

    def find(self, name: str) -> Optional[Span]:
        for s in self.spans:
            if s.name == name:
                return s
        return None

    def finish(self) -> "Trace":
        """Close the root (if still open), close any still-open child
        spans at the root's end, and hand the trace to the tracer's
        bounded store."""
        if self.root.t_end is None:
            self.root.end()
        for s in self.spans[1:]:
            if s.t_end is None:
                s.t_end = self.root.t_end
        self._tracer._store(self)
        return self

    @property
    def duration_us(self) -> float:
        return self.root.duration_us

    def format_tree(self) -> str:
        """Human-readable indented tree (the example prints this)."""
        children: Dict[Optional[int], List[Span]] = {}
        for s in self.spans:
            children.setdefault(s.parent_id, []).append(s)

        lines: List[str] = []

        def walk(span: Span, depth: int) -> None:
            attrs = " ".join(f"{k}={v}" for k, v in span.attrs.items())
            lines.append(f"{'  ' * depth}{span.name} "
                         f"{span.duration_us:.0f}us"
                         + (f"  {attrs}" if attrs else ""))
            for c in sorted(children.get(span.span_id, []),
                            key=lambda s: s.t_start):
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)


class Tracer:
    """Sampling trace factory + bounded in-memory store of finished
    traces."""

    def __init__(self, capacity: int = 256, sample_rate: float = 1.0,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self._lock = threading.Lock()
        self._done: "collections.deque[Trace]" = collections.deque(
            maxlen=int(capacity))
        self.n_started = 0     # requests seen (sampled or not)
        self.n_sampled = 0

    def start_trace(self, name: str, start: Optional[float] = None,
                    **attrs) -> Optional[Trace]:
        """Begin a trace, or return ``None`` when this request is not
        sampled (deterministic every-Nth sampling: ``sample_rate=0.1``
        keeps exactly every 10th request, not a coin flip — replayable
        and starvation-free at any rate)."""
        if not self.enabled:
            return None
        rate = self.sample_rate
        with self._lock:
            self.n_started += 1
            n = self.n_started
            keep = rate > 0.0 and int(n * rate) > int((n - 1) * rate)
            if keep:
                self.n_sampled += 1
        if not keep:
            return None
        t = Trace(name, n, self, start=start)
        if attrs:
            t.root.attrs.update(attrs)
        return t

    def _store(self, trace: Trace) -> None:
        with self._lock:
            self._done.append(trace)

    def traces(self) -> List[Trace]:
        with self._lock:
            return list(self._done)

    def slowest(self) -> Optional[Trace]:
        with self._lock:
            if not self._done:
                return None
            return max(self._done, key=lambda t: t.duration_us)

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self.n_started = 0
            self.n_sampled = 0
