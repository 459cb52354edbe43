"""Unified metrics registry: counters, gauges, log-scale histograms.

One registry replaces the repo's scattered telemetry (ad-hoc
``ServeStats`` deques, ``trace_totals()`` dicts, fault counters) with a
single primitive family sharing a schema and two exporters:

* :meth:`MetricsRegistry.snapshot` — a JSON-able dict, validated
  against the checked-in ``snapshot.schema.json`` (CI's obs job);
* :meth:`MetricsRegistry.render_prom` — Prometheus text exposition
  (``# HELP`` / ``# TYPE`` / sample lines), scrape-ready.

Design constraints (DESIGN.md §14):

* **Thread-safe, low-overhead recording.** Every instrument guards its
  series map with one lock; a recording is a lock + two dict ops. The
  whole layer must cost < 10% of saturated serving throughput
  (``benchmarks/obs_overhead.py`` gates this), so there is no string
  formatting, no timestamping, and no allocation beyond the first
  observation of a label set on the hot path.
* **Fixed-bucket log-scale histograms.** Latency-shaped quantities span
  four orders of magnitude; power-of-two bucket bounds (the same
  bucketing the compile cache uses for batch sizes) keep the bucket
  count small and the export stable. A histogram can additionally keep
  a bounded ring of raw samples for EXACT percentiles — that ring is
  what the ``ServeStats`` façade's ``p50_us``/``p95_us``/``p99_us``
  read, so migrating the old deques onto this primitive changed no
  observable number.
* **Labels.** Instruments declare label NAMES once (engine, bucket,
  sign, method, ...); recordings pass values as keywords. A label set
  is one series; unknown labels are ignored, missing ones default to
  ``""`` — recording sites stay one-liners.
* **Disable switch.** ``registry.enabled = False`` turns every
  registry-owned instrument into a no-op branch (the overhead
  benchmark's baseline). Standalone instruments (constructed directly,
  e.g. the per-server ``ServeStats`` rings) always record — they ARE
  the pre-obs behaviour the baseline preserves.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log2_buckets",
    "LATENCY_BUCKETS_US", "SECONDS_BUCKETS", "FRACTION_BUCKETS",
    "GAP_BUCKETS", "SIZE_BUCKETS", "validate_snapshot",
    "parse_prom_text",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def log2_buckets(lo: float, hi: float) -> Tuple[float, ...]:
    """Power-of-two bucket bounds from ``lo`` doubling past ``hi``."""
    if not lo > 0 or not hi > lo:
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    bounds: List[float] = []
    b = float(lo)
    while b < hi:
        bounds.append(b)
        b *= 2.0
    bounds.append(b)
    return tuple(bounds)


#: 1us .. ~16.8s — serving latencies (per-batch and per-request)
LATENCY_BUCKETS_US = log2_buckets(1.0, float(1 << 24))
#: ~61us .. 64s — compaction builds and other wall-clock seconds
SECONDS_BUCKETS = log2_buckets(2.0 ** -14, 64.0)
#: ~1e-6 .. 1 — ratios (scored fraction, certified fraction)
FRACTION_BUCKETS = tuple(2.0 ** -i for i in range(20, -1, -1))
#: ~1e-3 .. 1024 — certificate bound gaps (score units)
GAP_BUCKETS = log2_buckets(2.0 ** -10, 1024.0)
#: 1 .. 1024 — batch sizes and other small counts
SIZE_BUCKETS = log2_buckets(1.0, 1024.0)


class _Instrument:
    """Shared plumbing: name/help/label validation, series keying."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (), _registry=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = str(help)
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._lock = threading.Lock()
        self._registry = _registry

    def _recording(self) -> bool:
        reg = self._registry
        return reg is None or reg.enabled

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if not self.label_names:
            return ()
        return tuple(str(labels.get(n, "")) for n in self.label_names)

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.label_names, key))


class Counter(_Instrument):
    """Monotonically increasing per-series float."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (), _registry=None):
        super().__init__(name, help, labels, _registry)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._recording():
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        """Sum across every label set."""
        with self._lock:
            return sum(self._values.values())

    def _series(self) -> List[dict]:
        with self._lock:
            items = sorted(self._values.items())
        return [{"labels": self._label_dict(k), "value": v}
                for k, v in items]

    def _reset(self) -> None:
        with self._lock:
            self._values.clear()


class Gauge(Counter):
    """Last-set per-series float (``set``; ``inc`` also works)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._recording():
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class _HistSeries:
    __slots__ = ("counts", "count", "sum", "ring")

    def __init__(self, n_buckets: int, ring: int):
        self.counts = [0] * (n_buckets + 1)       # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.ring = (collections.deque(maxlen=ring) if ring else None)


class Histogram(_Instrument):
    """Fixed-bucket log-scale histogram, optionally ring-backed.

    ``buckets`` are ascending upper bounds (Prometheus ``le``
    semantics); an implicit ``+Inf`` bucket tops them off. ``ring > 0``
    keeps the last ``ring`` raw observations per series so
    :meth:`percentile` is EXACT over the recent window (the
    ``ServeStats`` façade's contract); with ``ring=0`` percentiles are
    estimated from the bucket upper bounds (export-only histograms).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS_US,
                 ring: int = 0, _registry=None):
        super().__init__(name, help, labels, _registry)
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be strictly ascending for "
                             f"{name!r}")
        self.ring_len = int(ring)
        self._data: Dict[Tuple[str, ...], _HistSeries] = {}

    def _get(self, key: Tuple[str, ...]) -> _HistSeries:
        s = self._data.get(key)
        if s is None:
            s = self._data[key] = _HistSeries(len(self.buckets),
                                              self.ring_len)
        return s

    def observe(self, value: float, **labels) -> None:
        if not self._recording():
            return
        v = float(value)
        key = self._key(labels)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            s = self._get(key)
            s.counts[idx] += 1
            s.count += 1
            s.sum += v
            if s.ring is not None:
                s.ring.append(v)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._data.get(self._key(labels))
            return 0 if s is None else s.count

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._data.get(self._key(labels))
            return 0.0 if s is None else s.sum

    def mean(self, **labels) -> float:
        with self._lock:
            s = self._data.get(self._key(labels))
            if s is None or s.count == 0:
                return 0.0
            return s.sum / s.count

    def ring_values(self, **labels) -> Tuple[float, ...]:
        """Locked snapshot of the raw-sample ring (empty if ``ring=0``)."""
        with self._lock:
            s = self._data.get(self._key(labels))
            return () if s is None or s.ring is None else tuple(s.ring)

    def ring(self, **labels):
        """The live ring deque itself (legacy façade access: the old
        ``ServeStats.lat_us_ring`` attribute was this deque). Appending
        to it directly bypasses the bucket counts — supported for
        back-compat, not recommended."""
        if self.ring_len == 0:
            raise ValueError(f"histogram {self.name!r} keeps no ring")
        with self._lock:
            return self._get(self._key(labels)).ring

    def percentile(self, q: float, **labels) -> float:
        """q-th percentile (0-100). Exact over the ring window when a
        ring is kept; bucket-upper-bound estimate otherwise; 0.0 when
        the series is empty (matching the old empty-ring contract)."""
        with self._lock:
            s = self._data.get(self._key(labels))
            if s is None:
                return 0.0
            if s.ring is not None:
                # the ring, not s.count, decides emptiness here: legacy
                # callers may append to the deque directly via ring()
                vals = sorted(s.ring)
                if not vals:
                    return 0.0
                # linear-interpolated rank, matching np.percentile
                rank = (q / 100.0) * (len(vals) - 1)
                lo = int(rank)
                hi = min(lo + 1, len(vals) - 1)
                frac = rank - lo
                return vals[lo] * (1.0 - frac) + vals[hi] * frac
            if s.count == 0:
                return 0.0
            need = (q / 100.0) * s.count
            cum = 0
            for i, c in enumerate(s.counts):
                cum += c
                if cum >= need and c:
                    return (self.buckets[i] if i < len(self.buckets)
                            else self.buckets[-1])
            return self.buckets[-1]

    def _series(self) -> List[dict]:
        with self._lock:
            items = sorted(self._data.items())
            out = []
            for k, s in items:
                out.append({
                    "labels": self._label_dict(k),
                    "count": s.count,
                    "sum": s.sum,
                    "buckets": {_fmt_bound(b): c for b, c in
                                zip((*self.buckets, float("inf")),
                                    s.counts)},
                })
        return out

    def _reset(self) -> None:
        with self._lock:
            self._data.clear()


def _fmt_bound(b: float) -> str:
    if b == float("inf"):
        return "+Inf"
    if b == int(b) and abs(b) < 1e15:
        return str(int(b))
    return repr(b)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


class MetricsRegistry:
    """Named instruments + the two exporters. ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent at import time; a kind
    or label mismatch on re-registration raises)."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: "collections.OrderedDict[str, _Instrument]" = \
            collections.OrderedDict()

    def _register(self, cls, name: str, help: str,
                  labels: Sequence[str], **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                if m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} label mismatch: "
                        f"{m.label_names} vs {tuple(labels)}")
                return m
            m = cls(name, help, labels, _registry=self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_US,
                  ring: int = 0) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets, ring=ring)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    def reset(self) -> None:
        """Clear every series (instruments stay registered) — test and
        benchmark isolation."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()

    # -- exporters -----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able view of every instrument and series (the shape the
        checked-in ``snapshot.schema.json`` pins)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, dict] = {}
        for m in metrics:
            out[m.name] = {
                "kind": m.kind,
                "help": m.help,
                "labels": list(m.label_names),
                "series": m._series(),
            }
        return {"metrics": out}

    def render_prom(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for s in m._series():
                    base = _prom_labels(s["labels"])
                    cum = 0
                    for bound, c in s["buckets"].items():
                        cum += c
                        lab = _prom_labels({**s["labels"], "le": bound})
                        lines.append(f"{m.name}_bucket{lab} {cum}")
                    lines.append(f"{m.name}_sum{base} {_num(s['sum'])}")
                    lines.append(f"{m.name}_count{base} {s['count']}")
            else:
                for s in m._series():
                    lab = _prom_labels(s["labels"])
                    lines.append(f"{m.name}{lab} {_num(s['value'])}")
        return "\n".join(lines) + "\n"


def _num(v: float) -> str:
    return str(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


# ---------------------------------------------------------------------------
# Snapshot-schema validation + exposition smoke parser (CI's obs job)
# ---------------------------------------------------------------------------

def _check(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"snapshot schema violation at {path}: {msg}")


_TYPES = {"object": dict, "array": list, "string": str,
          "boolean": bool, "number": (int, float), "integer": int}


def _validate(value, schema: dict, path: str) -> None:
    """Minimal JSON-Schema-subset validator: ``type``, ``required``,
    ``properties``, ``additionalProperties`` (a schema), ``items``,
    ``enum``. Enough to pin the snapshot shape without a dependency."""
    t = schema.get("type")
    if t is not None:
        py = _TYPES[t]
        if t == "number":
            _check(isinstance(value, (int, float))
                   and not isinstance(value, bool), path,
                   f"expected number, got {type(value).__name__}")
        elif t == "integer":
            _check(isinstance(value, int) and not isinstance(value, bool),
                   path, f"expected integer, got {type(value).__name__}")
        else:
            _check(isinstance(value, py), path,
                   f"expected {t}, got {type(value).__name__}")
    if "enum" in schema:
        _check(value in schema["enum"], path,
               f"{value!r} not in {schema['enum']}")
    if isinstance(value, dict):
        for req in schema.get("required", ()):
            _check(req in value, path, f"missing required key {req!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties")
        for k, v in value.items():
            if k in props:
                _validate(v, props[k], f"{path}.{k}")
            elif isinstance(extra, dict):
                _validate(v, extra, f"{path}.{k}")
    if isinstance(value, list) and "items" in schema:
        for i, v in enumerate(value):
            _validate(v, schema["items"], f"{path}[{i}]")


def validate_snapshot(snap: dict, schema: Optional[dict] = None) -> dict:
    """Validate a :meth:`MetricsRegistry.snapshot` dict against the
    checked-in schema (``src/repro_torch/obs/snapshot.schema.json`` by
    default). Returns ``snap``; raises ``ValueError`` on violation."""
    if schema is None:
        import importlib.resources as _res
        schema = json.loads(
            _res.files("repro_torch.obs").joinpath("snapshot.schema.json")
            .read_text())
    _validate(snap, schema, "$")
    return snap


def parse_prom_text(text: str) -> Dict[str, float]:
    """Smoke-parse a Prometheus exposition: every non-comment line must
    be ``name[{labels}] value``. Returns ``{sample_name: value}`` (the
    last value wins); raises ``ValueError`` on a malformed line."""
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
        r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
        r' (-?(?:[0-9.e+-]+|Inf|NaN))$')
    out: Dict[str, float] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line or line.startswith("#"):
            continue
        m = sample_re.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line {ln}: {line!r}")
        out[m.group(1) + (m.group(2) or "")] = float(
            m.group(3).replace("Inf", "inf"))
    return out
