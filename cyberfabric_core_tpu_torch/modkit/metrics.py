"""Metrics registry — counters, gauges, histograms with Prometheus text export
(the port's copy of ``modkit/metrics.py``: the same classes, the same text,
the same per-metric locks).

Process-local registry, no external deps; exports the Prometheus text
exposition format. The monitoring module renders it at ``GET /metrics``.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


@dataclass
class Counter:
    name: str
    help: str
    _values: dict[tuple, float] = field(default_factory=dict)
    # per-metric lock: inc/set/observe are read-modify-write on shared dicts
    # hit concurrently by the scheduler thread, worker threads, and scrapes —
    # unlocked, increments under contention are silently lost. One acquire
    # per hot-path call.
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def samples(self) -> list[tuple[dict[str, str], float]]:
        """Point-in-time (labels, value) pairs — the wire-snapshot feed.
        Counters export their CUMULATIVE value: the fleet aggregator merges
        by (host, labels), so cumulative survives heartbeat loss where a
        delta stream would drop increments."""
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            values = sorted(self._values.items())
        for key, v in values:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


@dataclass
class Gauge:
    name: str
    help: str
    _values: dict[tuple, float] = field(default_factory=dict)
    #: scrape-time functions per label set (the labeled variant keeps e.g.
    #: per-device HBM gauges off the unlabeled () key)
    _fns: dict[tuple, "callable"] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def set_function(self, fn, **labels: str) -> None:
        """Lazily evaluated at scrape time (e.g. HBM stats). With labels, the
        sample renders under that label set instead of the bare metric name."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._fns[key] = fn

    def _evaluated(self) -> dict[tuple, float]:
        with self._lock:
            values = dict(self._values)
            fns = list(self._fns.items())
        for key, fn in fns:
            try:
                values[key] = float(fn())
            except Exception:  # noqa: BLE001 — scrape must not fail
                pass
        return values

    def samples(self) -> list[tuple[dict[str, str], float]]:
        """(labels, value) pairs with scrape-time functions evaluated —
        the snapshot sees the same values a local scrape would."""
        return [(dict(k), v) for k, v in sorted(self._evaluated().items())]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for key, v in sorted(self._evaluated().items()):
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


@dataclass
class Histogram:
    name: str
    help: str
    buckets: tuple[float, ...] = _DEFAULT_BUCKETS
    _counts: dict[tuple, list] = field(default_factory=dict)
    _sums: dict[tuple, float] = field(default_factory=dict)
    _totals: dict[tuple, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:  # one acquire covers counts + sum + total
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i in range(idx, len(self.buckets)):
                counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Approximate quantile from bucket counts (upper bound of the bucket)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            total = self._totals.get(key, 0)
            if total == 0:
                return None
            target = q * total
            counts = list(self._counts[key])
        for i, c in enumerate(counts):
            if c >= target:
                return self.buckets[i]
        return self.buckets[-1]

    def samples(self) -> list[tuple[dict[str, str], dict]]:
        """(labels, {buckets, sum, count}) per label set — cumulative bucket
        counts keyed by upper bound, JSON-safe for the heartbeat wire."""
        with self._lock:
            snapshot = [(key, list(self._counts[key]), self._sums[key],
                         self._totals[key]) for key in sorted(self._counts)]
        return [(dict(key),
                 {"buckets": {str(b): c for b, c in zip(self.buckets, counts)},
                  "sum": total_sum, "count": total})
                for key, counts, total_sum, total in snapshot]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            snapshot = [(key, list(self._counts[key]), self._sums[key],
                         self._totals[key]) for key in sorted(self._counts)]
        for key, counts, total_sum, total in snapshot:
            labels = dict(key)
            for bound, c in zip(self.buckets, counts):
                out.append(
                    f"{self.name}_bucket{_fmt_labels({**labels, 'le': str(bound)})} {c}")
            out.append(
                f"{self.name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} "
                f"{total}")
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {total_sum}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {total}")
        return out


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self.started_at = time.time()

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help, tuple(buckets)))

    def _get_or_create(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def render(self) -> str:
        with self._lock:
            lines: list[str] = []
            for name in sorted(self._metrics):
                lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"

    def snapshot(self, prefix: str = "") -> dict[str, dict]:
        """JSON-safe export of every metric whose name starts with ``prefix``:
        ``{name: {type, help, samples}}``. This is what a federated worker
        piggybacks on its heartbeat census — counters cumulative, gauges
        evaluated, histograms as bucket maps — so the gateway can re-render
        the family host-labeled without ever mutating its own registry."""
        with self._lock:
            metrics = [(name, m) for name, m in sorted(self._metrics.items())
                       if name.startswith(prefix)]
        out: dict[str, dict] = {}
        for name, m in metrics:
            kind = type(m).__name__.lower()
            try:
                samples = [[labels, value] for labels, value in m.samples()]
            except Exception:  # noqa: BLE001 — export must not fail a heartbeat
                continue
            out[name] = {"type": kind, "help": m.help, "samples": samples}
        return out


#: process-global default registry (modules grab it via ClientHub or directly)
default_registry = MetricsRegistry()


def bump_counter(name: str, help: str = "", *, n: float = 1.0,
                 **labels: str) -> None:
    """Fire-and-forget counter increment on the default registry: never
    raises (telemetry must not fail a serving/recovery path). Declare the
    metric's help text ONCE at pre-registration (monitoring module) — the
    registry keeps the first help it sees, so hot-path callers pass none.
    ``n`` (keyword-only so it can never be mistaken for a label) bumps by
    more than one — e.g. reclaimed-token counts."""
    try:
        default_registry.counter(name, help).inc(n, **labels)
    except Exception:  # noqa: BLE001
        pass
