"""A small in-repo metric registry with Prometheus text exposition.

The JAX package puts its families on ``prometheus_client``; the card's
machine has no ``prometheus_client``, so the port keeps this registry of
its own. It covers the slice of the ``prometheus_client`` surface the
ported families use — ``Counter``, ``Gauge`` and ``Histogram`` with label
names and ``labels(...)`` children, custom collectors, and
``get_sample_value`` — and renders the text format 0.0.4 byte for byte as
``prometheus_client.generate_latest`` does: a counter named ``x`` or
``x_total`` is exposed as ``x_total`` beside an ``x_created`` gauge, a
histogram as ``_bucket``/``_count``/``_sum`` plus ``_created``, labels
sorted by name, values in Go float notation.
"""

from __future__ import annotations

import math
import time
from bisect import bisect_left
from typing import Callable, Iterable, Optional, Sequence

from ..utils.lockdep import new_lock

def float_to_go_string(d) -> str:
    """A sample value or bucket bound as the Go client (and
    ``prometheus_client``) writes it: ``+Inf``, ``1e+07``, ``0.001``."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python (positive bounds only).
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


class MetricFamily:
    """One exposed family: ``name``, ``type`` (counter, gauge, histogram),
    help text, and ``samples`` as ``(sample_name, labels, value)``."""

    __slots__ = ("name", "type", "documentation", "samples")

    def __init__(self, name: str, typ: str, documentation: str, samples=None):
        self.name = name
        self.type = typ
        self.documentation = documentation
        self.samples: list[tuple[str, dict, float]] = list(samples or ())


class _Child:
    """One label combination of a family (the family itself when it has no
    labels). Mutations take the family's lock."""

    __slots__ = ("_lock", "created", "value", "bounds", "bucket_counts", "sum", "count")

    def __init__(self, lock, bounds: Sequence[float] = ()):
        self._lock = lock
        self.created = time.time()
        self.value = 0.0
        self.bounds = tuple(bounds)
        self.bucket_counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def observe(self, value: float) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self.sum += value
            self.count += 1
            if idx < len(self.bucket_counts):
                self.bucket_counts[idx] += 1


class _Metric:
    """Shared family machinery: label children, registration, collect."""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (), registry: Optional["Registry"] = None):
        self._name = name
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._lock = new_lock()
        self._children: dict[tuple, _Child] = {}
        self._bounds: tuple = ()
        self._setup()
        self._self = None if self._labelnames else self._new_child()
        (REGISTRY if registry is None else registry).register(self)

    def _setup(self) -> None:
        pass

    def _new_child(self) -> _Child:
        return _Child(self._lock, self._bounds)

    def labels(self, *values) -> _Child:
        if not self._labelnames:
            raise ValueError(f"{self._name} has no labels")
        if len(values) != len(self._labelnames):
            raise ValueError(f"{self._name} takes labels {self._labelnames}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._new_child()
        return child

    def _only(self) -> _Child:
        if self._self is None:
            raise ValueError(f"{self._name} has labels {self._labelnames}; use labels()")
        return self._self

    def _items(self) -> list[tuple[dict, _Child]]:
        if self._self is not None:
            return [({}, self._self)]
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self._labelnames, key)), child) for key, child in items]


class Counter(_Metric):
    """A monotonically increasing family (``prometheus_client.Counter``)."""

    def _setup(self) -> None:
        if self._name.endswith("_total"):
            self._name = self._name[: -len("_total")]

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def collect(self) -> Iterable[MetricFamily]:
        items = self._items()
        yield MetricFamily(self._name + "_total", "counter", self._documentation,
                           [(self._name + "_total", labels, c.value) for labels, c in items])
        if items:  # prometheus_client writes no empty _created family
            yield MetricFamily(self._name + "_created", "gauge", self._documentation,
                               [(self._name + "_created", labels, c.created)
                                for labels, c in items])


class Gauge(_Metric):
    """A value that goes up and down (``prometheus_client.Gauge``)."""

    def set(self, value: float) -> None:
        self._only().set(value)

    def collect(self) -> Iterable[MetricFamily]:
        yield MetricFamily(self._name, "gauge", self._documentation,
                           [(self._name, labels, c.value) for labels, c in self._items()])


class Histogram(_Metric):
    """Fixed-bucket histogram (``prometheus_client.Histogram``); the
    ``+Inf`` bucket is implied."""

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional["Registry"] = None, *, buckets: Sequence[float]):
        bounds = sorted(float(b) for b in buckets)
        if bounds and bounds[-1] == math.inf:
            bounds.pop()
        self._init_bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _setup(self) -> None:
        self._bounds = self._init_bounds

    def observe(self, value: float) -> None:
        self._only().observe(value)

    def collect(self) -> Iterable[MetricFamily]:
        samples, created = [], []
        les = [float_to_go_string(b) for b in self._bounds] + ["+Inf"]
        for labels, c in self._items():
            with self._lock:
                counts = list(c.bucket_counts)
                total, acc = c.count, c.sum
            cum = 0
            for le, n in zip(les, counts + [total - sum(counts)]):
                cum += n
                samples.append((self._name + "_bucket", {**labels, "le": le}, cum))
            samples.append((self._name + "_count", labels, total))
            samples.append((self._name + "_sum", labels, acc))
            created.append((self._name + "_created", labels, c.created))
        yield MetricFamily(self._name, "histogram", self._documentation, samples)
        if created:
            yield MetricFamily(self._name + "_created", "gauge", self._documentation, created)


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


class Registry:
    """Collectors in registration order; each has ``collect()`` yielding
    :class:`MetricFamily` objects."""

    def __init__(self):
        self._lock = new_lock()
        self._collectors: list = []

    def register(self, collector) -> None:
        with self._lock:
            self._collectors.append(collector)

    def collect(self) -> Iterable[MetricFamily]:
        with self._lock:
            collectors = list(self._collectors)
        for collector in collectors:
            yield from collector.collect()

    def get_sample_value(self, name: str, labels: Optional[dict] = None) -> Optional[float]:
        """One sample's value, or None (``prometheus_client``'s test hook)."""
        labels = labels or {}
        for fam in self.collect():
            for sample_name, sample_labels, value in fam.samples:
                if sample_name == name and sample_labels == labels:
                    return value
        return None


REGISTRY = Registry()


def generate_latest(registry: Registry = REGISTRY) -> bytes:
    """The registry in the Prometheus text format 0.0.4 (exemplars, as in
    ``prometheus_client``'s text format, are dropped)."""
    lines = []
    for fam in registry.collect():
        lines.append(f"# HELP {fam.name} {_escape_help(fam.documentation)}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for name, labels, value in fam.samples:
            label_text = ""
            if labels:
                label_text = "{" + ",".join(
                    f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())) + "}"
            lines.append(f"{name}{label_text} {float_to_go_string(value)}")
    return ("\n".join(lines) + "\n").encode() if lines else b""


class CustomCollector:
    """A collector from a function returning families (scrape-time
    bridges such as the bucket histograms')."""

    def __init__(self, fn: Callable[[], Iterable[MetricFamily]]):
        self._fn = fn

    def collect(self) -> Iterable[MetricFamily]:
        return self._fn()
