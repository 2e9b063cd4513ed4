"""Helpers the port's telemetry tests share (not a test module).

``private_jax_metrics`` and ``private_port_metrics`` put a package's
collector families on a registry of the test's own: each family is cloned
(name, help, labels, buckets) onto a fresh registry and swapped into the
module, with a fresh ``BucketHistogram`` table, for the test's duration.
The engines' and the audit plane's record functions read those module
names when they run, so they record into the clones: both packages start
each test from zero, and the JAX package's own tests later in the same
process (its fleet collector reads live shed, restore and latency
families) see nothing of what these tests drove.
"""

import contextlib
import importlib

from prometheus_client import CollectorRegistry
from prometheus_client.parser import text_string_to_metric_families


def private_jax_metrics(monkeypatch) -> CollectorRegistry:
    from prometheus_client.metrics import Histogram, MetricWrapperBase

    col = importlib.import_module("llmd_kv_cache_tpu.metrics.collector")
    tracing = importlib.import_module("llmd_kv_cache_tpu.telemetry.tracing")
    reg = CollectorRegistry()
    for name, metric in list(vars(col).items()):
        if isinstance(metric, MetricWrapperBase):
            kw = {"buckets": metric._upper_bounds} if isinstance(metric, Histogram) else {}
            monkeypatch.setattr(col, name, type(metric)(
                metric._name, metric._documentation, metric._labelnames, registry=reg, **kw))
    monkeypatch.setattr(col, "_BUCKET_HISTOGRAMS", {})
    reg.register(col._BucketHistogramCollector())
    monkeypatch.setattr(tracing, "_dropped_counter", col.TRACE_DROPPED_SPANS)
    return reg


def private_port_metrics(monkeypatch):
    from llmd_kv_cache_tpu_torch.metrics import collector as col
    from llmd_kv_cache_tpu_torch.metrics.registry import (
        CustomCollector,
        Histogram,
        Registry,
        _Metric,
    )

    reg = Registry()
    for name, metric in list(vars(col).items()):
        if isinstance(metric, _Metric):
            kw = {"buckets": metric._bounds} if isinstance(metric, Histogram) else {}
            monkeypatch.setattr(col, name, type(metric)(
                metric._name, metric._documentation, metric._labelnames, registry=reg, **kw))
    monkeypatch.setattr(col, "_BUCKET_HISTOGRAMS", {})
    reg.register(CustomCollector(col._collect_bucket_histograms))
    tracing = importlib.import_module("llmd_kv_cache_tpu_torch.telemetry.tracing")
    monkeypatch.setattr(tracing, "_dropped_counter", col.TRACE_DROPPED_SPANS)
    return reg


@contextlib.contextmanager
def private_flight_recorders(capacity: int = 4096):
    """A fresh flight recorder in each package for the block's duration,
    then the process-wide ones back (the JAX fleet tests read them)."""
    mods = [importlib.import_module(f"{pkg}.telemetry.flight_recorder")
            for pkg in ("llmd_kv_cache_tpu", "llmd_kv_cache_tpu_torch")]
    saved = [mod._global_recorder for mod in mods]
    for mod in mods:
        mod.set_flight_recorder(mod.FlightRecorder(capacity))
    try:
        yield
    finally:
        for mod, rec in zip(mods, saved):
            mod.set_flight_recorder(rec)


def samples(text: str) -> dict:
    """{(sample name, sorted labels): value} of a text exposition."""
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for fam in text_string_to_metric_families(text) for s in fam.samples}
