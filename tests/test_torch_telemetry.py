"""The port's observability modules against the JAX package's.

- ``telemetry.tracing``: W3C ``traceparent`` format and parse on drawn
  inputs; ``RecordedSpan`` wire dicts read by the other package's
  ``from_wire`` in both directions; recording spans, parentage and the
  ring exporter's cursor;
- ``telemetry.flight_recorder``: one record sequence through both rings
  (wrap at capacity, ``export_since``, ``dump_json``), equal apart from
  times; concurrent writers leave whole ``(seq, ts, mono, kind, data)``
  records;
- ``metrics``: ``BucketHistogram`` buckets and percentiles on seeded
  samples; every ported family's exposition, parsed, equal (names, types,
  help, labels, values) to ``prometheus_client``'s exposition of the JAX
  collector after the same calls (counters and histograms by delta; the
  ``_created`` samples are times);
- ``telemetry.audit`` and ``telemetry.workingset``: views after the same
  calls, apart from times;
- a subprocess imports the port's telemetry with ``prometheus_client`` and
  ``opentelemetry`` blocked, records and exposes.
"""

import importlib
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from prometheus_client import generate_latest as jax_generate_latest
from prometheus_client.parser import text_string_to_metric_families

from llmd_kv_cache_tpu.metrics import collector as jax_collector
from llmd_kv_cache_tpu.telemetry import audit as jax_audit
from llmd_kv_cache_tpu.telemetry import tracing as jax_tracing
from llmd_kv_cache_tpu.telemetry import workingset as jax_ws
from llmd_kv_cache_tpu_torch.metrics import collector
from llmd_kv_cache_tpu_torch.metrics import generate_latest
from llmd_kv_cache_tpu_torch.telemetry import audit
from llmd_kv_cache_tpu_torch.telemetry import tracing
from llmd_kv_cache_tpu_torch.telemetry import workingset as ws

from torch_telemetry_helpers import private_jax_metrics, private_port_metrics

# The packages' ``flight_recorder`` names their function; the modules:
jax_fr = importlib.import_module("llmd_kv_cache_tpu.telemetry.flight_recorder")
fr = importlib.import_module("llmd_kv_cache_tpu_torch.telemetry.flight_recorder")
ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": (jax_tracing, jax_fr, jax_collector, jax_audit, jax_ws),
            "port": (tracing, fr, collector, audit, ws)}
HYPOTHESIS = dict(max_examples=200, deadline=None, database=None,
                  suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.fixture(autouse=True)
def registries(monkeypatch) -> dict:
    """Both collectors' families on registries of this test's own."""
    return {"jax": private_jax_metrics(monkeypatch), "port": private_port_metrics(monkeypatch)}


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

@settings(**HYPOTHESIS)
@given(trace_id=st.integers(0, 2**128 - 1), span_id=st.integers(0, 2**64 - 1),
       sampled=st.booleans())
def test_traceparent_format_and_parse_match_jax(trace_id, span_id, sampled):
    header = tracing.format_traceparent(trace_id, span_id, sampled)
    assert header == jax_tracing.format_traceparent(trace_id, span_id, sampled)
    assert tracing.parse_traceparent(header) == jax_tracing.parse_traceparent(header)
    for variant in (header.upper(), f"  {header} ", header[:-1], header + "0",
                    header.replace("-", "_", 1)):
        assert tracing.parse_traceparent(variant) == jax_tracing.parse_traceparent(variant)


@settings(**HYPOTHESIS)
@given(value=st.one_of(st.none(), st.integers(), st.text(max_size=80),
                       st.from_regex(r"[0-9a-fA-F]{2}-[0-9a-f]{32}-[0-9a-f]{16}-[0-9a-f]{2}",
                                     fullmatch=True)))
def test_traceparent_parse_of_drawn_text_matches_jax(value):
    assert tracing.parse_traceparent(value) == jax_tracing.parse_traceparent(value)


def make_span(tm, name="op", parent=7):
    sp = tm.RecordedSpan(name, 0xABC, 0x123, parent,
                         {"n": np.int64(3), "x": np.float32(0.5), "s": "v", "b": True,
                          "obj": object.__name__})
    sp.start_time, sp.end_time, sp.seq = 10.0, 12.5, 4
    sp.set_status("ERROR", "boom")
    return sp


@pytest.mark.parametrize("src,dst", [("port", "jax"), ("jax", "port")])
def test_recorded_span_wire_round_trips_across_packages(src, dst):
    wire = make_span(PACKAGES[src][0]).to_wire()
    assert wire == make_span(PACKAGES[dst][0]).to_wire()
    back = PACKAGES[dst][0].RecordedSpan.from_wire(json.loads(json.dumps(wire)))
    assert back.to_wire() == wire
    assert (back.trace_id, back.span_id, back.parent_span_id) == (0xABC, 0x123, 7)
    root = PACKAGES[src][0].RecordedSpan("root", 1, 2, None)
    assert PACKAGES[dst][0].RecordedSpan.from_wire(root.to_wire()).parent_span_id is None


def traced_tree(tm) -> list:
    """A root span, a child, a remote-parented span and an exception span;
    the exported spans as (name, parent name, attributes, status)."""
    with tm.recording_tracing() as exp:
        with tm.tracer().span("root", a=1) as root:
            assert tm.current_traceparent() == root.traceparent
            with tm.tracer().span("child", b="x") as child:
                child.set_attribute("c", 2.5)
        with tm.tracer().span("remote", parent_traceparent=root.traceparent):
            pass
        with pytest.raises(ValueError):
            with tm.tracer().span("fails"):
                raise ValueError("bad")
        assert tm.current_traceparent() is None
        spans, cursor = exp.drain_since(-1)
        payload = exp.export_since(1)
    assert cursor == 3 and [s["seq"] for s in payload["spans"]] == [2, 3]
    by_id = {s.span_id: s.name for s in spans}
    return [(s.name, by_id.get(s.parent_span_id), s.attributes, s.status,
             s.trace_id == spans[-2].trace_id) for s in spans]


def test_recording_spans_match_jax():
    assert traced_tree(tracing) == traced_tree(jax_tracing)
    assert tracing.tracer().span("off") is tracing._NOOP_CM


@pytest.mark.parametrize("name", ["port", "jax"])
def test_exporter_ring_drops_oldest_and_counts(name, registries):
    tm = PACKAGES[name][0]
    family = "kvtpu_trace_dropped_spans_total"
    before = registries[name].get_sample_value(family)
    exp = tm.InMemorySpanExporter(max_spans=3)
    with tm.recording_tracing(exp):
        for i in range(5):
            with tm.tracer().span(f"s{i}"):
                pass
    assert [s.name for s in exp.spans] == ["s2", "s3", "s4"] and exp.dropped == 2
    assert registries[name].get_sample_value(family) - before == 2
    assert [s.name for s in exp.find("s3")] == ["s3"]


def test_process_identity_stamps_exported_spans():
    got = []
    for tm in (tracing, jax_tracing):
        tm.set_process_identity("pod-7")
        try:
            with tm.recording_tracing() as exp:
                with tm.tracer().span("a"):
                    pass
                with tm.tracer().span("b", process="other"):
                    pass
                got.append([s["attributes"]["process"] for s in exp.export_since()["spans"]])
        finally:
            tm.set_process_identity(None)
    assert got[0] == got[1] == ["pod-7", "other"]


# --------------------------------------------------------------------------
# flight recorder
# --------------------------------------------------------------------------

def recorder_views(fm) -> dict:
    rec = fm.FlightRecorder(capacity=8)
    kinds = [fm.KIND_SCORE, fm.KIND_ENGINE_REQUEST, fm.KIND_AUDIT, fm.KIND_OFFLOAD,
             fm.KIND_RETRY, fm.KIND_SHED, fm.KIND_PROFILE]
    seqs = [rec.record(kinds[i % len(kinds)], {"i": i, "scores": {"p": i / 3}})
            for i in range(13)]
    untimed = lambda recs: [{k: v for k, v in r.items() if k not in ("ts", "mono")}
                            for r in recs]
    dump = json.loads(rec.dump_json())
    views = {"seqs": seqs, "snapshot": untimed(rec.snapshot()),
             "dump": {"capacity": dump["capacity"], "records": untimed(dump["records"])}}
    for since in (-1, 4, 9, 12, 20):
        out = rec.export_since(since)
        views[f"since{since}"] = {**out, "records": untimed(out["records"])}
    rec.clear()
    views["cleared"] = rec.export_since(-1)
    return views


def test_flight_recorder_matches_jax():
    assert recorder_views(fr) == recorder_views(jax_fr)
    assert [getattr(fr, k) for k in dir(jax_fr) if k.startswith("KIND_")] == [
        getattr(jax_fr, k) for k in dir(jax_fr) if k.startswith("KIND_")]
    with pytest.raises(ValueError):
        fr.FlightRecorder(capacity=0)


def test_flight_recorder_concurrent_writers_never_tear():
    """Writers on 4 threads: every record whole, with the real keys
    ``{seq, ts, mono, kind, data}``, its data its writer's."""
    rec = fr.FlightRecorder(capacity=256)

    def writer(t):
        for i in range(500):
            rec.record(fr.KIND_SCORE, {"thread": t, "i": i})

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    snap = rec.snapshot()
    assert len(snap) == 256
    assert all(set(r) == {"seq", "ts", "mono", "kind", "data"} for r in snap)
    assert [r["seq"] for r in snap] == list(range(2000 - 256, 2000))
    assert all(set(r["data"]) == {"thread", "i"} and r["ts"] > 0 for r in snap)


def test_signal_dump_and_failpoint_listener(tmp_path):
    import os
    import signal

    from llmd_kv_cache_tpu_torch.resilience.failpoints import FailpointRegistry

    rec = fr.FlightRecorder(capacity=4)
    rec.record(fr.KIND_DRAIN, {"x": 1})
    target = tmp_path / "dump.json"
    prev = fr.install_signal_dump(signal.SIGUSR2, path=str(target), recorder=rec)
    try:
        os.kill(os.getpid(), signal.SIGUSR2)
    finally:
        signal.signal(signal.SIGUSR2, prev)
    assert json.loads(target.read_text())["records"][0]["data"] == {"x": 1}
    registry = FailpointRegistry()
    old = fr.flight_recorder()
    fr.set_flight_recorder(fr.FlightRecorder(capacity=4))
    try:
        fr.attach_failpoint_listener(registry)
        registry.arm("fp.test", probability=1.0)
        assert registry.should_fire("fp.test")
        assert [r["data"] for r in fr.flight_recorder().snapshot()] == [{"name": "fp.test"}]
    finally:
        fr.set_flight_recorder(old)


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def test_bucket_histogram_matches_jax():
    rng = np.random.default_rng(3)
    samples = rng.lognormal(-5, 2, 500).tolist() + [0.0, 1e-3, 30.0, 1e6]
    bounds = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5, 1.0)
    hists = [m.BucketHistogram("h", "doc", bounds) for m in (collector, jax_collector)]
    for i, x in enumerate(samples):
        for h in hists:
            h.observe(x, trace_id=f"{i:032x}" if i % 7 == 0 else None)
    port, ref = hists
    assert port.snapshot() == ref.snapshot()
    assert (port.count, port.sum) == (ref.count, ref.sum)
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]
    assert [port.percentile(q) for q in qs] == [ref.percentile(q) for q in qs]
    assert [e and e[:2] for e in port.exemplars()] == [e and e[:2] for e in ref.exemplars()]
    port.reset()
    assert port.snapshot()["count"] == 0 and port.percentile(0.5) == 0.0
    with pytest.raises(ValueError):
        collector.BucketHistogram("h", "doc", ())


def parsed(text: str, names: set) -> dict:
    """{family: (type, help, {(sample, labels): value})} of the named
    families (a counter's family name without ``_total``)."""
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name in names:
            out[fam.name] = (fam.type, fam.documentation, {
                (s.name, tuple(sorted(s.labels.items()))): s.value for s in fam.samples})
    return out


class _Result:
    def __init__(self, is_store, success, nbytes, seconds, shed=()):
        self.is_store, self.success = is_store, success
        self.bytes_transferred, self.seconds, self.shed_hashes = nbytes, seconds, list(shed)


class _IO:
    def numa_node(self):
        return 1

    def pinned_staging_workers(self):
        return 3

    def direct_transfers(self):
        return 17


def drive_families(col, group):
    """The record functions of every ported family, the same arguments in
    both packages. ``group`` keys this case's label values apart."""
    col.record_shed("engine.admission", f"shed-{group}")
    col.record_shed("engine.admission", f"brownout-{group}")
    col.record_admission_delay(0.003)
    col.record_admission_delay(-1.0)
    col.record_engine_restore(f"success-{group}", 0.02)
    col.record_engine_restore(f"timeout-{group}")
    col.record_offload_restore(f"SHARED_STORAGE-{group}", 0.07)
    col.record_offload_restore("", 0.001)
    col.record_io_pool_placement(_IO())
    col.record_offload_result(f"M-{group}", _Result(True, True, 4096, 0.5, shed=[1, 2]))
    col.record_offload_result(f"M-{group}", _Result(False, False, 0, 0.25))
    col.record_prefix_cache_delta(5, 3)
    col.record_prefix_cache_delta(0, 0)
    col.record_handoff_request(f"complete-{group}", 0.4)
    col.record_handoff_request(f"fallback-{group}")
    col.record_handoff_chunk(f"landed-{group}")
    col.record_handoff_gauges(3, -2)
    col.record_profile_capture(f"success-{group}")
    col.record_ragged_dispatch(f"pod-{group}", 7, 8)
    col.record_audit_join(f"pod-{group}", 2.5, "stale")
    col.record_audit_join(f"pod-{group}", 0.0, "fresh")
    col.record_audit_regret(f"pod-{group}", 1.5)
    col.record_audit_dropped(4)
    col.ENGINE_POOL_FREE_PAGES.labels(f"full-{group}").set(11)
    col.ENGINE_POOL_CACHED_BLOCKS.labels(f"full-{group}").set(5)
    col.ENGINE_POOL_ORPHAN_PAGES.labels(f"full-{group}").set(2)
    col.ENGINE_POOL_EVICTIONS.labels(f"full-{group}").inc(6)
    col.ENGINE_PREFIX_HIT_BLOCKS.inc(9)
    col.ENGINE_REQUESTS.labels(f"finished-{group}").inc()
    col.ENGINE_DECODE_STEPS.inc(2)
    col.TRACE_DROPPED_SPANS.inc()
    col.WORKINGSET_SAMPLED_TOTAL.inc(12)
    col.WORKINGSET_OVERHEAD_SECONDS.inc(0.125)
    col.WORKINGSET_TRACKED_BLOCKS.set(40)
    col.WORKINGSET_WINDOWS_DROPPED.inc()
    h = col.bucket_histogram(f"kvtpu_test_{group}_seconds", "test histogram", (0.01, 0.1, 1))
    for x in (0.005, 0.05, 0.5, 5.0):
        h.observe(x, trace_id="ab" * 16)


def ported_families(registry) -> set:
    """Every family on the port's registry (counters by their family name,
    as the parser gives them)."""
    return {fam.name for fam in text_string_to_metric_families(
        generate_latest(registry).decode())}


GAUGE_FAMILIES = ("kv_offload_io_numa_node", "kv_offload_io_pinned_staging_workers",
                  "kv_offload_io_direct_transfers_total", "kvtpu_handoff_transfer_queue_depth",
                  "kvtpu_handoff_in_flight_jobs", "kvtpu_engine_kv_pool_free_pages",
                  "kvtpu_engine_kv_pool_cached_blocks", "kvtpu_engine_kv_pool_orphan_pages",
                  "kvtpu_workingset_tracked_blocks")


def test_exposition_of_every_ported_family_matches_prometheus_client(registries):
    group = "expo"
    jax_registry, port_registry = registries["jax"], registries["port"]
    names = ported_families(port_registry) | {f"kvtpu_test_{group}_seconds"}
    # Every BucketHistogram of the engine, the indexer and the audit joiner,
    # made by their owners in both packages.
    from llmd_kv_cache_tpu.scoring import Indexer as JaxIndexer
    from llmd_kv_cache_tpu.telemetry.engine_telemetry import EngineTelemetry as JaxTelemetry
    from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer
    from llmd_kv_cache_tpu_torch.telemetry.engine_telemetry import EngineTelemetry

    for owners in ((EngineTelemetry, Indexer, audit.AuditJoiner),
                   (JaxTelemetry, JaxIndexer, jax_audit.AuditJoiner)):
        for owner in owners:
            owner()
    before = {"port": parsed(generate_latest(port_registry).decode(), names),
              "jax": parsed(jax_generate_latest(jax_registry).decode(), names)}
    drive_families(collector, group)
    drive_families(jax_collector, group)
    after = {"port": parsed(generate_latest(port_registry).decode(), names),
             "jax": parsed(jax_generate_latest(jax_registry).decode(), names)}
    assert f"kvtpu_test_{group}_seconds" in after["port"]
    assert set(after["port"]) <= set(after["jax"])
    created = [n for n in after["port"] if n.endswith("_created")]
    assert created and {n[: -len("_created")] for n in created} <= set(after["port"])
    for name in sorted(after["port"]):
        got, ref = after["port"][name], after["jax"][name]
        assert got[:2] == ref[:2], name  # type and help text
        if name.endswith("_created"):
            assert set(got[2]) >= set(ref[2]) - set(before["jax"].get(name, ("", "", {}))[2])
            continue
        delta = {}
        for pkg, (_, _, vals) in (("port", got), ("jax", ref)):
            base = before[pkg].get(name, ("", "", {}))[2]
            delta[pkg] = {k: v if name in GAUGE_FAMILIES else v - base.get(k, 0.0)
                          for k, v in vals.items()
                          if name in GAUGE_FAMILIES or v != base.get(k, 0.0)}
        assert delta["port"] == pytest.approx(delta["jax"]), name
    assert len(after["port"]) >= 45


def test_exposition_format_is_prometheus_text(registries):
    text = generate_latest(registries["port"]).decode()
    assert text.endswith("\n") and "# TYPE kvtpu_shed_decisions_total counter" in text
    families = list(text_string_to_metric_families(text))
    assert {f.type for f in families} <= {"counter", "gauge", "histogram"}


def test_registry_text_matches_prometheus_client_byte_for_byte():
    """The in-repo registry's exposition against ``prometheus_client``'s on
    the same families and calls (escaped help and label values, labelled
    families with and without children, histograms with and without
    labels), the ``_created`` times aside."""
    import re

    import prometheus_client as pc

    from llmd_kv_cache_tpu_torch.metrics import registry as mr

    def drive(mod, kw):
        mod.Counter("kvtpu_a_total", 'A counter\\ with "q"\nnl', **kw).inc()
        mod.Counter("kvtpu_b_total", "B", ["outcome"], **kw).labels('x"y\\z\nw').inc(2.5)
        mod.Counter("kvtpu_e_total", "E", ["outcome"], **kw)
        mod.Counter("kv_offload_bytes", "bytes", ["medium", "direction"], **kw).labels(
            "S", "store").inc(1024)
        mod.Gauge("kvtpu_g", "G", **kw).set(3)
        mod.Gauge("kvtpu_g2", "G2", ["group"], **kw)
        mod.Histogram("kvtpu_he", "HE", ["x"], buckets=(1.0,), **kw)
        h = mod.Histogram("kvtpu_h_seconds", "H", buckets=(1e-5, 1e-3, 1.0, 5.0, 1e7), **kw)
        for x in (0.002, 1e9, 1e-5):
            h.observe(x)
        mod.Histogram("kvtpu_h2", "H2", ["tier"], buckets=(0.1, 1), **kw).labels("t").observe(0.5)

    ref_registry, port_registry = pc.CollectorRegistry(), mr.Registry()
    drive(pc, {"registry": ref_registry})
    drive(mr, {"registry": port_registry})
    untime = lambda text: re.sub(r"(_created(\{[^}]*\})?) \S+", r"\1 T", text)  # noqa: E731
    assert untime(mr.generate_latest(port_registry).decode()) == untime(
        pc.generate_latest(ref_registry).decode())
    assert port_registry.get_sample_value("kvtpu_h_seconds_count") == 3
    assert port_registry.get_sample_value("kvtpu_b_total", {"outcome": 'x"y\\z\nw'}) == 2.5


def test_registry_float_notation_matches_go():
    from prometheus_client.utils import floatToGoString

    from llmd_kv_cache_tpu_torch.metrics.registry import float_to_go_string

    for x in (0.0, 1.0, 1e-05, 0.001, 1e7, 123456789.0, 2.5e-9, float("inf"), -float("inf"),
              float("nan"), -3.25, 1792323418.929977, 10, 7.0e6):
        assert float_to_go_string(x) == floatToGoString(x)


# --------------------------------------------------------------------------
# audit and working set
# --------------------------------------------------------------------------

class Feedback:
    predicted_blocks = 6.0
    scores = {"pod-a": 6.0, "pod-b": 9.0}
    residency = {"pod-a": 1.0}
    staleness_s = 2.0


def audit_views(am) -> dict:
    log = am.AuditLog(capacity=6, staleness_fn=lambda: 1.5)
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    log.record_prediction(tp, "m", 10, 6.0, {"pod-a": 6.0, "pod-b": 2.0}, {"pod-a": 1.0})
    log.record_outcome(tp, "r1", "pod-a", 10, 4, 1, 5)
    log.record_outcome(None, "r2", "pod-b", 8, 8, 0, 0, feedback=Feedback())
    for i in range(6):  # wraps the ring
        log.record_prediction(f"00-{i:032x}-{'cd' * 8}-01", "m", 4, 1.0, {"pod-a": 1.0})
    untimed = lambda recs: [{k: v for k, v in r.items() if k != "ts"} for r in recs]
    full = log.export_since(-1)
    views = {"export": {**full, "records": untimed(full["records"])},
             "since": untimed(log.export_since(5)["records"]), "debug": log.debug_view()}
    log2 = am.AuditLog()
    log2.record_prediction(tp, "m", 10, 6.0, {"pod-a": 6.0, "pod-b": 9.5})
    log2.record_outcome(tp, "r1", "pod-a", 10, 2, 1, 7)
    log2.record_outcome(None, "r2", "pod-b", 8, 8, 0, 0, feedback=Feedback())
    log2.record_outcome(None, "r3", "pod-c", 8, 8, 0, 0)
    joiner = am.AuditJoiner(stale_threshold_s=1.0)
    views["joins"] = joiner.ingest(log2.export_since(-1)["records"] + [{"kind": "bad"}, None])
    views["joiner"] = joiner.view()
    views["trace_id"] = [am.trace_id_of(x) for x in (tp, "", "00-12", None or "")]
    return views


def test_audit_log_and_joiner_match_jax():
    assert audit_views(audit) == audit_views(jax_audit)


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def workingset_views(wm) -> dict:
    clock = Clock()
    tracker = wm.WorkingSetTracker(
        wm.WorkingSetConfig.from_dict({"sampleRate": 0.5, "windowS": 1.0,
                                       "maxWindows": 2, "maxTrackedBlocks": 64}),
        clock=clock)
    tracker.set_capacity("hbm", 32)
    rng = np.random.default_rng(5)
    for step in range(6):
        keys = [int(k) for k in rng.integers(0, 200, 40)]
        tracker.record_accesses("hbm", keys, hits=step)
        tracker.record_index_lookup(keys[:10], {k: ["a", "b"][: 1 + k % 2] for k in keys[:10]},
                                    hits=3)
        tracker.record_offload_write(keys[10:20])
        tracker.record_offload_read(keys[10:30], hits=5)
        tracker.record_eviction_age(0.1 * step)
        clock.now += 0.6
        tracker.rotate()
    tracker.record_accesses("hbm", ["s1", b"s2", 3])
    timed = ("start_unix", "duration_s", "overhead_s", "overhead_frac")
    out = tracker.export_since(-1)
    windows = [{k: v for k, v in w.items() if k not in timed} for w in out["windows"]]
    debug = {k: v for k, v in tracker.debug_view().items() if k != "overhead_s_total"}
    merged = wm.merge_workingset_windows(out["windows"])
    return {"windows": windows, "cursor": out["next_seq"], "dropped": out["dropped"],
            "debug": debug, "whatif": wm.whatif_table(merged),
            "hit": wm.estimate_hit_ratio({"1": 3, "4": 2}, 5, 2.0),
            "keys": [wm.key64(k) for k in (0, 12345, "abc", b"xyz")],
            "merged": {k: v for k, v in merged.items() if k != "eviction_age"}}


def test_workingset_tracker_matches_jax():
    assert workingset_views(ws) == workingset_views(jax_ws)
    assert ws.WorkingSetConfig.from_dict(None) == ws.WorkingSetConfig()


def test_engine_telemetry_config_from_dict_matches_jax():
    from llmd_kv_cache_tpu.telemetry.engine_telemetry import (
        EngineTelemetryConfig as JaxConfig,
    )
    from llmd_kv_cache_tpu_torch.telemetry.engine_telemetry import EngineTelemetryConfig

    for d in (None, {}, {"ttftBuckets": [0.5, 0.1], "poolGaugeEvery": 4, "flightRecords": False,
                         "profileDir": "/x", "maxFinished": 3, "enabled": False},
              {"itl_buckets": [1], "tpot_buckets": [2], "step_buckets": [3],
               "pool_gauge_every": 2, "profile_dir": "p"}):
        assert vars(EngineTelemetryConfig.from_dict(d)) == vars(JaxConfig.from_dict(d))


# --------------------------------------------------------------------------
# the card's environment: no prometheus_client, no opentelemetry
# --------------------------------------------------------------------------

BLOCKED = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("prometheus_client", "opentelemetry", "jax"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
from llmd_kv_cache_tpu_torch.metrics import generate_latest
from llmd_kv_cache_tpu_torch.metrics.collector import record_shed
from llmd_kv_cache_tpu_torch.models import engine
from llmd_kv_cache_tpu_torch.telemetry import (EngineTelemetry, flight_recorder, init_tracing,
                                               recording_tracing, tracer)
record_shed("engine.admission", "shed")
tel = EngineTelemetry()
tel.on_admitted("r", 2)
tel.on_first_token("r")
tel.on_finish("r")
with recording_tracing() as exp:
    with tracer().span("s"):
        pass
text = generate_latest().decode()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("prometheus_client", "opentelemetry", "jax"))
print(json.dumps({"spans": len(exp.spans), "records": len(flight_recorder().snapshot()),
                  "shed": 'kvtpu_shed_decisions_total{outcome="shed",site="engine.admission"} 1.0'
                  in text, "ttft": "kvtpu_engine_ttft_seconds_count 1.0" in text,
                  "otel": init_tracing(), "leaked": leaked}))
""".replace("import importlib.abc, sys", "import importlib.abc, json, sys")


def test_port_records_and_exposes_without_prometheus_or_opentelemetry():
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"spans": 1, "records": 2, "shed": True, "ttft": True, "otel": False,
                   "leaked": []}
