"""The port's monitor (``paddle_tpu_torch.monitor``) on the CPU, after
``tests/test_monitor.py``: registry semantics, StepStats from the port's
executor, JSONL and Prometheus round trips, the HTTP endpoint on
``127.0.0.1`` port 0, the watchdog firing on a stalled pipeline, the
disabled path (nothing recorded, and no call into the monitor in 20
steps), an exporter that cannot start raising at ``enable()``, and the
same scripted metric stream giving the JAX package's exposition text."""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor import (MetricsRegistry, Watchdog, health,
                                      program_profile, tracing)
from paddle_tpu_torch.profiler import RecordEvent, mark_event

from test_torch_serving import fresh_torch_programs  # noqa: F401


@pytest.fixture(autouse=True)
def monitor_reset(fresh_torch_programs):  # noqa: F811
    """Every test starts and ends with the port's monitor, tracing,
    health and profiler state reset and their threads joined."""
    monitor.reset_for_tests()
    yield
    monitor.reset_for_tests()
    pt.profiler.reset_profiler()


def _build_mlp():
    x = pt.layers.data("x", shape=[4])
    y = pt.layers.fc(x, size=3, act="relu")
    loss = pt.layers.mean(y)
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _started():
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    return exe


def _records(path):
    out = []
    for f in sorted(os.listdir(path)):
        if ".jsonl" in f:
            out += [json.loads(ln) for ln in open(os.path.join(path, f))]
    return out


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_semantics():
    r = MetricsRegistry()
    c = r.counter("steps")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = r.gauge("depth")
    g.set(3)
    g.inc()
    g.dec(2)
    assert g.value == 2
    h = r.histogram("lat", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count == 4
    assert h.sum == pytest.approx(5.555)
    assert h.snapshot()["counts"] == [1, 1, 1, 1]


def test_registry_get_or_create_and_type_conflict():
    r = MetricsRegistry()
    assert r.counter("x") is r.counter("x")
    with pytest.raises(TypeError):
        r.gauge("x")
    with pytest.raises(ValueError):
        r.histogram("h", buckets=(1.0,))
        r.histogram("h", buckets=(2.0,))
    assert r.get("nope") is None


def test_expose_text_prometheus_round_trip():
    r = MetricsRegistry()
    r.counter("monitor/steps_total").inc(7)
    r.gauge("queue depth").set(2.5)
    h = r.histogram("step", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 50.0):
        h.observe(v)
    lines = r.expose_text().splitlines()
    assert "# TYPE monitor_steps_total counter" in lines
    assert "monitor_steps_total 7" in lines
    assert "queue_depth 2.5" in lines
    assert 'step_bucket{le="0.1"} 1' in lines
    assert 'step_bucket{le="1"} 2' in lines
    assert 'step_bucket{le="+Inf"} 3' in lines
    assert "step_count 3" in lines
    for ln in lines:
        if not ln.startswith("#"):
            name, val = ln.rsplit(" ", 1)
            float(val)
            assert name


def _script(reg):
    reg.counter("monitor/steps_total").inc(3)
    reg.gauge("serving/queue_depth").set(4)
    h = reg.histogram("span/executor/fetch_sync")
    for v in (0.0001, 0.002, 0.03):
        h.observe(v)
    reg.histogram("lat", buckets=(0.5, 5.0)).observe(1.0)


def test_exposition_text_equals_the_jax_packages():
    """The same scripted metric stream gives the same Prometheus text in
    both packages (the registry is copied, not rewritten)."""
    from paddle_tpu.monitor import MetricsRegistry as JaxRegistry

    ours, theirs = MetricsRegistry(), JaxRegistry()
    _script(ours)
    _script(theirs)
    assert ours.expose_text() == theirs.expose_text()


def test_jsonl_writer_rotates(tmp_path):
    w = monitor.JsonlWriter(str(tmp_path), max_bytes=400, backups=2)
    for i in range(40):
        w.write({"event": "step_stats", "step": i, "pad": "x" * 40})
    w.close()
    files = sorted(os.listdir(str(tmp_path)))
    assert os.path.basename(w.path) in files
    assert any(f.endswith(".1") for f in files)
    assert not any(f.endswith(".3") for f in files)
    for f in files:
        for ln in open(os.path.join(str(tmp_path), f)):
            json.loads(ln)


def test_jsonl_rotation_under_concurrent_writers(tmp_path):
    w = monitor.JsonlWriter(str(tmp_path), max_bytes=500, backups=2)
    errors = []

    def writer(tid):
        try:
            for i in range(200):
                w.write({"event": "step_stats", "thread": tid, "step": i,
                         "pad": "x" * 30})
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    w.close()
    assert not errors
    files = sorted(os.listdir(str(tmp_path)))
    assert any(f.endswith(".1") for f in files)
    n = 0
    for f in files:
        for ln in open(os.path.join(str(tmp_path), f)):
            assert json.loads(ln)["event"] == "step_stats"
            n += 1
    assert n >= 8


def test_http_endpoint_serves_exposition():
    r = MetricsRegistry()
    r.counter("hits").inc(3)
    server = monitor.start_http_server(0, r.expose_text)
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % port, timeout=5).read().decode()
        assert "hits 3" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                "http://127.0.0.1:%d/other" % port, timeout=5)
    finally:
        server.shutdown()
        server.server_close()


def test_http_metrics_content_type_and_run_id():
    """The monitor's own endpoint (``FLAGS_monitor_port``; port 0 is not
    a request for one, so the server is started directly): the
    exposition format version and the run id first."""
    server = monitor.start_http_server(0, monitor.expose_text)
    try:
        port = server.server_address[1]
        assert server.server_address[0] == "127.0.0.1"
        resp = urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % port, timeout=5)
        assert resp.headers.get("Content-Type", "").startswith(
            "text/plain; version=0.0.4")
        assert resp.read().decode().startswith(
            "# run_id %s\n" % monitor.run_id())
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# StepStats from the port's executor
# ---------------------------------------------------------------------------

def test_step_stats_from_three_step_run(tmp_path):
    monitor.enable(log_dir=str(tmp_path))
    loss = _build_mlp()
    exe = _started()
    monitor.registry().reset()
    monitor.step_stats().reset()
    x = np.random.rand(8, 4).astype("float32")
    for _ in range(3):
        exe.run(feed={"x": x}, fetch_list=[loss])
    agg = monitor.step_stats()
    assert agg.steps == 3
    rec = agg.last()
    assert rec["executor"] == "executor"
    assert rec["examples"] == 8
    assert rec["step_seconds"] > 0 and rec["examples_per_sec"] > 0
    assert rec["dispatch_queue_depth"] == 0
    # what the port pays where the JAX package reports its compile cache
    assert set(rec["compile_cache"]) >= {"captures", "replays", "builds"}
    assert rec["compile_cache"]["captures"] == 0     # the CPU never captures
    assert "fetch_sync_wait_s" in rec
    assert rec["device"] == {}                       # no card memory here
    assert monitor.registry().get("monitor/step_seconds").count == 3
    assert monitor.registry().get("monitor/examples_total").value == 24
    assert agg.summary()["steps"] == 3


def test_fifty_step_mlp_run_produces_jsonl_stepstats(tmp_path):
    monitor.enable(log_dir=str(tmp_path))
    loss = _build_mlp()
    exe = _started()
    x = np.random.rand(16, 4).astype("float32")
    for _ in range(50):
        exe.run(feed={"x": x}, fetch_list=[loss])
    files = [f for f in os.listdir(str(tmp_path)) if f.endswith(".jsonl")]
    assert len(files) == 1
    steps = [r for r in _records(str(tmp_path))
             if r.get("event") == "step_stats" and r.get("examples")]
    assert len(steps) == 50
    for r in steps:
        assert r["step_seconds"] >= 0 and r["examples_per_sec"] > 0
        assert "dispatch_queue_depth" in r and "compile_cache" in r
        assert r["fingerprint"] == steps[0]["fingerprint"]
    # the entry's first run is its warm-up; on the CPU, which never
    # captures, every later run of the entry is warm
    assert steps[0]["warm"] is False
    assert all(r["warm"] for r in steps[1:])
    assert monitor.step_stats().summary()["steps_compiled"] >= 1
    assert steps[-1]["step"] > steps[0]["step"]


def test_prefetcher_occupancy_visible_in_stepstats(tmp_path):
    monitor.enable(log_dir=str(tmp_path))
    loss = _build_mlp()
    exe = _started()

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(6):
            yield {"x": rng.rand(4, 4).astype("float32")}

    pf = pt.reader.DevicePrefetcher(reader, place=pt.CPUPlace(), capacity=4)
    with pf:
        for feed in pf:
            exe.run(feed=feed, fetch_list=[loss])
    assert monitor.step_stats().last()["prefetch"]["capacity"] >= 4
    states = [s for s in monitor.queue_states()
              if s.get("kind") == "prefetcher"]
    assert states and states[0]["stopped"]
    assert any(s.get("kind") == "executor" for s in monitor.queue_states())


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_unit_fire_and_rearm():
    fired = []
    w = Watchdog(0.2, sink=fired.append,
                 probe=lambda: {"queues": [{"kind": "executor",
                                            "entries": 3}]})
    w.heartbeat("prefetch/producer")
    assert w.check(now=time.monotonic() + 0.1) is None
    diag = w.check(now=time.monotonic() + 0.5)
    assert diag is not None and fired
    assert diag["event"] == "watchdog_stall"
    assert diag["stalled_for_s"] >= 0.2
    assert diag["queues"][0]["entries"] == 3
    assert "prefetch/producer" in diag["heartbeat_age_s"]
    assert w.check(now=time.monotonic() + 0.55) is None
    assert w.check(now=time.monotonic() + 0.8) is not None
    w.step_completed()
    assert w.check() is None


def test_watchdog_fires_on_stalled_pipeline_within_window(tmp_path):
    """No step completes for longer than the window: the watchdog thread
    fires, and the dump names the executor and the last span.  The wait
    allows 60 windows, for a loaded machine."""
    monitor.enable(log_dir=str(tmp_path), stall_seconds=0.3)
    loss = _build_mlp()
    exe = _started()
    exe.run(feed={"x": np.random.rand(8, 4).astype("float32")},
            fetch_list=[loss])
    stalls = monitor.registry().counter("monitor/watchdog_stalls")
    deadline = time.monotonic() + 18.0
    while stalls.value == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert stalls.value >= 1, "watchdog did not fire"
    dumps = [r for r in _records(str(tmp_path))
             if r.get("event") == "watchdog_stall"]
    assert dumps
    d = dumps[0]
    assert d["stalled_for_s"] >= 0.3
    assert "executor" in {q.get("kind") for q in d.get("queues", [])}
    assert d.get("last_span") is not None
    assert d["last_program"]["fingerprint"]
    assert set(d["compile_cache"]) >= {"captures", "replays", "builds"}


# ---------------------------------------------------------------------------
# enable / disable, and the disabled path
# ---------------------------------------------------------------------------

def test_disabled_monitor_records_nothing():
    assert not monitor.enabled()
    loss = _build_mlp()
    exe = _started()
    exe.run(feed={"x": np.random.rand(4, 4).astype("float32")},
            fetch_list=[loss])
    assert monitor.step_stats().steps == 0
    assert monitor.registry().get("monitor/steps_total") is None
    monitor.mark("nope")
    monitor.observe_span("nope", 1.0)
    assert monitor.registry().get("mark/nope") is None
    assert program_profile.profiles() == []
    assert tracing.spans() == []


def _count_calls(monkeypatch, modules):
    """Wrap every function of ``modules`` with a counter."""
    calls = []
    for mod in modules:
        for name, fn in list(vars(mod).items()):
            if callable(fn) and getattr(fn, "__module__", None) \
                    == mod.__name__ and not isinstance(fn, type):
                def wrapped(*a, _fn=fn, _n=name, **k):
                    calls.append(_n)
                    return _fn(*a, **k)
                monkeypatch.setattr(mod, name, wrapped)
    return calls


def test_disabled_monitor_takes_no_call_in_twenty_steps(monkeypatch):
    """With every flag off a 20-step run (its entry's analysis and
    warm-up included) makes no call into the monitor package."""
    loss = _build_mlp()
    exe = _started()
    calls = _count_calls(monkeypatch, [monitor, health, tracing,
                                       program_profile])
    x = np.random.rand(4, 4).astype("float32")
    for _ in range(20):
        exe.run(feed={"x": x}, fetch_list=[loss])
    assert calls == []


def test_flags_drive_enablement_and_teardown(tmp_path):
    pt.flags.set_flags({"FLAGS_monitor_log_dir": str(tmp_path)})
    assert monitor.enabled()
    pt.flags.set_flags({"FLAGS_monitor_log_dir": ""})
    assert not monitor.enabled()
    monitor.enable(console_seconds=3600.0, stall_seconds=60.0)
    assert monitor.enabled()
    threads = [t for t in (monitor._console._thread,
                           monitor._watchdog._thread)]
    assert all(t.is_alive() and t.daemon for t in threads)
    monitor.disable()
    assert not monitor.enabled()
    assert not any(t.is_alive() for t in threads)


def test_an_exporter_that_cannot_start_raises_at_enable(tmp_path):
    """An unwritable log dir (a file in the way) raises out of enable()
    and leaves the flag at its old value; the monitor does not go
    quiet."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        monitor.enable(log_dir=str(blocker / "logs"))
    assert pt.flags.flag("monitor_log_dir") == ""
    assert monitor._jsonl is None


def test_spans_double_publish_into_monitor_histograms():
    monitor.enable()
    with RecordEvent("unit/span"):
        pass
    h = monitor.registry().get("span/unit/span")
    assert h is not None and h.count == 1
    assert monitor.last_span()[0] == "unit/span"
    mark_event("unit/mark")
    mark_event("unit/mark")
    assert monitor.registry().get("mark/unit/mark").value == 2
    with pt.profiler._events_lock:
        assert not any(e["name"].startswith("unit/")
                       for e in pt.profiler._events)


def test_batch_examples_prefers_batch_dim_var():
    import torch

    from paddle_tpu_torch.executor import _batch_examples

    pt.layers.data("x", shape=[4])
    blk = pt.default_main_program().global_block()
    blk.create_var(name="aaa_scale", shape=[3], dtype="float32")
    feed = {"aaa_scale": torch.zeros(3), "x": torch.zeros(16, 4)}
    assert _batch_examples(blk, ["aaa_scale", "x"], feed) == 16
    assert _batch_examples(blk, ["aaa_scale"], feed) == 3
    assert _batch_examples(blk, [], {}) == 0


def test_registry_reset_while_enabled_rebinds_handles():
    monitor.enable()
    with RecordEvent("gen/span"):
        pass
    loss = _build_mlp()
    exe = _started()
    monitor.registry().reset()
    with RecordEvent("gen/span"):
        pass
    exe.run(feed={"x": np.random.rand(4, 4).astype("float32")},
            fetch_list=[loss])
    assert monitor.registry().get("span/gen/span").count == 1
    assert monitor.registry().get("monitor/steps_total").value == 1
    assert "gen_span" in monitor.expose_text()


def test_console_reporter_formats_summary():
    monitor.enable()
    loss = _build_mlp()
    exe = _started()
    exe.run(feed={"x": np.random.rand(4, 4).astype("float32")},
            fetch_list=[loss])
    rep = monitor.ConsoleReporter(monitor.step_stats(), monitor.registry(),
                                  interval_s=3600)
    line = rep.format_line()
    assert line.startswith("[monitor] steps=")
    assert "step_ms=" in line and "ex/s=" in line


def test_fleet_hooks_name_the_cluster_item():
    for name in ("aggregate", "alerts"):
        with pytest.raises(NotImplementedError, match="A7"):
            getattr(monitor, name)


def test_step_span_names_and_args_in_the_records(tmp_path):
    """The executor's spans under the port's names, with the step span's
    correlation args."""
    monitor.enable()
    loss = _build_mlp()
    exe = _started()
    for _ in range(2):
        exe.run(feed={"x": np.ones((2, 4), "float32")}, fetch_list=[loss])
    reg = monitor.registry()
    for name in ("executor/analyze", "executor/run", "executor/warmup",
                 "executor/dispatch", "executor/h2d_transfer",
                 "executor/fetch_sync"):
        assert reg.get("span/" + name) is not None, name
    assert reg.get("span/executor/capture") is None   # the CPU: no graph
    fp = program_profile.program_fingerprint(pt.default_main_program())
    # compile_cache's (the JAX package's) sha1
    assert re.fullmatch(r"[0-9a-f]{40}", fp)
