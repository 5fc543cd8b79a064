"""The port's goodput ledger on the CPU, after ``tests/test_goodput.py``:
the span classifier under the port's span names, the ledger's gap and
step arithmetic on synthetic timelines (the same streams through the JAX
package's ledger give the same buckets and shares), the registry
publication, the disabled path, the step records' deltas summing to the
wall clock, the Trainer's stamp on an exception, and
``tools/goodput_report.py`` replaying the port's JSONL."""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor
from paddle_tpu_torch.contrib import Trainer
from paddle_tpu_torch.monitor.goodput import (BUCKETS, GoodputLedger,
                                              classify_span)
from paddle_tpu_torch.profiler import RecordEvent

from test_torch_serving import fresh_torch_programs  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def monitor_reset(fresh_torch_programs):  # noqa: F811
    monitor.reset_for_tests()
    yield
    monitor.reset_for_tests()


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------

def test_classifier_table():
    assert classify_span("executor/fetch_sync") == "input_wait"
    assert classify_span("executor/h2d_transfer") == "input_wait"
    # what the port pays where the JAX package traces and compiles
    for name in ("executor/analyze", "executor/capture", "executor/warmup",
                 "cuda/build"):
        assert classify_span(name) == "trace_compile", name
    assert classify_span("checkpoint/snapshot") == "checkpoint_stall"
    assert classify_span("guardian/rollback") == "recovery"
    for name in ("executor/run", "executor/dispatch",
                 "prefetch/h2d_transfer", "checkpoint/save",
                 "trainer/step", "trainer/checkpoint", "serving/batch",
                 "serving/prefill", "serving/decode_step",
                 "serving/speculative_step"):
        assert classify_span(name) is None, name
    assert classify_span("somebody/new_span") is None
    assert BUCKETS == ("compute", "input_wait", "trace_compile",
                       "checkpoint_stall", "recovery", "probe",
                       "pipeline_bubble", "stall_idle", "other")


def test_classifier_bucket_hint_wins():
    assert classify_span("executor/dispatch",
                         {"bucket": "trace_compile"}) == "trace_compile"
    assert classify_span("executor/capture", {"bucket": "compute"}) is None
    assert classify_span("executor/capture",
                         {"bucket": "nonsense"}) == "trace_compile"
    assert classify_span("executor/capture", "a-label") == "trace_compile"
    assert classify_span("user/custom", ["x"]) is None


def test_non_dict_span_args_survive_the_monitored_step():
    monitor.enable()
    with RecordEvent("user/custom", args="label-string"):
        pass
    with RecordEvent("executor/capture", args=("tuple", "args")):
        pass
    assert monitor.goodput_ledger().totals()["trace_compile"] >= 0


# ---------------------------------------------------------------------------
# ledger arithmetic on synthetic timelines, against the JAX ledger
# ---------------------------------------------------------------------------

def _step(ledger, ts, seconds, probe=False):
    rec = {"step_seconds": seconds, "ts": ts}
    if probe:
        rec["probe"] = True
    return ledger.note_step(rec, now=ts)


def _stream_gap(lg):
    lg.note_span("executor/fetch_sync", 2.0, now=1005.0)
    _step(lg, 1007.0, 4.0)
    lg.note_event({"event": "checkpoint_saved", "ts": 1009.0,
                   "seconds": 1.0, "async": False})
    lg.note_span("checkpoint/snapshot", 0.5, now=1008.0)
    _step(lg, 1012.0, 1.0)


def _stream_bubble(lg):
    lg.note_span("executor/h2d_transfer", 1.0, now=1003.0)
    lg.note_span("pipeline/bubble", 1.0,
                 args={"bucket": "pipeline_bubble", "fraction": 0.25},
                 now=1003.9)
    _step(lg, 1004.0, 4.0)
    lg.note_span("executor/h2d_transfer", 4.0, now=1007.9)
    lg.note_span("pipeline/bubble", 1.0,
                 args={"bucket": "pipeline_bubble"}, now=1007.95)
    _step(lg, 1008.0, 4.0)


def _stream_async(lg):
    lg.note_event({"event": "checkpoint_saved", "ts": 1005.0,
                   "seconds": 2.0, "async": True})
    _step(lg, 1010.0, 1.0)


def _stream_replay(lg):
    _step(lg, 1001.0, 1.0)
    lg.note_span("guardian/rollback", 0.5, now=1002.0)
    lg.note_event({"event": "guardian_rollback", "ts": 1002.0,
                   "replay_steps": 2})
    for t in (1003.0, 1004.0, 1005.0):
        _step(lg, t, 1.0)


def _stream_probe(lg):
    _step(lg, 1003.0, 1.0, probe=True)
    _step(lg, 1004.0, 1.0)


def _stream_stall(lg):
    _step(lg, 1001.0, 1.0)
    lg.note_event({"event": "watchdog_stall", "ts": 1007.0,
                   "stalled_for_s": 4.0})
    _step(lg, 1010.0, 1.0)


def _stream_clamp(lg):
    lg.note_span("executor/fetch_sync", 3.0, now=1000.9)
    lg.note_span("executor/h2d_transfer", 1.0, now=1000.95)
    _step(lg, 1001.0, 1.0)


STREAMS = {"gap": _stream_gap, "bubble": _stream_bubble,
           "async": _stream_async, "replay": _stream_replay,
           "probe": _stream_probe, "stall": _stream_stall,
           "clamp": _stream_clamp}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_ledger_matches_the_jax_ledger(name):
    """The same scripted span, event and step stream gives the JAX
    ledger's buckets, shares and counts (ledgers from the same anchor;
    timestamps are the script's)."""
    from paddle_tpu.monitor.goodput import GoodputLedger as JaxLedger

    out = []
    for cls in (GoodputLedger, JaxLedger):
        lg = cls()
        lg.reset(now=1000.0)
        STREAMS[name](lg)
        s = lg.summary(now=1012.0)
        out.append(s)
        assert sum(lg.totals().values()) == pytest.approx(
            max(lg._t_accounted - 1000.0, 0.0))
    assert out[0] == out[1]


def test_ledger_step_and_gap_attribution():
    lg = GoodputLedger()
    lg.reset(now=1000.0)
    lg.note_span("executor/capture", 2.0, now=1005.0)
    _step(lg, 1007.0, 4.0)
    t = lg.totals()
    assert t["other"] == pytest.approx(3.0)
    assert t["trace_compile"] == pytest.approx(2.0)
    assert t["compute"] == pytest.approx(2.0)
    lg.note_event({"event": "checkpoint_saved", "ts": 1009.0,
                   "seconds": 1.0, "async": False})
    lg.note_span("checkpoint/snapshot", 0.5, now=1008.0)
    _step(lg, 1012.0, 1.0)
    t = lg.totals()
    assert t["checkpoint_stall"] == pytest.approx(1.5)
    assert t["compute"] == pytest.approx(3.0)
    assert sum(t.values()) == pytest.approx(12.0)


def test_ledger_summary_tail_is_readonly():
    lg = GoodputLedger()
    lg.reset(now=0.0)
    _step(lg, 1.0, 1.0)
    lg.note_span("checkpoint/snapshot", 0.5, now=2.0)
    s1 = lg.summary(now=4.0)
    assert s1["buckets"]["checkpoint_stall"] == pytest.approx(0.5)
    assert s1["buckets"]["other"] == pytest.approx(2.5)
    assert lg.summary(now=4.0) == s1
    _step(lg, 5.0, 1.0)
    assert sum(lg.totals().values()) == pytest.approx(5.0)


def test_ledger_registry_publication():
    from paddle_tpu_torch.monitor.registry import MetricsRegistry

    reg = MetricsRegistry()
    lg = GoodputLedger(reg)
    lg.reset(now=0.0)
    lg.note_span("executor/capture", 1.0, now=1.5)
    _step(lg, 2.0, 1.0)
    assert reg.get("badput/trace_compile_seconds").value == \
        pytest.approx(1.0)
    assert reg.get("goodput/compute_seconds").value == pytest.approx(0.0)
    assert reg.get("badput/other_seconds").value == pytest.approx(1.0)
    assert reg.get("goodput/wall_seconds").value == pytest.approx(2.0)
    reg.reset()
    _step(lg, 3.0, 1.0)
    assert reg.get("goodput/compute_seconds").value == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# monitor wiring
# ---------------------------------------------------------------------------

def _build_mlp():
    pt.default_main_program().random_seed = 7
    pt.default_startup_program().random_seed = 7
    x = pt.layers.data("x", shape=[8])
    label = pt.layers.data("label", shape=[1], dtype="int64")
    h = pt.layers.fc(x, size=16, act="relu")
    pred = pt.layers.fc(h, size=4, act="softmax")
    return pt.layers.mean(pt.layers.cross_entropy(pred, label))


def _feed():
    return {"x": np.random.rand(4, 8).astype("float32"),
            "label": np.zeros((4, 1), "int64")}


def _events(log_dir):
    out = []
    for p in glob.glob(os.path.join(log_dir, "*.jsonl")):
        with open(p) as f:
            out += [json.loads(ln) for ln in f if ln.strip()]
    return out


def test_disabled_monitor_never_touches_the_ledger():
    loss = _build_mlp()
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    lg = monitor.goodput_ledger()
    orig = (lg.note_span, lg.note_step, lg.note_event)

    def boom(*a, **k):
        raise AssertionError("ledger touched while monitor disabled")

    lg.note_span = lg.note_step = lg.note_event = boom
    try:
        for _ in range(3):
            exe.run(feed=_feed(), fetch_list=[loss])
    finally:
        lg.note_span, lg.note_step, lg.note_event = orig
    assert lg.steps == 0


def test_step_records_carry_goodput_deltas(tmp_path):
    log_dir = str(tmp_path / "logs")
    loss = _build_mlp()
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    monitor.enable(log_dir=log_dir)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    t0 = time.time()
    monitor.goodput_ledger().reset(now=t0)
    for _ in range(3):
        exe.run(feed=_feed(), fetch_list=[loss])
    summ = monitor.goodput_ledger().summary(now=time.time())
    wall = time.time() - t0
    assert abs(sum(summ["buckets"].values()) - wall) <= 0.01 * wall + 0.005
    # the new entry's analysis and warm-up are compile badput
    assert summ["buckets"]["trace_compile"] > 0
    monitor.goodput_stamp()
    assert "goodput_ratio" in monitor.expose_text()
    monitor.disable()
    events = _events(log_dir)
    steps = [e for e in events if e.get("event") == "step_stats"]
    assert steps and any(e.get("goodput") for e in steps)
    final = max((e for e in events if e.get("event") == "goodput"),
                key=lambda e: e.get("wall_seconds") or 0)
    assert set(final["buckets"]) == set(BUCKETS)
    assert 0 < final["goodput_ratio"] <= 1


def test_trainer_stamps_goodput_when_training_raises(tmp_path):
    """The Trainer's end-of-training stamp sits in a ``finally``: a run
    that dies in its event handler still leaves the goodput record."""
    log_dir = str(tmp_path / "logs")
    monitor.enable(log_dir=log_dir)

    def samples():
        rng = np.random.RandomState(0)
        for _ in range(16):
            yield rng.rand(8).astype("float32"), np.array([0], "int64")

    def handler(ev):
        if type(ev).__name__ == "EndStepEvent" and ev.step == 1:
            raise KeyboardInterrupt("stop")

    trainer = Trainer(train_func=_build_mlp, place=pt.CPUPlace(),
                      optimizer_func=lambda: pt.optimizer.Adam(1e-2))
    with pytest.raises(KeyboardInterrupt):
        trainer.train(num_epochs=1, event_handler=handler,
                      reader=pt.batch(samples, batch_size=4),
                      feed_order=["x", "label"])
    monitor.disable()
    assert any(e.get("event") == "goodput" for e in _events(log_dir))


def test_goodput_report_tool_replays_the_ports_log(tmp_path):
    """``tools/goodput_report.py``, unchanged, in a subprocess over the
    port's JSONL: the replayed attribution equals the live stamp."""
    log_dir = str(tmp_path / "logs")
    loss = _build_mlp()
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    monitor.enable(log_dir=log_dir)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    for _ in range(3):
        exe.run(feed=_feed(), fetch_list=[loss])
    live = monitor.goodput_stamp()
    monitor.disable()
    tool = os.path.join(ROOT, "tools", "goodput_report.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, tool, log_dir, "--json"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    replayed = json.loads(res.stdout)
    assert replayed["buckets"] == live["buckets"]
    assert replayed["goodput_ratio"] == live["goodput_ratio"]
    res = subprocess.run([sys.executable, tool, log_dir],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert "goodput ratio" in res.stdout and "trace_compile" in res.stdout


def test_watchdog_stall_dump_includes_goodput_snapshot():
    loss = _build_mlp()
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    monitor.enable(stall_seconds=3600)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    for _ in range(2):
        exe.run(feed=_feed(), fetch_list=[loss])
    from paddle_tpu_torch.monitor import _format_diag, _stall_probe

    diag = _stall_probe()
    gp = diag["goodput"]
    assert gp["recent_steps"] >= 2 and gp["recent_fractions"]
    assert abs(sum(gp["recent_fractions"].values()) - 1.0) < 0.02
    assert "goodput last" in _format_diag(dict(diag, stalled_for_s=1.0))
