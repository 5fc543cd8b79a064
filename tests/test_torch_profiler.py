"""The port's profiler and debugging flags on the CPU, after
``tests/test_profiler_flags.py``: the executor's spans in the exported
chrome trace (under the port's names), the latched enable state, the
summary table and its offline twin ``tools/trace_summary.py`` (run in a
subprocess over the port's trace), marks, thread metadata,
``FLAGS_check_nan_inf`` naming the variable and the step,
``FLAGS_benchmark``'s per-step line, the flags API, the Trainer's spans,
and the ``torch.profiler`` device trace that ``trace_dir`` starts, with
the host spans inside it."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor, profiler
from paddle_tpu_torch.contrib import Trainer

from test_torch_serving import fresh_torch_programs  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def profiler_reset(fresh_torch_programs):  # noqa: F811
    monitor.reset_for_tests()
    profiler.reset_profiler()
    yield
    if profiler._enabled[0]:
        profiler.stop_profiler(profile_path="")
    profiler.reset_profiler()
    monitor.reset_for_tests()


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


def test_executor_spans_appear_in_chrome_trace(tmp_path):
    loss = _build_mlp()
    path = str(tmp_path / "trace.json")
    exe = _started()
    x = np.random.rand(8, 4).astype("float32")
    with profiler.profiler("All", profile_path=path):
        for _ in range(3):
            exe.run(feed={"x": x}, fetch_list=[loss])
    trace = json.load(open(path))
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("executor/run") == 3
    assert names.count("executor/warmup") == 1      # the entry's first run
    assert names.count("executor/dispatch") == 2
    assert "executor/analyze" in names
    step = [e for e in trace["traceEvents"] if e["name"] == "executor/warmup"]
    assert step[0]["args"]["run_id"] == monitor.run_id()
    assert step[0]["args"]["bucket"] == "trace_compile"
    for e in trace["traceEvents"]:
        assert e["ph"] in ("X", "M")
        if e["ph"] == "X":
            assert e["dur"] >= 0


def test_record_event_outside_profiler_is_dropped():
    with profiler.RecordEvent("unprofiled"):
        pass
    with profiler._events_lock:
        assert not profiler._events


def test_span_straddling_stop_profiler_is_kept():
    profiler.start_profiler("CPU")
    ev = profiler.RecordEvent("straddle")
    ev.__enter__()
    profiler.stop_profiler(profile_path="")
    ev.__exit__(None, None, None)
    with profiler._events_lock:
        assert "straddle" in [e["name"] for e in profiler._events]
    ev2 = profiler.RecordEvent("pre_session")
    ev2.__enter__()
    profiler.start_profiler("CPU")
    ev2.__exit__(None, None, None)
    profiler.stop_profiler(profile_path="")
    with profiler._events_lock:
        assert "pre_session" not in [e["name"] for e in profiler._events]


def _fabricate_events():
    with profiler._events_lock:
        for dur in (500.0, 1000.0, 1500.0):
            profiler._events.append({"name": "a", "ts": 0.0, "dur": dur,
                                     "ph": "X", "pid": 1, "tid": 1})
        profiler._events.append({"name": "b", "ts": 0.0, "dur": 10000.0,
                                 "ph": "X", "pid": 1, "tid": 1})


@pytest.mark.parametrize("key,first", [(None, "b"), ("total", "b"),
                                       ("calls", "a"), ("ave", "b"),
                                       ("max", "b")])
def test_print_summary_sorted_key_variants(capsys, key, first):
    _fabricate_events()
    profiler._print_summary(key)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Event")
    assert out[1].split()[0] == first
    with profiler._events_lock:
        events = list(profiler._events)
    profiler._print_summary(key)
    assert capsys.readouterr().out.strip() == \
        profiler.summarize_events(events, key)


def test_summary_format_equals_the_jax_packages():
    """One formatter, two packages: the same events give the same
    table."""
    from paddle_tpu import profiler as jax_profiler

    _fabricate_events()
    with profiler._events_lock:
        events = list(profiler._events)
    for key in (None, "calls", "max"):
        assert profiler.summarize_events(events, key) == \
            jax_profiler.summarize_events(events, key)


def test_mark_event_counting(capsys):
    profiler.mark_event("cache/hit")          # outside a session: dropped
    profiler.start_profiler("CPU")
    for _ in range(3):
        profiler.mark_event("cache/hit")
    profiler.mark_event("cache/miss")
    profiler.stop_profiler(profile_path="")
    row = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("cache/hit")]
    assert row and row[0].split()[2] == "3"
    with profiler._events_lock:
        marks = [e for e in profiler._events if e["name"] == "cache/hit"]
    assert len(marks) == 3 and all(e["dur"] == 0.0 for e in marks)


def test_chrome_trace_thread_metadata(tmp_path):
    profiler.start_profiler("CPU")

    def worker():
        with profiler.RecordEvent("worker_span"):
            pass

    t = threading.Thread(target=worker, name="prefetch-producer-0")
    t.start()
    t.join(timeout=30)
    with profiler.RecordEvent("main_span"):
        pass
    path = str(tmp_path / "trace.json")
    profiler.stop_profiler(profile_path=path)
    trace = json.load(open(path))["traceEvents"]
    meta = [e for e in trace if e["ph"] == "M"]
    assert any(e["name"] == "process_name"
               and e["args"]["name"] == "paddle_tpu_torch" for e in meta)
    tnames = {e["args"]["name"] for e in meta if e["name"] == "thread_name"}
    assert "prefetch-producer-0" in tnames
    span_tids = {e["tid"] for e in trace if e["ph"] == "X"}
    meta_tids = {e["tid"] for e in meta if e["name"] == "thread_name"}
    assert span_tids <= meta_tids


def test_check_nan_inf_catches_injected_nan():
    x = pt.layers.data("x", shape=[2])
    out = pt.layers.log(x)
    exe = pt.Executor(pt.CPUPlace())
    pt.flags.set_flags({"FLAGS_check_nan_inf": True})
    exe.run(feed={"x": np.ones((2, 2), "float32")}, fetch_list=[out])
    with pytest.raises(RuntimeError,
                       match=r"variable '%s' contains nan after step 1"
                       % out.name):
        exe.run(feed={"x": -np.ones((2, 2), "float32")}, fetch_list=[out])
    pt.flags.set_flags({"FLAGS_check_nan_inf": False})
    (v,) = exe.run(feed={"x": -np.ones((2, 2), "float32")},
                   fetch_list=[out])
    assert np.isnan(v).all()


def test_check_nan_inf_names_state_var():
    x = pt.layers.data("x", shape=[2])
    h = pt.layers.fc(x, size=2, act=None)
    loss = pt.layers.mean(pt.layers.log(h))
    pt.optimizer.SGD(learning_rate=1e30).minimize(loss)
    exe = _started()
    pt.flags.set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(RuntimeError, match="check_nan_inf"):
        for _ in range(5):
            exe.run(feed={"x": np.random.rand(4, 2).astype("float32")},
                    fetch_list=[loss])


def test_benchmark_flag_prints_each_step(capsys):
    loss = _build_mlp()
    exe = _started()
    pt.flags.set_flags({"benchmark": True})
    for _ in range(2):
        exe.run(feed={"x": np.ones((2, 4), "float32")}, fetch_list=[loss])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[benchmark] step ")]
    assert len(lines) == 2 and lines[0].endswith(" ms")


def test_flags_api_roundtrip_and_unknown():
    pt.flags.set_flags({"FLAGS_benchmark": True})
    assert pt.flags.get_flags("FLAGS_benchmark")["FLAGS_benchmark"] is True
    pt.flags.set_flags({"benchmark": False})
    assert pt.flags.get_flags(["benchmark"])["benchmark"] is False
    with pytest.raises(KeyError):
        pt.flags.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(KeyError):
        pt.flags.get_flags("nope")
    with pytest.raises(ValueError):
        pt.flags.set_flags({"preflight_oom": "stric"})
    assert pt.flags.flag("preflight_oom") == "auto"


def _run_tool(name, *args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", name)] + list(args),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_trace_summary_cli_reads_the_ports_trace(tmp_path):
    """``tools/trace_summary.py``, unchanged, over the port's chrome
    trace: the run id, the table rows and the marks."""
    loss = _build_mlp()
    path = str(tmp_path / "trace.json")
    exe = _started()
    x = np.random.rand(8, 4).astype("float32")
    with profiler.profiler("CPU", profile_path=path):
        for _ in range(2):
            exe.run(feed={"x": x}, fetch_list=[loss])
    res = _run_tool("trace_summary.py", path, "--sorted_key", "calls")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "run_id %s" % monitor.run_id()
    assert lines[1].startswith("Event")
    row = [ln for ln in lines if ln.startswith("executor/run")][0]
    assert row.split()[2] == "2"
    assert any(ln.startswith("mark/executor/new_entry") for ln in lines)
    # the warm-up step span's bucket hint classifies it offline too
    assert any(ln.startswith("trace_compile") for ln in lines)


def test_trainer_step_spans(tmp_path):
    def train_func():
        x = pt.layers.data("x", shape=[4])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        pred = pt.layers.fc(x, size=2, act="softmax")
        return pt.layers.mean(pt.layers.cross_entropy(pred, label))

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(4):
            yield rng.rand(4).astype("float32"), np.array([1], "int64")

    trainer = Trainer(train_func=train_func, place=pt.CPUPlace(),
                      optimizer_func=lambda: pt.optimizer.SGD(0.01))
    path = str(tmp_path / "t.json")
    with profiler.profiler(profile_path=path):
        trainer.train(num_epochs=1, event_handler=lambda e: None,
                      reader=pt.batch(reader, batch_size=2),
                      feed_order=["x", "label"])
        trainer.save_params(str(tmp_path / "params"))
    names = [e["name"] for e in json.load(open(path))["traceEvents"]]
    assert names.count("trainer/step") == 2
    assert names.count("trainer/checkpoint") == 1
    assert "executor/run" in names


def test_device_trace_holds_the_host_spans(tmp_path):
    """``start_profiler(trace_dir=...)`` runs ``torch.profiler`` (CPU
    activities here) and every ``RecordEvent`` enters
    ``record_function``: the spans share the device trace's timeline."""
    loss = _build_mlp()
    exe = _started()
    d = str(tmp_path / "dev")
    with profiler.profiler("All", profile_path="", trace_dir=d):
        exe.run(feed={"x": np.ones((2, 4), "float32")}, fetch_list=[loss])
    path = profiler.device_trace_path()
    assert os.path.dirname(path) == d
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"executor/run", "executor/warmup"} <= names
    assert profiler._device_trace == [None, None]


def test_trace_events_read_what_prof_events_reads():
    """``trace_events``, the reader of the launch windows' traces, gives
    ``prof.events()``'s names and times event for event (here the host
    events of an MLP's steps and their ``record_function`` spans, the
    only device type on the CPU).  ``prof.events()`` also folds a host op
    into the op of its name that it runs inside (``aten::mean`` calling
    ``aten::mean``): the raw reader keeps both, and device events never
    nest."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loss = _build_mlp()
    exe = _started()
    x = np.random.rand(8, 4).astype("float32")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiler.RecordEvent("step"):
                exe.run(feed={"x": x}, fetch_list=[loss])
    got = sorted((e.name, e.time_range.start, e.time_range.end)
                 for e in profiler.trace_events(prof, DeviceType.CPU))
    want = sorted((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CPU)
    assert len(got) > 100
    extra = collections.Counter(got) - collections.Counter(want)
    assert not collections.Counter(want) - collections.Counter(got)
    for name, a, b in extra:
        assert any(n == name and x <= a and b <= y and (x, y) != (a, b)
                   for n, x, y in got), (name, a, b)
    assert profiler.trace_events(prof, DeviceType.CUDA) == []
