"""The port's program profiles on the CPU, after
``tests/test_program_profile.py``.  What the JAX package reads from XLA
(flops, bytes, a compile-time memory estimate) the port measures on the
card instead: the warm-up's peak, the capture's seconds and peak, one
replay's device time and launches.  On the CPU an entry still gets a
profile, with those fields None, never zero; the report prints "n/a".
Also: per-program step accounting and metrics, the memory preflight
(warn, strict, off), run-id and fingerprint correlation across the
sinks, ``tools/program_report.py`` over the port's JSONL, and the
watchdog naming the last program.  Three ``cuda`` tests check the
card's fields, a strict preflight refusing a capture and the health probe
inside a captured step (this file imports no JAX)."""

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import monitor, profiler
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.monitor import health, program_profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_profile_state():
    """Fresh default programs, scope and names (this file imports no JAX:
    its ``cuda`` tests run on the card), and the monitor reset."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    monitor.reset_for_tests()
    with pt.scope_guard(pt.Scope()):
        yield
    monitor.reset_for_tests()
    profiler.reset_profiler()
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def _build_mlp(seed=0):
    pt.default_main_program().random_seed = seed
    x = pt.layers.data("x", shape=[4])
    h = pt.layers.fc(x, size=8, act="relu")
    loss = pt.layers.mean(pt.layers.fc(h, size=3))
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _run_steps(loss, steps=3, batch=8, place=None):
    exe = pt.Executor(place or pt.CPUPlace())
    exe.run(pt.default_startup_program())
    x = np.random.RandomState(0).rand(batch, 4).astype("float32")
    for _ in range(steps):
        exe.run(feed={"x": x}, fetch_list=[loss])
    return exe


def _fp():
    return program_profile.program_fingerprint(pt.default_main_program())


def test_cold_run_profiles_the_entry_with_no_device_fields():
    monitor.enable()
    loss = _build_mlp()
    _run_steps(loss, steps=3)
    fp = _fp()
    prof = program_profile.get(fp)
    assert prof is not None and prof.kind == "executor"
    for field in ("flops", "bytes_accessed", "warmup_peak_bytes",
                  "capture_seconds", "peak_capture_bytes",
                  "replay_device_ms", "launches_per_replay",
                  "peak_hbm_bytes"):
        assert getattr(prof, field) is None, field
    acct = program_profile.accounting()[fp]
    assert acct["steps"] == 3 and acct["examples"] == 24
    assert acct["wall_s"] > 0
    reg = monitor.registry()
    assert reg.get("program/%s/steps_total" % fp[:12]).value == 3
    assert reg.get("program/%s/step_seconds" % fp[:12]).count == 3
    assert reg.get("program/%s/examples_total" % fp[:12]).value == 24


def test_two_program_run_report():
    from paddle_tpu_torch.models import transformer

    monitor.enable()
    mlp_loss = _build_mlp()
    _run_steps(mlp_loss, steps=4)
    mlp_fp = _fp()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup):
        words = [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = transformer.transformer(*words, 8, 8, 20, 20, n_layer=1,
                                          n_head=2, d_model=16, d_inner=32,
                                          dropout_rate=0.0)
        pt.optimizer.Adam(1e-3).minimize(cost)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(0)
    for _ in range(2):
        feed = {n: rng.randint(0, 20, (2, 8, 1)).astype("int64")
                for n in ("src_word", "tgt_word", "lbl_word")}
        feed.update({n + "@LEN": np.full(2, 8, "int32")
                     for n in ("src_word", "tgt_word", "lbl_word")})
        exe.run(main, feed=feed, fetch_list=[cost])
    tfm_fp = program_profile.program_fingerprint(main)
    rows = {r["fingerprint"]: r for r in program_profile.report_rows()}
    assert mlp_fp != tfm_fp and {mlp_fp, tfm_fp} <= set(rows)
    assert rows[mlp_fp]["steps"] == 4 and rows[tfm_fp]["steps"] == 2
    assert rows[mlp_fp]["flops_per_step"] is None
    assert rows[mlp_fp]["mfu"] is None
    share = sum(r["wall_share"] for r in rows.values())
    assert share == pytest.approx(1.0, abs=1e-3)
    table = program_profile.render_table(list(rows.values()))
    assert "n/a" in table and mlp_fp[:12] in table


def test_monitor_off_profiles_nothing_by_default():
    assert not program_profile.capture_enabled()
    loss = _build_mlp()
    _run_steps(loss, steps=2)
    assert program_profile.profiles() == []
    assert program_profile.accounting() == {}
    pt.flags.set_flags({"preflight_oom": "warn"})
    assert program_profile.capture_enabled()
    assert program_profile._FORCED[0]


def test_forced_preflight_profiles_an_unmonitored_run():
    pt.flags.set_flags({"preflight_oom": "strict"})
    loss = _build_mlp()
    _run_steps(loss, steps=2)
    assert program_profile.get(_fp()) is not None
    assert program_profile.accounting() == {}     # no monitor: no steps


def _stored(peak):
    prof = program_profile.note_warmup("f" * 64, (("x", (8, 4), "f32"),),
                                       None, peak)
    return prof


def test_preflight_warns_with_the_measured_numbers():
    pt.flags.set_flags({"preflight_oom": "warn",
                        "preflight_hbm_bytes": 1024})
    _stored(1 << 20)
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        program_profile.preflight("f" * 64, (("x", (8, 4), "f32"),), None, 0)
        program_profile.preflight("f" * 64, (("x", (8, 4), "f32"),), None, 0)
    msgs = [str(w.message) for w in ws if "memory preflight" in str(w.message)]
    assert len(msgs) == 1                     # once a signature
    assert "1.0 MiB" in msgs[0] and "1.0 KiB" in msgs[0]
    assert "FLAGS_preflight_hbm_bytes" in msgs[0]


def test_preflight_strict_raises():
    pt.flags.set_flags({"preflight_oom": "strict",
                        "preflight_hbm_bytes": 1024})
    _stored(1 << 20)
    with pytest.raises(program_profile.PreflightOOMError,
                       match="capture was not attempted"):
        program_profile.preflight("f" * 64, (("x", (8, 4), "f32"),), None, 0)
    pt.flags.set_flags({"preflight_hbm_bytes": 1 << 30})
    program_profile.preflight("f" * 64, (("x", (8, 4), "f32"),), None, 0)


@pytest.mark.parametrize("mode,override", [("off", 1024), ("warn", 0)])
def test_preflight_quiet_when_off_or_capacity_unknown(mode, override):
    """"off" never checks; with no override and no card the capacity is
    unknown, so nothing is claimed."""
    pt.flags.set_flags({"preflight_oom": mode,
                        "preflight_hbm_bytes": override})
    _stored(1 << 20)
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        program_profile.preflight("f" * 64, (("x", (8, 4), "f32"),), None, 0)
    assert not [w for w in ws if "preflight" in str(w.message)]


def test_run_id_and_fingerprint_correlate_all_sinks(tmp_path):
    monitor.enable(log_dir=str(tmp_path))
    loss = _build_mlp()
    profiler.start_profiler("CPU")
    _run_steps(loss, steps=2)
    profiler.stop_profiler(profile_path="")
    trace_path = profiler.export_chrome_tracing(str(tmp_path / "t.json"))
    fp, rid = _fp(), monitor.run_id()
    files = [f for f in os.listdir(str(tmp_path)) if f.endswith(".jsonl")]
    records = [json.loads(ln)
               for ln in open(os.path.join(str(tmp_path), files[0]))]
    steps = [r for r in records if r.get("event") == "step_stats"
             and r.get("fingerprint") == fp]
    assert len(steps) == 2 and all(r["run_id"] == rid for r in steps)
    profs = [r for r in records if r.get("event") == "program_profile"
             and r.get("fingerprint") == fp]
    assert profs and profs[0]["run_id"] == rid
    # a field no measurement gave is left out of the record
    assert "flops" not in profs[0] and "capture_seconds" not in profs[0]
    trace = json.load(open(trace_path))
    assert trace["metadata"]["run_id"] == rid
    tagged = [e for e in trace["traceEvents"]
              if e.get("args", {}).get("fingerprint") == fp[:12]]
    assert tagged and all(e["args"]["run_id"] == rid for e in tagged)
    assert {e["name"] for e in tagged} <= {"executor/warmup",
                                           "executor/capture",
                                           "executor/dispatch"}
    text = monitor.expose_text()
    assert text.startswith("# run_id %s\n" % rid)
    assert ("program_%s_steps_total" % fp[:12]) in text


def test_program_report_cli_from_the_ports_jsonl(tmp_path):
    monitor.enable(log_dir=str(tmp_path))
    loss = _build_mlp()
    _run_steps(loss, steps=3)
    fp = _fp()
    live = {r["fingerprint"]: r for r in program_profile.report_rows()}
    monitor.disable()
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "program_report.py"),
         str(tmp_path), "--json", "--run_id", monitor.run_id()],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr
    payload = json.loads(res.stdout)
    rows = {r["fingerprint"]: r for r in payload["programs"]}
    assert payload["devices"] == {}
    assert rows[fp]["steps"] == live[fp]["steps"] == 3
    assert 0 < rows[fp]["wall_share"] <= 1.0


def test_watchdog_stall_diag_names_last_program(tmp_path):
    monitor.enable(log_dir=str(tmp_path))
    loss = _build_mlp()
    _run_steps(loss, steps=2)
    fp = _fp()
    pt.flags.set_flags({"FLAGS_monitor_stall_seconds": 0.2})
    stalls = monitor.registry().counter("monitor/watchdog_stalls")
    deadline = time.monotonic() + 12.0
    while stalls.value == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert stalls.value >= 1
    files = [f for f in os.listdir(str(tmp_path)) if f.endswith(".jsonl")]
    dumps = [json.loads(ln) for ln in open(os.path.join(str(tmp_path),
                                                        files[0]))]
    dumps = [r for r in dumps if r.get("event") == "watchdog_stall"]
    suspect = dumps[0]["last_program"]
    assert suspect["fingerprint"] == fp[:12] and suspect["steps"] == 2
    assert suspect["capture_seconds"] is None


def test_fingerprint_follows_the_program():
    loss = _build_mlp()
    main = pt.default_main_program()
    fp = program_profile.program_fingerprint(main)
    assert program_profile.program_fingerprint(main) == fp
    assert program_profile.program_fingerprint(main.clone()) == fp
    with pt.program_guard(main, pt.default_startup_program()):
        pt.layers.scale(loss, scale=2.0)
    assert program_profile.program_fingerprint(main) != fp


def test_probe_steps_stay_out_of_the_steady_rows():
    program_profile.note_step("a" * 64, 0.5, 8)
    with program_profile.probe_accounting():
        assert program_profile.probe_active()
        program_profile.note_step("a" * 64, 2.0, 8)
    assert program_profile.accounting()["a" * 64]["steps"] == 1
    assert program_profile.probe_totals()["a" * 64]["wall_s"] == 2.0
    rows = program_profile.report_rows()
    assert [r.get("probe", False) for r in rows] == [True, False]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port captures only there")
    return pt.CUDAPlace(0)


@pytest.mark.cuda
def test_captured_entry_profile_on_the_card(card):
    """On the card: the warm-up's and the capture's peaks, the capture's
    seconds, one replay's device time and its launches."""
    monitor.enable()
    loss = _build_mlp()
    _run_steps(loss, steps=3, place=card)
    prof = program_profile.get(_fp())
    assert prof.warmup_peak_bytes > 0 and prof.peak_capture_bytes > 0
    assert prof.capture_seconds > 0 and prof.replay_device_ms > 0
    assert prof.launches_per_replay >= 1 and prof.graphs == 1
    assert monitor.capture_stats()["captures"] == 1


@pytest.mark.cuda
def test_strict_preflight_refuses_the_capture(card):
    pt.flags.set_flags({"preflight_oom": "strict",
                        "preflight_hbm_bytes": 16})
    loss = _build_mlp()
    exe = pt.Executor(card)
    exe.run(pt.default_startup_program())
    x = np.ones((8, 4), "float32")
    exe.run(feed={"x": x}, fetch_list=[loss])              # the warm-up
    with pytest.raises(program_profile.PreflightOOMError):
        exe.run(feed={"x": x}, fetch_list=[loss])
    assert all(st.graphs == 0 for st in exe._steps.values())


@pytest.mark.cuda
def test_captured_probe_on_the_card(card):
    """The health probe inside the captured step: one graph, fetches and
    parameters bit-equal with the probe off, and the replayed stats equal
    to torch norms of the fetched gradients and the parameters."""
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for on in (False, True):
        pt.flags.set_flags({"health": on, "health_every": 1})
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = 7
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            x = pt.layers.data("x", shape=[64])
            h = pt.layers.fc(x, size=128, act="relu")
            loss = pt.layers.mean(pt.layers.fc(h, size=8))
            pt.optimizer.Adam(1e-2).minimize(loss)
        scope, exe = pt.Scope(), pt.Executor(card)
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        rng = np.random.RandomState(0)
        losses = []
        for i in range(4):
            before = {n: scope.find_var(n).double() for n in names}
            out = exe.run(main, feed={"x": rng.rand(32, 64).astype("f4")},
                          fetch_list=[loss] + [n + "@GRAD" for n in names],
                          scope=scope, return_numpy=False)
            losses.append(out[0].cpu().numpy().tobytes())
        runs[on] = (losses, {n: scope.find_var(n).cpu().numpy().tobytes()
                             for n in names})
        graphs = [st.graphs for st in exe._steps.values()]
    assert runs[False] == runs[True]
    assert graphs.count(1) == 1
    snap = health.last_snapshot()
    probe = health.build_probe(main, names)
    grads = dict(zip(names, out[1:]))
    for label in probe.labels:
        g2 = sum(float((grads[p].double() ** 2).sum())
                 for p, _ in probe.layers[label])
        p2 = sum(float((scope.find_var(p).double() ** 2).sum())
                 for p, _ in probe.layers[label])
        u2 = sum(float(((scope.find_var(p).double() - before[p]) ** 2)
                       .sum()) for p, _ in probe.layers[label])
        d = snap["layers"][label]
        np.testing.assert_allclose(d["grad_norm"], g2 ** 0.5, rtol=1e-5)
        np.testing.assert_allclose(d["param_norm"], p2 ** 0.5, rtol=1e-5)
        np.testing.assert_allclose(d["update_ratio"],
                                   u2 ** 0.5 / (p2 ** 0.5 + 1e-12),
                                   rtol=1e-5)
