"""The port's health probe and NaN provenance on the CPU, after
``tests/test_health.py``: per-layer stats published on their cadence,
the disabled path (no health call), fetches and parameters bit-equal
with the probe on and off, the probe keying the executor's entries, the
stats of a 3-step MLP from carried weights against the JAX package's
probe (rtol 1e-5) and against plain torch norms, ``first_nonfinite_op``
naming the JAX package's op, ``check_nan_inf`` naming the variable, the
step and (probed) the op, a replay that repeats, the stall dump's
snapshot, ``tools/health_report.py`` over the port's JSONL, and the
host-read guard of ``tests/test_torch_capture.py`` flagging nothing in a
step with the monitor, tracing and the probe on.  The captured probe on
the card is a ``cuda`` test of ``test_torch_program_profile.py``, which
imports no JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, monitor, registry
from paddle_tpu_torch.monitor import health, tracing
from paddle_tpu_torch.transpiler import nan_debug

from test_torch_capture import _HostReads
from test_torch_serving import fresh_torch_programs  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean(fresh_torch_programs):  # noqa: F811
    monitor.reset_for_tests()
    yield
    monitor.reset_for_tests()


def _build_mlp(pkg=pt, seed=7, dropout=True):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[8])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=16, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=0.3)
        pred = pkg.layers.fc(h, size=4, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _batches(n, bs=4):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(bs, 8).astype("float32"),
             "label": rng.randint(0, 4, (bs, 1)).astype("int64")}
            for _ in range(n)]


def _run(steps=6, dropout=True, place=None):
    """Fresh seeded program and scope, ``steps`` steps: the loss bytes a
    step, the parameters' bytes after, and the executor."""
    main, startup, loss = _build_mlp(dropout=dropout)
    scope = pt.Scope()
    exe = pt.Executor(place or pt.CPUPlace())
    exe.run(startup, scope=scope)
    out = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           .tobytes() for f in _batches(steps)]
    params = {p.name: scope.find_var(p.name).detach().cpu().numpy().tobytes()
              for p in main.all_parameters()}
    return out, params, exe, main, scope


def test_probe_publishes_per_layer_stats(tmp_path):
    monitor.enable(log_dir=str(tmp_path))
    pt.flags.set_flags({"health": True, "health_every": 2})
    _run(steps=4)
    snap = health.last_snapshot()
    # the startup run is step 0 of the executor (no probe); the entry's
    # runs 0 and 2 publish, at the executor's steps 1 and 3
    assert snap is not None and snap["step"] == 3
    layers = snap["layers"]
    assert set(layers) == {"mlp_col", "mlp_row", "mlp_bias", "norm"}
    for d in layers.values():
        assert np.isfinite(d["grad_norm"]) and d["param_norm"] >= 0
        assert d["nonfinite"] == 0
    assert any(d["update_ratio"] > 0 for d in layers.values())
    label = sorted(layers)[0]
    assert ("health_%s_grad_norm" % label) in monitor.registry().expose_text()
    recs = [json.loads(ln) for f in os.listdir(str(tmp_path))
            for ln in open(os.path.join(str(tmp_path), f))]
    assert [r["step"] for r in recs if r.get("event") == "model_health"] \
        == [1, 3]
    line = health.format_snapshot()
    assert line.startswith("step 3:") and label in line


def test_off_cadence_steps_do_not_publish():
    pt.flags.set_flags({"health": True, "health_every": 100})
    _run(steps=3)
    # only the entry's first run publishes; the ring keeps every step
    assert health.last_snapshot()["step"] == 1
    assert len(health._REPLAY) == 3


def test_disabled_path_performs_zero_health_calls(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("health call on the disabled path")

    for name in ("build_probe", "begin_step", "probe_stats", "note_step",
                 "nan_provenance"):
        monkeypatch.setattr(health, name, boom)
    out, _, _, _, _ = _run(steps=2)
    assert len(out) == 2 and health.last_snapshot() is None


def test_fetches_and_parameters_bit_identical_probe_on_off():
    """Dropout on, Adam: the probe only adds outputs."""
    off, poff, _, _, _ = _run(steps=6)
    pt.flags.set_flags({"health": True, "health_every": 1})
    monitor.enable()
    tracing.enable()
    on, pon, _, _, _ = _run(steps=6)
    assert off == on and poff == pon
    pt.flags.set_flags({"health_every": 3})
    dec, pdec, _, _, _ = _run(steps=6)
    assert off == dec and poff == pdec


def test_flag_flip_makes_new_entries():
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _batches(1)[0]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    n = len(exe._analysis)
    pt.flags.set_flags({"health": True})
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(exe._analysis) == n + 1
    pt.flags.set_flags({"health_every": 7})      # cadence: host side only
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(exe._analysis) == n + 1
    probes = [pr for _, pr in exe._probes.values() if pr is not None]
    assert len(probes) == 1


def test_probe_only_for_programs_that_train():
    main, startup, loss = _build_mlp()
    assert health.build_probe(startup, []) is None
    infer, infer_start = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(infer, infer_start):
        pt.layers.fc(pt.layers.data("x", shape=[8]), size=4)
    names = [p.name for p in main.all_parameters()]
    assert health.build_probe(infer, [p.name for p in
                                      infer.all_parameters()]) is None
    probe = health.build_probe(main, names)
    assert sorted(probe.params) == sorted(names)
    assert all(g.endswith("@GRAD") for g in probe.grad_names)


def test_stats_match_the_jax_probe_from_carried_weights():
    """No dropout (the packages draw different masks): three Adam steps
    from the JAX startup state, every published stat at rtol 1e-5."""
    import paddle_tpu as fluid
    from paddle_tpu.monitor import health as jax_health

    jmain, jstart, jloss = _build_mlp(fluid, dropout=False)
    pmain, pstart, ploss = _build_mlp(pt, dropout=False)
    assert jmain.to_dict() == pmain.to_dict()
    jscope, pscope = fluid.Scope(), pt.Scope()
    fluid.Executor(fluid.CPUPlace()).run(jstart, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in jstart.list_vars() if v.persistable}
    convert.load_numpy_state(pscope, pstart, state, "cpu")
    snaps = []
    try:
        fluid.set_flags({"FLAGS_health": True, "FLAGS_health_every": 1})
        pt.flags.set_flags({"health": True, "health_every": 1})
        jexe, pexe = fluid.Executor(fluid.CPUPlace()), \
            pt.Executor(pt.CPUPlace())
        for feed in _batches(3):
            jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
            pexe.run(pmain, feed=feed, fetch_list=[ploss], scope=pscope)
            snaps.append((jax_health.last_snapshot(),
                          health.last_snapshot()))
    finally:
        fluid.set_flags({"FLAGS_health": False, "FLAGS_health_every": 10})
        jax_health._clear_for_tests()
    for want, got in snaps:
        assert want["step"] == got["step"]
        assert set(want["layers"]) == set(got["layers"])
        for label, d in want["layers"].items():
            for k in ("grad_norm", "param_norm", "update_ratio"):
                np.testing.assert_allclose(got["layers"][label][k], d[k],
                                           rtol=1e-5, err_msg=label + k)
            assert got["layers"][label]["nonfinite"] == d["nonfinite"]


def test_stats_equal_plain_torch_norms():
    """The probe's stats of one step against torch norms of the same
    gradients and of the parameters before and after it (the card's
    gate holds the captured probe the same way)."""
    main, startup, loss = _build_mlp(dropout=False)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    before = {n: scope.find_var(n).clone() for n in names}
    pt.flags.set_flags({"health": True, "health_every": 1})
    feed = _batches(1)[0]
    grads = exe.run(main, feed=feed, fetch_list=[n + "@GRAD" for n in names],
                    scope=scope)
    snap = health.last_snapshot()
    probe = health.build_probe(main, names)
    for label in probe.labels:
        members = probe.layers[label]
        g2 = sum(float((torch.from_numpy(grads[names.index(p)]) ** 2).sum())
                 for p, _ in members)
        p2 = sum(float((scope.find_var(p) ** 2).sum()) for p, _ in members)
        u2 = sum(float(((scope.find_var(p) - before[p]) ** 2).sum())
                 for p, _ in members)
        d = snap["layers"][label]
        np.testing.assert_allclose(d["grad_norm"], np.sqrt(g2), rtol=1e-5)
        np.testing.assert_allclose(d["param_norm"], np.sqrt(p2), rtol=1e-5)
        np.testing.assert_allclose(d["update_ratio"],
                                   np.sqrt(u2) / (np.sqrt(p2) + 1e-12),
                                   rtol=1e-5)


def _poison(scope, name="fc_0.w_0"):
    w = scope.find_var(name)
    w.view(-1)[0] = float("nan")


def test_first_nonfinite_op_names_the_jax_packages_op():
    import paddle_tpu as fluid
    from paddle_tpu.transpiler import nan_debug as jax_nan_debug

    jmain, jstart, _ = _build_mlp(fluid, dropout=False)
    pmain, pstart, _ = _build_mlp(pt, dropout=False)
    jscope, pscope = fluid.Scope(), pt.Scope()
    fluid.Executor(fluid.CPUPlace()).run(jstart, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in jstart.list_vars() if v.persistable}
    state["fc_0.w_0"][0, 0] = np.nan
    jscope.set_var("fc_0.w_0", state["fc_0.w_0"])
    convert.load_numpy_state(pscope, pstart, state, "cpu")
    feed = _batches(1)[0]
    want = jax_nan_debug.first_nonfinite_op(jmain, feed, jscope)
    got = nan_debug.first_nonfinite_op(pmain, feed, pscope)
    assert want["op_type"] == got["op_type"] == "mul"
    assert want["out_var"] == got["out_var"] == "fc_0.tmp_0"
    assert want["op_index"] == got["op_index"] == 0
    assert got["in_vars"] == ["fc_0.w_0"]
    # the walk updated no parameter of the scope
    assert np.isnan(pscope.find_var("fc_0.w_0").numpy()[0, 0])
    assert np.array_equal(pscope.find_var("fc_1.w_0").numpy(),
                          state["fc_1.w_0"])


def test_check_nan_inf_names_first_and_remaining_vars():
    pt.flags.set_flags({"check_nan_inf": True})
    main, startup, loss = _build_mlp(dropout=False)
    pred = [op.outputs["Out"][0] for op in main.global_block().ops
            if op.type == "softmax"][0]
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    batches = _batches(3)
    exe.run(main, feed=batches[0], fetch_list=[loss, pred], scope=scope)
    _poison(scope)
    with pytest.raises(RuntimeError) as ei:
        exe.run(main, feed=batches[1], fetch_list=[loss, pred], scope=scope)
    msg = str(ei.value)
    assert "check_nan_inf: variable '%s' contains nan after step 2" \
        % loss.name in msg
    assert "more non-finite" in msg


def test_check_nan_inf_gains_provenance_when_probed():
    pt.flags.set_flags({"check_nan_inf": True, "health": True})
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    batches = _batches(3)
    exe.run(main, feed=batches[0], fetch_list=[loss], scope=scope)
    _poison(scope)
    with pytest.raises(RuntimeError) as ei:
        exe.run(main, feed=batches[1], fetch_list=[loss], scope=scope)
    assert "first non-finite op: mul -> 'fc_0.tmp_0' (op #0, layer " \
        "mlp_col)" in str(ei.value)


def test_provenance_replay_is_deterministic():
    pt.flags.set_flags({"health": True, "health_every": 1})
    main, startup, loss = _build_mlp()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    for f in _batches(2):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    _poison(scope, "fc_1.w_0")
    a = health.nan_provenance(2)
    b = health.nan_provenance(2)
    for rec in (a, b):
        rec.pop("replay_ms")
    assert a == b and a["found"] and a["out_var"] == "fc_1.tmp_0"
    assert a["layer"] == "mlp_row"
    bad = {"x": np.full((4, 8), np.nan, "float32"),
           "label": np.zeros((4, 1), "int64")}
    c = health.nan_provenance(1, feed=(list(bad), list(bad.values())))
    assert c["found"] and c["op_index"] == 0 and c["in_vars"] == ["x"]


def test_stall_probe_includes_last_health_snapshot():
    pt.flags.set_flags({"health": True, "health_every": 1})
    _run(steps=2)
    probe = monitor._stall_probe()
    assert probe["health"] is not None and probe["health"]["layers"]


def test_health_report_tool_renders_the_ports_log(tmp_path):
    monitor.enable(log_dir=str(tmp_path))
    pt.flags.set_flags({"health": True, "health_every": 1})
    _run(steps=3)
    monitor.disable()
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "health_report.py"),
         str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr
    assert "grad_norm" in res.stdout and "mlp_col" in res.stdout


def test_observed_step_reads_nothing_on_the_host(monkeypatch):
    """The host-read guard of ``test_torch_capture.py`` over every op
    compute and the probe's in-step work, with the monitor, tracing and
    the probe on: a Transformer-like training step (dropout, Adam)
    reads no value on the host where a graph would freeze it."""
    hits, current = [], [None]
    real_compute = registry.compute_op

    def guarded(tag, fn):
        def run(*a, **k):
            current[0] = tag(*a)
            try:
                with _HostReads(hits, current[0]):
                    return fn(*a, **k)
            finally:
                current[0] = None
        return run

    def flag(what, real):
        def wrapper(*args, **kwargs):
            if current[0] is not None:
                hits.append((current[0], what))
            return real(*args, **kwargs)
        return wrapper

    for name in ("tolist", "numpy", "cpu", "item"):
        monkeypatch.setattr(torch.Tensor, name,
                            flag("Tensor." + name, getattr(torch.Tensor,
                                                           name)))
    monkeypatch.setattr(torch, "from_numpy",
                        flag("torch.from_numpy", torch.from_numpy))
    monkeypatch.setattr(registry, "compute_op",
                        guarded(lambda op, *a: op.type, real_compute))
    monkeypatch.setattr(health, "begin_step",
                        guarded(lambda *a: "health/begin_step",
                                health.begin_step))
    monkeypatch.setattr(health, "probe_stats",
                        guarded(lambda *a: "health/probe_stats",
                                health.probe_stats))
    monitor.enable()
    tracing.enable()
    pt.flags.set_flags({"health": True, "health_every": 1})
    _run(steps=3)
    assert health.last_snapshot()["step"] == 3
    assert hits == []
