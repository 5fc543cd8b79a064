"""The port's ``compile_cache.py`` on the CPU: ``program_fingerprint``
against the JAX package's for the same programs built by both, the
capture identity (``trace_flag_values``), the process-global entry cache
(a second executor skips ``executor/analyze``), the persistent kernel
directory behind ``FLAGS_compile_cache_dir`` (checked by the target path
``ops/cuda/build.py`` would build, without ``nvcc``), and the one
fingerprint in profiles, step records and the offline tools."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import compile_cache as jax_cc
from paddle_tpu.contrib import mixed_precision as jax_amp
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch import autotune, compile_cache, flags, monitor
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import profiler
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.contrib import mixed_precision as pt_amp
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.monitor import program_profile
from paddle_tpu_torch.ops.cuda import build

from test_torch_control_flow import while_sum
from test_torch_train import build_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_cache_state():
    """Fresh port programs, scope and name counter, an empty entry cache,
    no rulings, the monitor off, no compile-cache directory."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    pin = flags.pinned("compile_cache_dir")
    compile_cache.clear()
    compile_cache.reset_stats()
    autotune.reset_attention_table()
    with pt.scope_guard(pt.Scope()):
        yield
    flags.set_flags({"compile_cache_dir": "", "autotune_dir": ""},
                    pin=False)
    flags._restore_pins({"compile_cache_dir": pin})
    autotune.reset_attention_table()
    monitor.reset_for_tests()
    profiler.reset_profiler()
    program_profile.reset()
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[16])
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=32, act="relu")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(
            pkg.layers.fc(h, size=4, act="softmax"), y))
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, startup


def _transformer(pkg):
    transformer = jax_transformer if pkg is fluid else pt_transformer
    main, startup, _ = build_train(pkg, transformer, pkg.optimizer, 0.1)
    return main, startup


def _while(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        while_sum(pkg)
    return main, startup


def _both(make):
    out = []
    for pkg in (fluid, pt):
        mod = fluid.unique_name if pkg is fluid else pt_unique_name
        with mod.guard():
            out.append(make(pkg))
    return out


@pytest.mark.parametrize("make", [_mlp, _transformer, _while],
                         ids=["mlp", "transformer_2+2", "sub_block"])
def test_fingerprint_equals_jax(make):
    (jm, js), (tm, ts) = _both(make)
    for jp, tp in ((jm, tm), (js, ts)):
        assert compile_cache.program_fingerprint(tp) == \
            jax_cc.program_fingerprint(jp)
    # the memo follows structural mutation
    fp = compile_cache.program_fingerprint(tm)
    tm.global_block().create_var(name="extra", shape=(1,),
                                 dtype="float32")
    tm._version += 1
    assert compile_cache.program_fingerprint(tm) != fp


def test_amp_program_fingerprint():
    """Under AMP both packages hash the program's JSON plus the policy's
    repr.  The JAX package's policy has the default object repr (its
    address), so its AMP fingerprint is stable only within a process; the
    port's repr names the lists, so equal policies give one fingerprint,
    and without the policy the digests are the JAX package's."""
    def make(pkg):
        main, startup = _mlp(pkg)
        return main
    jm, tm = _both(make)
    plain = compile_cache.program_fingerprint(tm)
    assert plain == jax_cc.program_fingerprint(jm)
    with pt_amp.bf16_program_guard(tm):
        a = compile_cache.program_fingerprint(tm)
    with pt_amp.bf16_program_guard(tm):
        b = compile_cache.program_fingerprint(tm)
    with jax_amp.bf16_program_guard(jm):
        j = jax_cc.program_fingerprint(jm)
    assert a == b != plain and j != plain
    assert "AMPPolicy(white=" in repr(pt_amp.AMPPolicy())
    assert compile_cache.program_fingerprint(tm) == plain


def test_trace_flag_values_follow_rulings_guard_and_probe():
    prog = pt.default_main_program()
    t0 = compile_cache.trace_flag_values(prog)
    assert t0 == (None, False, False, ())
    autotune.attention_table().record("", "T8:K8:d64:float32", False,
                                      persist=False)
    t1 = compile_cache.trace_flag_values(prog)
    assert t1 != t0 and t1[3] == autotune.trace_token()
    flags.set_flags({"health": True}, pin=False)
    try:
        assert compile_cache.trace_flag_values(prog)[2] is True
    finally:
        flags.set_flags({"health": False}, pin=False)


def _fc_step():
    x = pt.layers.data("x", shape=[4])
    loss = pt.layers.mean(pt.layers.fc(x, size=3, act="relu"))
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def test_second_executor_hits_the_cache_and_skips_analysis():
    loss = _fc_step()
    feed = {"x": np.ones((2, 4), "float32")}
    monitor.enable()
    reg = monitor.registry()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    exe.run(feed=feed, fetch_list=[loss])
    analyzed = reg.get("span/executor/analyze").count
    hits = compile_cache.stats()["trace_hits"]
    exe2 = pt.Executor(pt.CPUPlace())
    out2 = exe2.run(feed=feed, fetch_list=[loss])
    assert reg.get("span/executor/analyze").count == analyzed
    st = compile_cache.stats()
    assert st["trace_hits"] == hits + 1
    assert reg.get("mark/compile_cache/hit").value >= 1
    assert reg.get("mark/compile_cache/miss").value >= 2
    # each executor holds its own entry over the one cached analysis
    main_id = id(pt.default_main_program())
    (k1,) = [k for k in exe._analysis if k[0] == main_id]
    (k2,) = exe2._analysis
    assert k1 == k2 and exe._analysis[k1] is not exe2._analysis[k2]
    assert exe._analysis[k1] == exe2._analysis[k2]
    # another signature or fetch list is another analysis
    exe2.run(feed={"x": np.ones((3, 4), "float32")}, fetch_list=[loss])
    assert reg.get("span/executor/analyze").count == analyzed + 1
    assert np.isfinite(out2[0]).all()
    assert 0 < st["hit_ratio"] < 1


def test_cached_analysis_still_names_a_missing_var():
    loss = _fc_step()
    feed = {"x": np.ones((2, 4), "float32")}
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    exe.run(feed=feed, fetch_list=[loss])
    with pytest.raises(RuntimeError, match="neither fed"):
        pt.Executor(pt.CPUPlace()).run(feed=feed, fetch_list=[loss],
                                       scope=pt.Scope())


def test_a_ruling_between_runs_is_a_new_entry():
    loss = _fc_step()
    feed = {"x": np.ones((2, 4), "float32")}
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    exe.run(feed=feed, fetch_list=[loss])
    exe.run(feed=feed, fetch_list=[loss])
    assert len(exe._analysis) == 2      # startup and the step
    autotune.quant_kernel_table().record("", "M2:K4:N3:float32:dynamic",
                                         False, persist=False)
    exe.run(feed=feed, fetch_list=[loss])
    keys = [k for k in exe._analysis if k[0] == id(
        pt.default_main_program())]
    assert len(keys) == 2 and keys[0][7] != keys[1][7]


def test_enable_persistent_cache_points_the_build(tmp_path):
    name = build.kernel_names()[0]
    default = build._target(name)
    assert os.path.dirname(default) == build.BUILD_DIR
    d = str(tmp_path / "kernels")
    flags.set_flags({"compile_cache_dir": d}, pin=False)
    assert compile_cache.persistent_dir() == d
    assert compile_cache.stats()["persistent_dir"] == d
    target = build._target(name)
    assert os.path.dirname(target) == d
    # the same source digest names the library in either directory
    assert os.path.basename(target) == os.path.basename(default)
    compile_cache.rescope_persistent_cache()
    assert build.build_dir() == d
    assert compile_cache.world_dir() == d
    # a world of 4 scopes its own subdirectory; the libraries stay shared
    compile_cache.rescope_persistent_cache(world_size=4)
    assert compile_cache.world_dir() == os.path.join(d, "world_4")
    assert build.build_dir() == d
    assert compile_cache.persistent_dir() == d
    flags.set_flags({"compile_cache_dir": ""}, pin=False)
    assert build.build_dir() == build.BUILD_DIR


def test_compile_cache_dir_from_the_environment(tmp_path):
    """A process started with ``FLAGS_compile_cache_dir`` builds into it
    (the second process of a tuning run loads what the first built)."""
    d = str(tmp_path / "k")
    code = ("import paddle_tpu_torch as pt\n"
            "from paddle_tpu_torch.ops.cuda import build\n"
            "print(build.build_dir(), pt.flags.pinned('compile_cache_dir'))")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, FLAGS_compile_cache_dir=d))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [d, "True"]


def test_profile_and_step_records_carry_one_fingerprint(tmp_path):
    """The program profile, the step records and the spans name the
    program by ``compile_cache``'s fingerprint, and the port's offline
    tools join a profile to its steps by it."""
    loss = _fc_step()
    log = str(tmp_path / "log")
    monitor.enable(log_dir=log)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    for _ in range(3):
        exe.run(feed={"x": np.ones((2, 4), "float32")}, fetch_list=[loss])
    fp = compile_cache.program_fingerprint(pt.default_main_program())
    assert program_profile.program_fingerprint(
        pt.default_main_program()) == fp and len(fp) == 40
    prof = program_profile.get(fp)
    assert prof is not None and prof.fingerprint == fp
    monitor.goodput_stamp()
    monitor.disable()
    recs = []
    for fn in os.listdir(log):
        if fn.endswith(".jsonl"):
            with open(os.path.join(log, fn)) as f:
                recs += [json.loads(ln) for ln in f if ln.strip()]
    profs = {r["fingerprint"] for r in recs
             if r.get("event") == "program_profile"}
    steps = [r for r in recs if r.get("event") == "step_stats"
             and fp.startswith(r.get("fingerprint") or "-")]
    assert fp in profs and steps
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "program_report.py"),
         log, "--json"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout)["programs"]
    row = next(r for r in rows if r["fingerprint"][:12] == fp[:12])
    assert row["steps"] >= 3
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "goodput_report.py"),
         log, "--json"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)
