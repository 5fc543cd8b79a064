"""The ``sp`` and ``pp`` mesh axes on the program surface: the port's
``models/transformer.py`` through ``ParallelExecutor`` with ring attention
and with pipeline regions, on the CPU.

The counterparts of ``tests/test_program_sp_pp.py`` (whose mesh cases are
``slow`` there): the staged Transformer's programs serialize like the
JAX builder's (two regions, two region grads); its staged run on one
device follows the JAX staged run (dropout 0, rtol 1e-4) and the
unstaged program; then worlds of gloo ranks (``torch_mesh_world``): the
Transformer under (dp, sp) = (1, 2) and (2, 2) with dropout 0.1 and
ragged lengths, the ring engaged (and not, where the sequence does not
split), and under (dp, tp, sp) = (1, 2, 2) with the default sharding
table; under (dp, pp) = (1, 2) for each schedule (interleaved at four
layers) with dropout 0.1, and (2, 2) with dropout 0: each against the
port's ``Executor`` from the same state, within the JAX tests' 2e-4.
Then the goodput ledger's ``pipeline_bubble`` bucket (filled, and
smaller under interleaved at equal layers and microbatches), the
measured ``tune_pipeline`` with its HBM gate, and the region's
structural and undeclared-side refusals."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_world import error_of, run_world  # noqa: E402
from test_torch_serving import fresh_torch_programs  # noqa: E402,F401

V = 32


def _build(pkg, t=8, n_layer=1, dropout=0.1, microbatches=None, lps=1,
           seed=11, n_head=2):
    if pkg.__name__ == "paddle_tpu":
        from paddle_tpu.models import transformer as tfm
    else:
        from paddle_tpu_torch.models import transformer as tfm
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    words = [pkg.layers.data(n, shape=[1], dtype="int64", lod_level=1)
             for n in ("src_word", "tgt_word", "lbl_word")]
    cost, _ = tfm.transformer(*words, t, t, V, V, n_layer=n_layer,
                              n_head=n_head, d_model=16, d_inner=32,
                              dropout_rate=dropout,
                              pipeline_microbatches=microbatches,
                              pipeline_layers_per_stage=lps)
    pkg.optimizer.Adam(learning_rate=2e-3).minimize(cost)
    return cost


def _batches(steps=3, batch=8, t=8, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(2, V, (batch, t, 1)).astype("int64")
        lens = rng.randint(t // 2, t + 1, (batch,)).astype("int32")
        out.append({"src_word": ids, "src_word@LEN": lens,
                    "tgt_word": ids, "tgt_word@LEN": lens,
                    "lbl_word": ids, "lbl_word@LEN": lens})
    return out


# what each world case builds: (build kwargs, batch kwargs, mesh shape,
# mesh axes, BuildStrategy attrs)
SPECS = {
    "sp12": (dict(), dict(), (1, 2), ("dp", "sp"), {}),
    "sp12_odd": (dict(t=9), dict(t=9), (1, 2), ("dp", "sp"), {}),
    "pp12_gpipe": (dict(n_layer=2, microbatches=2), dict(), (1, 2),
                   ("dp", "pp"), {"pipeline_schedule": "gpipe"}),
    "pp12_1f1b": (dict(n_layer=2, microbatches=2), dict(), (1, 2),
                  ("dp", "pp"), {"pipeline_schedule": "1f1b"}),
    "pp12_interleaved": (dict(n_layer=4, microbatches=2), dict(), (1, 2),
                         ("dp", "pp"),
                         {"pipeline_schedule": "interleaved"}),
    "sp22": (dict(), dict(), (2, 2), ("dp", "sp"), {}),
    "tpsp122": (dict(), dict(), (1, 2, 2), ("dp", "tp", "sp"),
                {"sharding_rules": True}),
    "pp22": (dict(n_layer=2, microbatches=2, dropout=0.0), dict(), (2, 2),
             ("dp", "pp"), {}),
}
WORLD2 = ["sp12", "sp12_odd", "pp12_gpipe", "pp12_1f1b",
          "pp12_interleaved"]
WORLD4 = ["sp22", "tpsp122", "pp22"]


# ---------------------------------------------------------------------------
# the ranks' cases (no JAX in a rank)
# ---------------------------------------------------------------------------

def _state_in(inputs):
    return {k[2:]: v for k, v in inputs.items() if k.startswith("S:")}


def _start(pt, inputs):
    from paddle_tpu_torch.convert import load_numpy_state

    load_numpy_state(pt.global_scope(), pt.default_startup_program(),
                     _state_in(inputs), "cpu")


def _mesh_case(name):
    def case(inputs, rank, world):
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.ops import attention

        build, batch, shape, axes, knobs = SPECS[name]
        pmod = sys.modules["paddle_tpu_torch.parallel.pipeline"]
        pmod.LAST_RUN.clear()
        cost = _build(pt, **build)
        _start(pt, inputs)
        bs = pt.BuildStrategy()
        for k, v in knobs.items():
            setattr(bs, k, v)
        calls = [0]
        ring = attention._ring_attention

        def spy(*a, **kw):
            calls[0] += 1
            return ring(*a, **kw)

        attention._ring_attention = spy
        try:
            pe = pt.ParallelExecutor(use_cuda=False, loss_name=cost.name,
                                     mesh=pt.make_mesh(shape, axes),
                                     build_strategy=bs)
            losses = [float(np.asarray(pe.run([cost], feed=f)[0])
                            .ravel()[0]) for f in _batches(**batch)]
        finally:
            attention._ring_attention = ring
        scope = pt.global_scope()
        names = sorted(_state_in(inputs))
        full = pe.gathered_state({n: scope.var(n) for n in names})
        ran = pmod.LAST_RUN.get("backward", {})
        out = {"losses": np.array(losses), "ring_calls": np.array(calls[0]),
               "schedule": np.array(ran.get("schedule", "")),
               "transfers": np.array(ran.get("transfers", 0))}
        out.update({"S:" + n: full[n].numpy() for n in names})
        return out
    return case


def case_bubble(inputs, rank, world):
    """gpipe over two 2-layer stages against interleaved over four
    1-layer stages (two chunks a rank): four layers and two microbatches
    each, dropout 0, the monitor on; the goodput ledger's buckets over
    three warm steps, and the losses."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, monitor, unique_name

    out = {}
    mesh = pt.make_mesh((1, 2), ("dp", "pp"))
    monitor.enable()
    try:
        for sched, lps in (("gpipe", 2), ("interleaved", 1)):
            framework.switch_main_program(pt.Program())
            framework.switch_startup_program(pt.Program())
            unique_name.switch()
            with pt.scope_guard(pt.Scope()):
                cost = _build(pt, n_layer=4, dropout=0.0, microbatches=2,
                              lps=lps)
                pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
                bs = pt.BuildStrategy()
                bs.pipeline_schedule = sched
                pe = pt.ParallelExecutor(use_cuda=False,
                                         loss_name=cost.name, mesh=mesh,
                                         build_strategy=bs)
                feeds = _batches()
                pe.run([cost], feed=feeds[0])
                monitor.goodput_reset()
                out[sched + "_losses"] = np.array([
                    float(np.asarray(pe.run([cost], feed=f)[0]).ravel()[0])
                    for f in feeds])
                b = monitor.goodput_summary()["buckets"]
                out[sched + "_buckets"] = np.array(
                    [b["pipeline_bubble"], b["compute"]])
    finally:
        monitor.disable()
    return out


def case_tune(inputs, rank, world):
    """``tune_pipeline`` measured on a (1, 2) dp x pp mesh, then with a
    one-byte ceiling (``FLAGS_autotune_hbm_bytes``) over a warm-up peak of
    a kilobyte on rank 1 alone (the CPU measures none, so the profile's
    peak is set): every candidate rejected by the gate on every rank,
    rank 0 too, which saw no peak."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import autotune, flags
    from paddle_tpu_torch.monitor import program_profile

    cost = _build(pt, n_layer=2, dropout=0.0, microbatches=2)
    mesh = pt.make_mesh((1, 2), ("dp", "pp"))
    cfg = autotune.TunedConfig()
    feed = _batches(steps=1)[0]
    d = autotune.tune_pipeline(pt.default_main_program(),
                               pt.default_startup_program(), feed, cost,
                               mesh, microbatch_candidates=[2, 4],
                               probe_steps=1, config=cfg)
    rec = cfg.get("pipeline")
    out = {"chosen": np.array("%s/%d" % (d["chosen"]["schedule"],
                                         d["chosen"]["microbatches"])),
           "measured": np.array([[c["microbatches"], c["step_s"],
                                  c["bubble_fraction"], c["in_flight"]]
                                 for c in d["candidates"]
                                 if c.get("step_s")]),
           "rejected": np.array([c["schedule"] + ": " + c["rejected"]
                                 for c in d["candidates"]
                                 if c.get("rejected")] or [""]),
           "record": np.array([rec["evidence"], str(rec["mesh_pp"])])}
    get = program_profile.get

    def with_peak(*a, **kw):
        prof = get(*a, **kw)
        if prof is not None:
            prof.warmup_peak_bytes = 1024 if rank == 1 else None
        return prof

    program_profile.get = with_peak
    flags.set_flags({"autotune_hbm_bytes": 1}, pin=False)
    try:
        autotune.tune_pipeline(pt.default_main_program(),
                               pt.default_startup_program(), feed, cost,
                               mesh, microbatch_candidates=[2],
                               schedules=["gpipe"], probe_steps=1)
        out["gate"] = np.array("not raised")
    except ValueError as e:
        out["gate"] = np.array(str(e))
    finally:
        program_profile.get = get
        flags.set_flags({"autotune_hbm_bytes": 0}, pin=False)
    return out


CASES = {name: _mesh_case(name) for name in SPECS}
CASES.update(bubble=case_bubble, tune=case_tune)


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _port_state(**build):
    import paddle_tpu_torch as pt

    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        _build(pt, **build)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(start, scope=scope)
    return {"S:" + v.name: scope.var(v.name).numpy().copy()
            for v in start.list_vars() if v.persistable}


def _port_single(state, feeds, **build):
    """The port's single-device ``Executor`` losses and state from
    ``state``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import load_numpy_state

    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        loss = _build(pt, **build)
    scope = pt.Scope()
    load_numpy_state(scope, start, _state_in(state), "cpu")
    exe = pt.Executor(pt.CPUPlace())
    losses = np.array([float(np.asarray(exe.run(
        main, feed=f, fetch_list=[loss], scope=scope)[0]).ravel()[0])
        for f in feeds])
    return losses, scope


def _world(names, n, tmp_path_factory):
    inputs = {c: _port_state(**SPECS[c][0]) for c in names
              if c in SPECS}
    res = run_world(os.path.abspath(__file__), n, names,
                    tmp_path_factory.mktemp("sppp%d" % n), inputs)
    for case, ranks in res.items():
        for r in ranks:
            assert not error_of(r), (case, r.get("__trace__"))
    return res, inputs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(WORLD2 + ["bubble", "tune"], 2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(WORLD4, 4, tmp_path_factory)


def _check_against_executor(world, name):
    res, inputs = world
    ranks = res[name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    got = ranks[0]
    build, batch = SPECS[name][0], SPECS[name][1]
    want, scope = _port_single(inputs[name], _batches(**batch), **build)
    np.testing.assert_allclose(got["losses"], want, rtol=2e-4, atol=2e-4)
    moved = 0
    for k, v in got.items():
        if k.startswith("S:"):
            np.testing.assert_allclose(v, scope.var(k[2:]).numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
            moved += not np.array_equal(v, inputs[name][k])
    # the step trained: the weights moved from the start state
    assert moved > 10, moved
    return got


def test_staged_transformer_serializes_like_jax():
    import paddle_tpu as fluid

    import paddle_tpu_torch as pt

    dicts = []
    for pkg in (fluid, pt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            _build(pkg, n_layer=2, microbatches=2)
        dicts.append((main.to_dict(), start.to_dict()))
        ops = [op.type for op in main.global_block().ops]
        assert ops.count("pipeline_region") == 2
        assert ops.count("pipeline_region_grad") == 2
    assert dicts[0] == dicts[1]


def test_staged_run_follows_jax_staged_run():
    """Dropout 0, three Adam steps from the JAX startup state: the port's
    sequential regions against the JAX package's (rtol 1e-4)."""
    import paddle_tpu as fluid

    from paddle_tpu_torch.convert import load_numpy_state
    import paddle_tpu_torch as pt

    feeds = _batches()
    build = dict(n_layer=2, microbatches=2, dropout=0.0)
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start), fluid.unique_name.guard():
        loss = _build(fluid, **build)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(start, scope=scope)
    state = {v.name: np.array(scope.find_var(v.name), copy=True)
             for v in start.list_vars() if v.persistable}
    want = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0]).ravel()[0])
            for f in feeds]
    pmain, pstart = pt.Program(), pt.Program()
    with pt.program_guard(pmain, pstart), pt.unique_name.guard():
        ploss = _build(pt, **build)
    pscope = pt.Scope()
    load_numpy_state(pscope, pstart, state, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    got = [float(np.asarray(pexe.run(pmain, feed=f, fetch_list=[ploss],
                                     scope=pscope)[0]).ravel()[0])
           for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_staged_matches_unstaged_transformer():
    """Dropout 0: the staged program's sequential path computes the
    unstaged program's losses from the same state."""
    state = _port_state(n_layer=2, dropout=0.0)
    feeds = _batches()
    plain, _ = _port_single(state, feeds, n_layer=2, dropout=0.0)
    staged, _ = _port_single(state, feeds, n_layer=2, dropout=0.0,
                             microbatches=2)
    np.testing.assert_allclose(staged, plain, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["sp12", "sp22"])
def test_transformer_trains_under_dp_sp(world2, world4, name):
    """Ring attention over sp with dropout 0.1 and ragged lengths: the
    losses and the trained state of the single-device run, the ring
    lowering every attention op (three forward ops a step, each again in
    its grad's recompute)."""
    got = _check_against_executor(world2 if name == "sp12" else world4,
                                  name)
    assert int(got["ring_calls"]) == 3 * 2 * 3


def test_sp_mesh_without_divisible_sequence_runs_kernel_path(world2):
    """T = 9 does not split over sp = 2: kernel #1's path on the whole
    sequence (no ring), still the single-device run."""
    got = _check_against_executor(world2, "sp12_odd")
    assert int(got["ring_calls"]) == 0


def test_ring_composes_with_tensor_parallel_heads(world4):
    """(dp, tp, sp) = (1, 2, 2) with the default sharding table: each
    rank one of the two heads (the q projection column-split over tp) and
    half of the sequence in the ring, as ``__graft_entry__``'s dp x tp x
    sp step."""
    got = _check_against_executor(world4, "tpsp122")
    assert int(got["ring_calls"]) == 3 * 2 * 3


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_transformer_trains_under_dp_pp(world2, schedule):
    """Each schedule on (dp, pp) = (1, 2), dropout 0.1 (interleaved: four
    layers, two chunks a rank): the sequential run's losses and state,
    the region's draws keyed by (stage, microbatch) alike on both."""
    got = _check_against_executor(world2, "pp12_" + schedule)
    assert str(got["schedule"]) == schedule
    assert int(got["transfers"]) > 0


def test_transformer_trains_under_dp2_pp2(world4):
    got = _check_against_executor(world4, "pp22")
    assert str(got["schedule"]) == "gpipe"


def test_pipeline_bubble_attributed_and_smaller_interleaved(world2):
    res, _ = world2
    got = res["bubble"][0]
    fractions = {}
    for sched in ("gpipe", "interleaved"):
        bubble, compute = got[sched + "_buckets"]
        assert bubble > 0, got
        fractions[sched] = bubble / (bubble + compute)
    np.testing.assert_allclose(got["gpipe_losses"],
                               got["interleaved_losses"], rtol=2e-4,
                               atol=2e-4)
    assert fractions["interleaved"] < fractions["gpipe"], fractions


def test_tune_pipeline_measures_and_gates(world2):
    res, _ = world2
    got = res["tune"][0]
    # every rank decides from the world's evidence: one decision, one
    # candidate table (the step times the slowest rank's), one gate
    for other in res["tune"][1:]:
        assert sorted(other) == sorted(got)
        for k in got:
            np.testing.assert_array_equal(other[k], got[k], err_msg=k)
    assert str(got["chosen"]).split("/")[0] in ("gpipe", "1f1b")
    # 2 schedules x 2 microbatch counts measured, interleaved left out by
    # default (v would be 1)
    measured = got["measured"]
    assert measured.shape == (4, 4)
    assert sorted(measured[:, 0].tolist()) == [2, 2, 4, 4]
    assert (measured[:, 1] > 0).all()
    assert ((measured[:, 2] > 0) & (measured[:, 2] < 1)).all()
    assert (measured[:, 3] >= 1).all()
    assert got["rejected"].tolist() == [""]
    assert got["record"].tolist() == ["measured_step_window", "2"]
    assert "no measured candidate" in str(got["gate"])


def test_pipeline_rejects_structurally_different_stages():
    """Stages differing in an attr (the dropout rate) are refused when the
    region runs: stage 0's template would run the wrong math."""
    import paddle_tpu_torch as pt

    x0 = pt.layers.data("x", shape=[4])
    pipe = pt.layers.Pipeline(microbatches=2)
    for i, rate in enumerate([0.1, 0.5]):
        with pipe.stage():
            h = pipe.carry(x0 if i == 0 else None)
            h = pt.layers.fc(h, size=4)
            h = pt.layers.dropout(h, dropout_prob=rate)
            pipe.emit(h)
    out = pipe()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    with pytest.raises(ValueError, match="structurally identical"):
        exe.run(feed={"x": np.zeros((4, 4), "float32")}, fetch_list=[out])


def test_pipeline_rejects_undeclared_float_side():
    import paddle_tpu_torch as pt

    x0 = pt.layers.data("x", shape=[4])
    bias = pt.layers.fc(x0, size=4)
    pipe = pt.layers.Pipeline(microbatches=2)
    with pipe.stage():
        h = pipe.carry(x0)
        h = pt.layers.elementwise_add(h, bias)
        pipe.emit(h)
    with pytest.raises(ValueError, match="side"):
        pipe()


if __name__ == "__main__":
    from torch_mesh_world import worker

    worker(CASES)
