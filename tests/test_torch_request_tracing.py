"""Per-request tracing in the port's serving engines on the CPU, after
``tests/test_request_tracing.py``: the flag gate, assembly and
breakdown, the disabled path (no tracing call, no new entry), traced
``InferenceEngine`` and ``GenerationEngine`` runs (paged, recycled
slots, speculative rounds, an expired request) whose trees are complete,
the same request tree as the JAX engine's (span names and parentage),
chrome lanes, the watchdog's in-flight view, the wire-context round trip
of the RPC helpers, ``tools/request_trace.py`` over the port's JSONL, and
a quarantined request's npz and JSON sidecar."""

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor, profiler
from paddle_tpu_torch.monitor import tracing
from paddle_tpu_torch.serving import (GenerationEngine, InferenceEngine,
                                      build_decoder_lm)
from paddle_tpu_torch.serving.scheduler import (PoisonedRequestError,
                                                RequestTimeoutError)

from test_torch_serving import fresh_torch_programs  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DIMS = dict(n_layer=1, n_head=2, d_model=16, d_inner=32)


@pytest.fixture(autouse=True)
def tracing_reset(fresh_torch_programs):  # noqa: F811
    monitor.reset_for_tests()
    yield
    monitor.reset_for_tests()


@pytest.fixture
def saved_mlp(tmp_path):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[6])
        h = pt.layers.fc(x, size=8, act="relu")
        pred = pt.layers.fc(h, size=3, act="softmax")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_inference_model(str(tmp_path / "m"), ["x"], [pred], exe,
                                   main_program=main)
    return str(tmp_path / "m")


def _engine(path, **kw):
    return InferenceEngine(model_dir=path, place=pt.CPUPlace(), slots=2,
                           timeout_s=60.0, **kw)


def _drive(eng, n, rows=1):
    rng = np.random.RandomState(0)
    reqs = [eng.submit({"x": rng.rand(rows, 6).astype("float32")},
                       rows=rows) for _ in range(n)]
    for r in reqs:
        r.result(timeout=120)
    return reqs


# ---------------------------------------------------------------------------
# flag gate and pure units
# ---------------------------------------------------------------------------

def test_flag_flips_module_bool():
    assert not tracing.enabled()
    pt.flags.set_flags({"FLAGS_trace": True})
    assert tracing.enabled()
    pt.flags.set_flags({"FLAGS_trace": False})
    assert not tracing.enabled()
    tracing.enable()
    assert tracing.enabled()
    tracing.disable()
    assert not tracing.enabled()


def test_assemble_dedup_and_completeness():
    tracing.enable()
    s = tracing.Span("session", attrs={"host_id": "h"})
    s.emit_open()
    with tracing.span("session/heartbeat", parent=s):
        pass
    t = tracing.assemble(tracing.spans())[s.trace_id]
    assert t["root"]["status"] == "open" and not t["complete"]
    s.finish("ok")
    t = tracing.assemble(tracing.spans())[s.trace_id]
    assert len(t["spans"]) == 2
    assert t["root"]["status"] == "ok" and t["complete"]
    orphan = dict(t["spans"][0], span_id="zz", parent_id="missing")
    assert not tracing.assemble(tracing.spans() + [orphan])[
        s.trace_id]["complete"]


def test_breakdown_attribution_model():
    tracing.enable()
    rt = tracing.RequestTrace("req-x", kind="generate", length=12)
    t0 = tracing.now_us()
    rt.admitted(16, 3, False)
    rt.note_prefill(t0, 8000.0, 0, 2, 16, 4)
    rt.note_decode(t0, 4000.0, 0, 1, 2, spec_accepted=2, spec_proposed=3)
    rt.finish("ok")
    tree = tracing.assemble(tracing.spans())[rt.trace_id]
    st = tracing.breakdown(tree)["stages"]
    assert st["padding"] == pytest.approx(8.0 * 4 / 16)
    assert st["prefill"] == pytest.approx(8.0 - st["padding"])
    assert st["spec_reject"] == pytest.approx(4.0 * 1 / 4)
    assert st["decode"] == pytest.approx(4.0 - st["spec_reject"])
    assert st["other"] == 0.0
    summ = tracing.breakdown_summary({rt.trace_id: tree})
    assert summ["complete"] == 1 and "spec_reject" in \
        tracing.render_table(summ)


def test_pre_admission_failure_closes_queue_wait():
    tracing.enable()
    rt = tracing.RequestTrace("req-y", kind="infer", length=1)
    rt.finish("expired", error="timed out")
    tree = tracing.assemble(tracing.spans())[rt.trace_id]
    assert tree["complete"] and tree["root"]["status"] == "expired"
    assert {s["name"]: s for s in tree["spans"]}["queue_wait"][
        "status"] == "expired"
    rt.finish("ok")
    assert tracing.assemble(tracing.spans())[rt.trace_id]["root"][
        "status"] == "expired"


def test_wire_context_round_trip():
    """``inject`` stamps the current span's context into an envelope,
    ``extract`` turns it back into a parent: a server-side span joins
    the client's tree."""
    tracing.enable()
    with tracing.span("client_root") as root:
        env = tracing.inject({})
        c = tracing.client_span("echo", "127.0.0.1:0")
        c.finish()
    srv = tracing.server_span("echo", env["trace"])
    srv.finish()
    tree = tracing.assemble(tracing.spans())[root.trace_id]
    by = {s["name"]: s for s in tree["spans"]}
    assert by["rpc_server/echo"]["parent_id"] == root.span_id
    assert by["rpc/echo"]["parent_id"] == root.span_id
    assert tree["complete"]


# ---------------------------------------------------------------------------
# disabled is free
# ---------------------------------------------------------------------------

def test_disabled_path_performs_zero_tracing_calls(saved_mlp, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("tracing call on the disabled path")

    monkeypatch.setattr(tracing, "_emit", boom)
    monkeypatch.setattr(tracing.Span, "__init__", boom)
    monkeypatch.setattr(tracing.RequestTrace, "__init__", boom)
    monkeypatch.setattr(tracing, "now_us", boom)
    with _engine(saved_mlp) as eng:
        reqs = _drive(eng, 4)
        assert all(r.trace is None for r in reqs)
        assert eng.metrics.summary()["counts"]["completed"] == 4
        assert eng.metrics.p99_exemplars() == []
    assert tracing.spans() == []


def test_no_extra_entries_in_either_arm(saved_mlp):
    """Tracing wraps the dispatch: the executor serves traced and
    untraced windows from the same entries."""
    with _engine(saved_mlp) as eng:
        _drive(eng, 3)
        n = len(eng._exe._analysis)
        tracing.enable()
        _drive(eng, 3)
        assert len(eng._exe._analysis) == n
        tracing.disable()
        _drive(eng, 3)
        assert len(eng._exe._analysis) == n


# ---------------------------------------------------------------------------
# engines end to end
# ---------------------------------------------------------------------------

def test_inference_engine_traces_assemble_complete(saved_mlp):
    tracing.enable()
    with _engine(saved_mlp) as eng:
        reqs = _drive(eng, 8)
        summ = eng.metrics.summary()
    trees = tracing.assemble(tracing.spans())
    ts = tracing.breakdown_summary(trees)
    assert ts["requests"] == 8 and ts["complete_fraction"] == 1.0
    assert len({r.trace.trace_id for r in reqs}) == 8
    for r in reqs:
        tree = trees[r.trace.trace_id]
        assert tree["complete"]
        assert tree["root"]["attrs"]["request_id"] == r.id
        assert {"request", "queue_wait", "batch"} <= \
            {s["name"] for s in tree["spans"]}
        bd = tracing.breakdown(tree)
        assert sum(bd["stages"].values()) == pytest.approx(
            bd["latency_ms"], rel=0.05, abs=0.5)
    ex = summ["p99_exemplars"]
    assert ex and all(t in trees for t in ex)


def test_chrome_export_renders_request_lanes(saved_mlp, tmp_path):
    tracing.enable()
    with _engine(saved_mlp) as eng:
        reqs = _drive(eng, 3)
    data = json.load(open(profiler.export_chrome_tracing(
        str(tmp_path / "t.json"))))
    evs = data["traceEvents"]
    lanes = [e for e in evs if e.get("ph") == "M"
             and e.get("name") == "thread_name"
             and str(e.get("args", {}).get("name", "")).startswith("req ")]
    assert len(lanes) == 3
    req_events = [e for e in evs if e.get("ph") == "X"
                  and e.get("args", {}).get("trace_id")]
    assert {e["args"]["trace_id"] for e in req_events} == \
        {r.trace.trace_id for r in reqs}


def test_watchdog_probe_names_inflight_requests(saved_mlp):
    tracing.enable()
    rng = np.random.RandomState(0)
    with _engine(saved_mlp, start=False) as eng:
        req = eng.submit({"x": rng.rand(1, 6).astype("float32")})
        probe = monitor._stall_probe()
        inflight = probe["serving_requests"]
        assert [r["id"] for r in inflight] == [req.id]
        assert inflight[0]["trace_id"] == req.trace.trace_id
        assert inflight[0]["state"] == "queued"
        text = monitor._format_diag(probe)
        assert req.id in text and req.trace.trace_id in text


def _paged_spec(pkg, prefix):
    return pkg.serving.build_decoder_lm(31, 32, 2, paged=True, page_size=8,
                                        prefix=prefix, **_DIMS) \
        if pkg is not pt else build_decoder_lm(31, 32, 2, paged=True,
                                               page_size=8, prefix=prefix,
                                               **_DIMS)


def test_generation_engine_traces_with_pages_and_recycling():
    tracing.enable()
    spec = _paged_spec(pt, "trg")
    with GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=4,
                          timeout_s=300.0) as eng:
        reqs = [eng.submit(list(range(2, 10)) + [9 + i]) for i in range(6)]
        outs = [r.result(600) for r in reqs]
    assert all(o["tokens"] for o in outs)
    trees = tracing.assemble(tracing.spans())
    assert len({r.trace.trace_id for r in reqs}) == 6
    for r in reqs:
        tree = trees[r.trace.trace_id]
        assert tree["complete"], tree
        assert {"request", "queue_wait", "prefill", "page_alloc",
                "decode"} <= {s["name"] for s in tree["spans"]}
        assert tree["root"]["attrs"]["ticks"] >= 1
        decodes = [s for s in tree["spans"] if s["name"] == "decode"]
        assert len({s["attrs"]["slot"] for s in decodes}) == 1
        bd = tracing.breakdown(tree)
        assert sum(bd["stages"].values()) == pytest.approx(
            bd["latency_ms"], rel=0.05, abs=0.5)
    summ = tracing.breakdown_summary(trees)
    assert summ["complete_fraction"] == 1.0
    assert summ["stages"]["decode"]["p99_ms"] > 0


def test_generation_engine_expired_request_has_terminal_tree():
    tracing.enable()
    spec = _paged_spec(pt, "tre")
    with GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=4,
                          timeout_s=300.0, start=False) as eng:
        req = eng.submit([2, 3, 4], timeout_s=0.01)
        time.sleep(0.05)
        eng.start()
        with pytest.raises(RequestTimeoutError):
            req.result(60)
    tree = tracing.assemble(tracing.spans())[req.trace.trace_id]
    assert tree["complete"] and tree["root"]["status"] == "expired"
    names = {s["name"]: s for s in tree["spans"]}
    assert names["queue_wait"]["status"] == "expired"
    assert "prefill" not in names and "decode" not in names


def test_speculative_rounds_carry_acceptance_attrs():
    from paddle_tpu_torch.serving import sync_draft_weights

    tracing.enable()
    target = build_decoder_lm(31, 32, 2, prefix="tsp", spec_k=3, **_DIMS)
    draft = build_decoder_lm(31, 32, 2, prefix="tsd", **_DIMS)
    with GenerationEngine(target, place=pt.CPUPlace(), max_new_tokens=5,
                          draft_spec=draft, start=False) as eng:
        sync_draft_weights(eng._scope, target, draft)
        eng.start()
        req = eng.submit([3, 4, 5, 6])
        req.result(300)
    tree = tracing.assemble(tracing.spans())[req.trace.trace_id]
    assert tree["complete"]
    decodes = [s for s in tree["spans"] if s["name"] == "decode"]
    assert decodes and all(s["attrs"]["spec_proposed"] == 2
                           for s in decodes)


def _shape(tree):
    by_id = {s["span_id"]: s["name"] for s in tree["spans"]}
    return collections.Counter(
        (s["name"], by_id.get(s["parent_id"])) for s in tree["spans"])


def test_request_trees_match_the_jax_engines():
    """Four requests over two slots, queued before the loop starts so
    that both engines admit them alike: each request's tree has the same
    span names under the same parents in both packages."""
    import paddle_tpu as fluid
    from paddle_tpu.monitor import tracing as jax_tracing
    from paddle_tpu.serving import GenerationEngine as JaxEngine
    from paddle_tpu.serving import build_decoder_lm as jax_build

    prompts = [[2, 3, 4, 5, 6, 7, 8, 9, 10], [3, 4], [5, 6, 7],
               [2, 3, 4, 5, 6, 7, 8, 9, 11]]
    shapes = []
    for pkg, eng_cls, build, trc, place in (
            (pt, GenerationEngine, build_decoder_lm, tracing, pt.CPUPlace()),
            (fluid, JaxEngine, jax_build, jax_tracing, fluid.CPUPlace())):
        trc.reset()
        trc.enable()
        try:
            spec = build(31, 32, 2, paged=True, page_size=8, prefix="tpar",
                         **_DIMS)
            with eng_cls(spec, place=place, max_new_tokens=4,
                         timeout_s=300.0, start=False) as eng:
                reqs = [eng.submit(p) for p in prompts]
                eng.start()
                for r in reqs:
                    r.result(600)
            trees = trc.assemble(trc.spans())
            shapes.append([_shape(trees[r.trace.trace_id]) for r in reqs])
        finally:
            trc.disable()
            trc.reset()
    assert shapes[0] == shapes[1]


def test_request_trace_tool_reads_the_ports_log(saved_mlp, tmp_path):
    log_dir = str(tmp_path / "logs")
    monitor.enable(log_dir=log_dir)
    tracing.enable()
    with _engine(saved_mlp) as eng:
        reqs = _drive(eng, 4)
    monitor.disable()
    tool = os.path.join(ROOT, "tools", "request_trace.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, tool, log_dir, "--json",
                          "--assert-complete", "1.0"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout[:res.stdout.rindex("}") + 1])
    assert out["requests"] == 4 and out["complete_fraction"] == 1.0
    res = subprocess.run([sys.executable, tool, log_dir, "--trace",
                          reqs[0].trace.trace_id],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert "queue_wait" in res.stdout and "batch" in res.stdout


def test_poisoned_request_is_quarantined_with_its_dump(saved_mlp,
                                                       tmp_path):
    """A request whose output is not finite fails with its status; its
    feed lands as an npz with a JSON sidecar naming the arrays, and the
    ``serving_quarantine`` event reaches the JSONL.  The engine keeps
    serving."""
    log_dir, qdir = str(tmp_path / "logs"), str(tmp_path / "q")
    monitor.enable(log_dir=log_dir)
    tracing.enable()
    with _engine(saved_mlp, quarantine_dir=qdir) as eng:
        bad = eng.submit({"x": np.full((1, 6), np.nan, "float32")})
        with pytest.raises(PoisonedRequestError):
            bad.result(120)
        assert bad.status == "quarantined"
        _drive(eng, 2)
        assert eng.metrics.summary()["counts"]["quarantined"] == 1
    base = os.path.join(qdir, "request_%s_%s" % (monitor.run_id(), bad.id))
    side = json.load(open(base + ".json"))
    assert side["feed_names"] == ["x"] and side["path"] == base + ".npz"
    assert np.isnan(np.load(base + ".npz")["arr_0"]).all()
    monitor.disable()
    recs = [json.loads(ln) for f in os.listdir(log_dir)
            for ln in open(os.path.join(log_dir, f))]
    assert any(r.get("event") == "serving_quarantine"
               and r["request_id"] == bad.id for r in recs)
    tree = tracing.assemble(tracing.spans())[bad.trace.trace_id]
    assert tree["root"]["status"] == "quarantined"
