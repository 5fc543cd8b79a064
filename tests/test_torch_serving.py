"""The port's decoder-LM serving slice held against the JAX package.

Both packages' ``build_decoder_lm`` make the same score/prefill/decode programs; with the JAX
side's initial weights carried across (``params_from_jax_scope`` here,
``paddle_tpu_torch.convert.load_numpy_params`` in the port), the port's
score program and its CPU generation engine reproduce the JAX score
program's full-forward logits."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.framework import Parameter as JaxParameter
from paddle_tpu.serving import build_decoder_lm as jax_build_decoder_lm

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.serving import GenerationEngine, build_decoder_lm

SMALL = dict(vocab_size=23, max_len=32, slots=4, n_layer=2, n_head=2,
             d_model=16, d_inner=32)


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """The port's counterpart of conftest's ``fresh_programs``: fresh
    default programs, scope and name counter for every test."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def params_from_jax_scope(program, jax_scope):
    """``{name: np.ndarray}`` of every parameter of a JAX ``program``, read
    from ``jax_scope``."""
    return {v.name: np.array(jax_scope.find_var(v.name), copy=True)
            for v in program.list_vars() if isinstance(v, JaxParameter)}


def jax_spec_and_params(**kw):
    """A JAX decoder spec, its initialized scope, and its parameters."""
    spec = jax_build_decoder_lm(**kw)
    scope = fluid.Scope()
    spec.init_scope(fluid.Executor(fluid.CPUPlace()), scope)
    return spec, scope, params_from_jax_scope(spec.score_program, scope)


def score_feed(seqs):
    """Padded score-program feed for token lists (right-padded with 0)."""
    t = max(len(s) for s in seqs)
    tok = np.zeros((len(seqs), t, 1), "int64")
    for i, s in enumerate(seqs):
        tok[i, :len(s), 0] = s
    return {"tok": tok,
            "tok@LEN": np.asarray([len(s) for s in seqs], "int32"),
            "pos": np.broadcast_to(np.arange(t, dtype="int64")[None, :, None],
                                   (len(seqs), t, 1)).copy()}


@pytest.mark.parametrize("program", ["score", "prefill", "decode",
                                     "startup"])
def test_decoder_programs_serialize_like_jax(program):
    """Op types and order, var names, shapes, dtypes and attrs: the
    port's programs are the JAX package's, byte for byte."""
    js = jax_build_decoder_lm(**SMALL)
    ts = build_decoder_lm(**SMALL)
    a = getattr(js, program + "_program")
    b = getattr(ts, program + "_program")
    assert b.to_dict() == a.to_dict()
    assert b.to_json() == a.to_json()
    # and the schema round-trips through the port's loader
    assert pt.Program.from_json(a.to_json()).to_dict() == a.to_dict()


def test_score_program_matches_jax_on_padded_batch():
    jspec, jscope, params = jax_spec_and_params(**SMALL)
    rng = np.random.RandomState(0)
    lens = [8, 5, 3]
    seqs = [list(rng.randint(0, SMALL["vocab_size"], n)) for n in lens]
    feed = score_feed(seqs)
    (want,) = fluid.Executor(fluid.CPUPlace()).run(
        jspec.score_program, feed=feed, fetch_list=[jspec.score_logits],
        scope=jscope)

    spec = build_decoder_lm(**SMALL)
    scope = pt.Scope()
    load_numpy_params(scope, params, "cpu")
    (got,) = pt.Executor(pt.CPUPlace()).run(
        spec.score_program, feed=feed, fetch_list=[spec.score_logits],
        scope=scope)
    assert got.shape == (3, 8, SMALL["vocab_size"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_engine_decode_matches_jax_full_forward():
    """The decode-vs-recompute contract across packages: the port's CPU
    engine, on the JAX weights, records logits that match the JAX score
    program's full forward at every generated position, and its greedy
    tokens are that forward's argmax."""
    jspec, jscope, params = jax_spec_and_params(**SMALL)
    spec = build_decoder_lm(**SMALL)
    eng = GenerationEngine(spec, place=pt.CPUPlace(), record_logits=True,
                           timeout_s=120.0, start=False)
    load_numpy_params(eng._scope, params, "cpu")
    total = 9        # prompt + generated: one JAX compile for all rows
    prompts = [[3, 5, 7], [2, 9, 4, 6, 8], [1, 2], [11, 12, 13, 14],
               [20, 1, 6, 2, 2, 9]]
    try:
        eng.start()
        reqs = [eng.submit(p, max_new_tokens=total - len(p))
                for p in prompts]
        results = [r.result(120) for r in reqs]
    finally:
        eng.close()
    seqs = [p + r["tokens"] for p, r in zip(prompts, results)]
    assert all(len(s) == total for s in seqs)
    (full,) = fluid.Executor(fluid.CPUPlace()).run(
        jspec.score_program, feed=score_feed(seqs),
        fetch_list=[jspec.score_logits], scope=jscope)
    full = np.asarray(full)
    for i, (p, res) in enumerate(zip(prompts, results)):
        assert len(res["logits"]) == total - len(p)
        for k, step in enumerate(res["logits"]):
            ref = full[i, len(p) - 1 + k]
            np.testing.assert_allclose(step, ref, rtol=2e-4, atol=2e-4)
            assert res["tokens"][k] == int(np.argmax(ref))


def test_generation_engine_recycles_slots_in_flight():
    """More requests than slots all complete: freed slots refill between
    decode steps without draining the batch."""
    spec = build_decoder_lm(vocab_size=13, max_len=16, slots=2, n_layer=1,
                            n_head=2, d_model=8, d_inner=16,
                            prefix="declm2")
    eng = GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=3,
                           timeout_s=120.0, bucket_bounds=[4])
    try:
        reqs = [eng.submit([1 + i, 2 + i]) for i in range(5)]
        outs = [r.result(120) for r in reqs]
        assert all(len(o["tokens"]) == 3 for o in outs)
        counts = eng.metrics.summary()["counts"]
        assert counts["completed"] == 5
        assert counts["generated_tokens"] == 15
        assert counts["decode_steps"] >= 2
        assert eng.metrics.percentiles()["n"] == 5
    finally:
        eng.close()


def test_engine_without_place_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = build_decoder_lm(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(spec)


@pytest.mark.parametrize("kwargs", [dict(paged=True), dict(spec_k=2),
                                    dict(kv_dtype="int8"), "quantize"])
def test_unported_decoder_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        if kwargs == "quantize":
            # int8 serving is ported; its TunedConfig ruling is not
            GenerationEngine(build_decoder_lm(**SMALL), place=pt.CPUPlace(),
                             tuned_config="tuned.json", start=False)
        else:
            build_decoder_lm(**SMALL, **kwargs)


def test_executor_defaults_to_the_card():
    assert pt.Executor().place == pt.CUDAPlace(0)
    assert pt.Executor().place.device == torch.device("cuda", 0)
    assert pt.Executor(pt.CPUPlace()).place.device == torch.device("cpu")
