"""The port's speculative decoding held against greedy decoding and the
JAX package on the CPU.

* the ``spec_k`` builds (paged float32, paged int8 KV, fixed region):
  all four programs serialize like the JAX builder's, and
  ``DecoderSpec.quantize`` rewrites the four alike;
* ``sync_draft_weights`` copies what the JAX function copies;
* a weight-synced draft (the perfect-draft rig) gives the greedy tokens of
  the plain engine, paged or fixed-region target, float32 or int8 KV, and
  the JAX speculative engine's, with draft tokens accepted; the recorded
  logits match the plain engine's at 2e-4; one verify entry and one draft
  decode entry; no page leaks; no value read on the host;
* the draft spec is validated at construction.

On the card, ``chip_smoke.py``'s ``serve_paged`` phase holds the captured
speculative engine against the eager one bit for bit.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu.serving import build_decoder_lm as jax_build_decoder_lm
from paddle_tpu.serving import sync_draft_weights as jax_sync_draft_weights

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.serving import (GenerationEngine, build_decoder_lm,
                                      sync_draft_weights)

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_serving import params_from_jax_scope

DIMS = dict(n_layer=2, n_head=2, d_model=32, d_inner=64)
LM = dict(vocab_size=61, max_len=32, slots=4, **DIMS)
PS = 8
SYS_PROMPT = list(range(2, 2 + PS))
PROMPTS = [[3, 5, 7], [2, 9, 4, 6], [8, 1], SYS_PROMPT + [11],
           SYS_PROMPT + [12, 13]]
MAX_NEW = 7

TARGETS = {
    "paged_f32": dict(paged=True, page_size=PS),
    "paged_int8": dict(paged=True, page_size=PS, kv_dtype="int8"),
    "fixed": dict(),
}


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """Fresh port default programs, scope and name counter a test."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def jax_params(**kw):
    spec = jax_build_decoder_lm(**kw)
    scope = fluid.Scope()
    spec.init_scope(fluid.Executor(fluid.CPUPlace()), scope)
    return spec, scope, params_from_jax_scope(spec.score_program, scope)


def serve(spec, params, draft=None, prompts=PROMPTS):
    """Results of ``prompts`` through a ``GenerationEngine`` on ``spec``
    with the parameters ``params`` (and, with ``draft``, the draft synced
    to them); returns (results, engine)."""
    eng = GenerationEngine(spec, place=pt.CPUPlace(),
                           max_new_tokens=MAX_NEW, record_logits=True,
                           timeout_s=300.0, start=False, draft_spec=draft)
    load_numpy_params(eng._scope, params, "cpu")
    if draft is not None:
        assert sync_draft_weights(eng._scope, spec, draft) > 0
    try:
        eng.start()
        return [r.result(300) for r in
                [eng.submit(p) for p in prompts]], eng
    finally:
        eng.close()


def _entries(exe, program):
    return [k for k in exe._analysis if k[0] == id(program)]


@pytest.mark.parametrize("program", ["score", "prefill", "decode",
                                     "verify", "startup"])
@pytest.mark.parametrize("target", sorted(TARGETS))
def test_spec_programs_serialize_like_jax(target, program):
    kw = dict(LM, spec_k=4, **TARGETS[target])
    a = getattr(jax_build_decoder_lm(**kw), program + "_program")
    b = getattr(build_decoder_lm(**kw), program + "_program")
    assert b.to_dict() == a.to_dict()
    assert b.to_json() == a.to_json()


def test_spec_k_below_two_is_refused():
    with pytest.raises(ValueError, match="spec_k"):
        build_decoder_lm(**LM, spec_k=1)


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_quantize_rewrites_four_programs_like_jax(mode):
    kw = dict(LM, spec_k=3, paged=True, page_size=PS)
    jspec, jscope, params = jax_params(**kw)
    jq = jspec.quantize(jscope, mode=mode)
    scope = pt.Scope()
    load_numpy_params(scope, params, "cpu")
    tq = build_decoder_lm(**kw).quantize(scope, mode=mode)
    assert tq.spec_k == 3 and tq.paged
    for name in ("score", "prefill", "decode", "verify"):
        a = getattr(jq, name + "_program")
        b = getattr(tq, name + "_program")
        assert b.to_dict() == a.to_dict(), name
        assert b._quantize_info == a._quantize_info, name
    assert {w["calibration"] for w in tq.verify_program._quantize_info[
        "weights"].values()} == {"reused"}


def test_sync_draft_weights_like_jax():
    kw = dict(LM, spec_k=3, paged=True, page_size=PS)
    jtgt, jscope, params = jax_params(**kw)
    jdraft = jax_build_decoder_lm(**LM, prefix="draft")
    jdraft.init_scope(fluid.Executor(fluid.CPUPlace()), jscope)
    want = jax_sync_draft_weights(jscope, jtgt, jdraft)
    tgt = build_decoder_lm(**kw)
    draft = build_decoder_lm(**LM, prefix="draft")
    scope = pt.Scope()
    load_numpy_params(scope, params, "cpu")
    assert sync_draft_weights(scope, tgt, draft) == want
    for n in params:
        d = "draft" + n[len("declm"):]
        np.testing.assert_array_equal(scope.find_var(d).numpy(),
                                      np.asarray(jscope.find_var(d)))
        # a copy, not the target's tensor
        assert scope.find_var(d) is not scope.find_var(n)
    # a scope without the target's parameters copies nothing
    with pytest.raises(ValueError, match="no parameters copied"):
        sync_draft_weights(pt.Scope(), tgt, draft)


@pytest.mark.parametrize("spec_k", [2, 4])
@pytest.mark.parametrize("target", sorted(TARGETS))
def test_speculative_tokens_equal_greedy(target, spec_k):
    """The perfect-draft rig: the speculative engine's tokens are the plain
    engine's, draft tokens are accepted, the recorded logits match the
    plain engine's at 2e-4; one verify entry and one draft decode entry,
    the target's decode program never run; no page leaks."""
    kw = dict(LM, **TARGETS[target])
    _, _, params = jax_params(**kw)
    plain, _ = serve(build_decoder_lm(**kw), params)
    tgt = build_decoder_lm(**kw, spec_k=spec_k)
    draft = build_decoder_lm(**LM, prefix="draft")
    spec, eng = serve(tgt, params, draft=draft)
    assert [o["tokens"] for o in spec] == [o["tokens"] for o in plain]
    for a, b in zip(spec, plain):
        assert len(a["logits"]) == len(b["logits"]) == MAX_NEW
        for x, y in zip(a["logits"], b["logits"]):
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-4)
    snap = eng.metrics.paged_snapshot()
    assert snap["spec_rounds"] > 0 and snap["spec_accepted"] > 0
    assert snap["spec_proposed"] == (spec_k - 1) * snap["spec_rounds"]
    assert 0 < snap["spec_acceptance_rate"] <= 1
    exe = eng._exe
    assert len(_entries(exe, tgt.verify_program)) == 1
    assert len(_entries(exe, draft.decode_program)) == 1
    assert _entries(exe, tgt.decode_program) == []
    # a verify dispatch a round; a round counts once for each active slot
    assert eng.metrics.percentiles("verify")["n"] == \
        eng.metrics.summary()["counts"]["decode_steps"]
    if tgt.paged:
        assert eng._alloc.check_leaks() == []
        assert eng._alloc.pages_in_use() == 0
        assert snap["prefix_hits"] > 0


def test_speculative_equals_jax_speculative_engine():
    """The JAX speculative engine (paged float32 target, spec_k 3, a synced
    draft) on the same weights emits the port's tokens."""
    kw = dict(LM, paged=True, page_size=PS, spec_k=3)
    jtgt, _, params = jax_params(**kw)
    jdraft = jax_build_decoder_lm(**LM, prefix="draft")
    jeng = JaxGenerationEngine(jtgt, place=fluid.CPUPlace(),
                               max_new_tokens=MAX_NEW, timeout_s=300.0,
                               draft_spec=jdraft, start=False)
    try:
        jax_sync_draft_weights(jeng._scope, jtgt, jdraft)
        jeng.start()
        want = [r.result(600)["tokens"] for r in
                [jeng.submit(p) for p in PROMPTS]]
        jsnap = jeng.metrics.paged_snapshot()
    finally:
        jeng.close()
    got, eng = serve(build_decoder_lm(**kw), params,
                     draft=build_decoder_lm(**LM, prefix="draft"))
    assert [o["tokens"] for o in got] == want
    snap = eng.metrics.paged_snapshot()
    for k in ("prefix_hits", "prefix_misses", "spec_rounds",
              "spec_proposed", "spec_accepted"):
        assert snap[k] == jsnap[k], k


def test_draft_spec_validation():
    """A target without a verify program, a paged draft, and a draft of
    another shape are refused at construction."""
    tgt = build_decoder_lm(**LM, paged=True, page_size=PS, spec_k=3)
    no_verify = build_decoder_lm(**LM, prefix="dvn")
    with pytest.raises(ValueError, match="verify"):
        GenerationEngine(no_verify, place=pt.CPUPlace(),
                         draft_spec=no_verify, start=False)
    paged_draft = build_decoder_lm(**LM, paged=True, page_size=PS,
                                   prefix="dvp")
    with pytest.raises(ValueError, match="fixed-region"):
        GenerationEngine(tgt, place=pt.CPUPlace(), draft_spec=paged_draft,
                         start=False)
    short = build_decoder_lm(**dict(LM, max_len=16), prefix="dvs")
    with pytest.raises(ValueError, match="slots/vocab"):
        GenerationEngine(tgt, place=pt.CPUPlace(), draft_spec=short,
                         start=False)
    narrow = build_decoder_lm(**dict(LM, slots=2), prefix="dvw")
    with pytest.raises(ValueError, match="slots/vocab"):
        GenerationEngine(tgt, place=pt.CPUPlace(), draft_spec=narrow,
                         start=False)


def test_speculative_programs_read_nothing_on_the_host(
        host_read_guard):  # noqa: F811
    """The verify program (paged, int8 KV) and the draft's prefill and
    decode read no value on the host."""
    tgt = build_decoder_lm(**LM, paged=True, page_size=PS,
                           kv_dtype="int8", spec_k=3)
    draft = build_decoder_lm(**LM, prefix="draft")
    eng = GenerationEngine(tgt, place=pt.CPUPlace(), max_new_tokens=5,
                           draft_spec=draft, start=False)
    sync_draft_weights(eng._scope, tgt, draft)
    with eng:
        eng.start()
        out = [eng.submit(p) for p in PROMPTS[:3]]
        assert all(len(r.result(120)["tokens"]) == 5 for r in out)
    assert host_read_guard == []
