"""The port's int8 serving slice held against the JAX package, on the CPU.

* ``dequant_matmul_reference`` (what the port runs for CPU tensors and what
  kernel #7 is held against on the card) against the Pallas kernel in
  interpret mode and against ``xla_dequant_matmul``;
* the fake-quant ops, ``Program.clone``/``prune_feed_fetch`` and the
  ``quantize_inference`` pass against the JAX package's (rewritten
  programs, int8 values and ``_quantize_info`` equal);
* ``DecoderSpec.quantize`` and the CPU ``GenerationEngine(quantize=)`` on
  the JAX weights against the JAX quantized score program;
* ``io`` round trips in both directions, and ``InferenceEngine`` on a JAX
  artifact, on an already-quantized artifact and with multi-row requests.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu.ops.quantize import xla_dequant_matmul
from paddle_tpu.serving import InferenceEngine as JaxInferenceEngine
from paddle_tpu.transpiler import quantize_inference as jax_quantize

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.ops.cuda import quant_matmul as qm
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      GenerationEngine, InferenceEngine,
                                      PoisonedRequestError, build_decoder_lm)
from paddle_tpu_torch.transpiler import (QUANT_SUFFIX, SCALE_SUFFIX,
                                         quantize_inference)

from test_torch_serving import SMALL, jax_spec_and_params, score_feed

MODES = ("weight_only", "dynamic")


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def rel_l1(ref, out):
    """Relative L1 (the JAX package's ``autotune.eval_delta``): the int8
    accuracy budget's metric."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).sum() / (np.abs(ref).sum() + 1e-12))


def int8_weight(rng, k, n):
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    sw = (np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0).astype(np.float32)
    return np.clip(np.round(w / sw), -127, 127).astype(np.int8), sw


def numpy_grid(x, xscale=None):
    """The dynamic activation grid in numpy (np.round: half to even)."""
    xf = x.astype(np.float32)
    if xscale is None:
        sx = np.maximum(np.abs(xf).max(axis=1, keepdims=True),
                        np.float32(1e-12)) / np.float32(127.0)
    else:
        sx = np.maximum(np.float32(xscale), np.float32(1e-12)) \
            / np.float32(127.0)
    return np.clip(np.round(xf / sx), -127, 127).astype(np.int8), sx


def port_inputs(x, qw, sw, dtype):
    x2 = torch.from_numpy(x).to(dtype)
    return x2, torch.from_numpy(qw), torch.from_numpy(sw)


# ---------------------------------------------------------------------------
# kernel #7's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_reference_matches_pallas_interpret(mode, dtype):
    """Ragged (5, 130, 200) against the Pallas kernel in interpret mode.
    weight_only within 1e-5; dynamic: qx and the int32 accumulator equal
    numpy's half-to-even grid and int64 product bit for bit, the output
    the kernel's within 1e-5."""
    rng = np.random.RandomState(2)
    x = rng.randn(5, 130).astype(np.float32)
    qw, sw = int8_weight(rng, 130, 200)
    tdt = getattr(torch, dtype)
    x2, tqw, tsw = port_inputs(x, qw, sw, tdt)
    got = qm.dequant_matmul_reference(x2, tqw, tsw, mode).numpy()
    want = np.asarray(jqm.dequant_matmul(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(qw),
        jnp.asarray(sw), mode=mode, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if mode == "dynamic":
        xq = x2.float().numpy()      # x as the kernel reads it (bf16 exact)
        nqx, nsx = numpy_grid(xq)
        qx, sx = qm.quantize_rows_reference(x2)
        np.testing.assert_array_equal(qx.numpy(), nqx)
        np.testing.assert_array_equal(sx.numpy(), nsx)
        acc = qm.int8_matmul_reference(qx, tqw).numpy()
        np.testing.assert_array_equal(
            acc, nqx.astype(np.int64) @ qw.astype(np.int64))


@pytest.mark.parametrize("case", ["k_lt_128", "n_lt_128", "f16",
                                  "dyn_k_lt_128", "dyn_xscale",
                                  "dyn_xscale_bf16"])
def test_dequant_matmul_reference_matches_xla(case):
    """The shapes and inputs the JAX package sends to XLA (K or N under
    128, a static XScale, float16) and kernel #7 takes on the card: the
    plain version against ``xla_dequant_matmul`` within 1e-5."""
    rng = np.random.RandomState(3)
    m, k, n = {"k_lt_128": (7, 40, 160), "n_lt_128": (9, 130, 24),
               "f16": (6, 96, 130)}.get(case, (7, 40, 96))
    mode = "dynamic" if case.startswith("dyn") else "weight_only"
    x = rng.randn(m, k).astype(np.float32)
    qw, sw = int8_weight(rng, k, n)
    xscale = (np.asarray([2.5], np.float32) if "xscale" in case else None)
    dtype = {"f16": "float16", "dyn_xscale_bf16": "bfloat16"}.get(
        case, "float32")
    x2, tqw, tsw = port_inputs(x, qw, sw, getattr(torch, dtype))
    got = qm.dequant_matmul_reference(
        x2, tqw, tsw, mode,
        None if xscale is None else torch.from_numpy(xscale)).numpy()
    want = np.asarray(xla_dequant_matmul(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(qw),
        jnp.asarray(sw), mode=mode,
        xscale=None if xscale is None else jnp.asarray(xscale)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if xscale is not None:
        # the static envelope clips: rows whose |x| passes 2.5 saturate
        qx, sx = qm.quantize_rows_reference(x2, torch.from_numpy(xscale))
        assert sx.dim() == 0 and int(qx.abs().max()) == 127
        np.testing.assert_array_equal(
            qx.numpy(), numpy_grid(x2.float().numpy(), 2.5)[0])


def test_activation_grid_rounds_half_to_even():
    """Exact ties: row max 127 gives sx = 1, and x / sx = k + 0.5 rounds
    to the even neighbour in both packages (rintf on the card)."""
    x = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]],
                   np.float32)
    qx, sx = qm.quantize_rows_reference(torch.from_numpy(x))
    assert float(sx) == 1.0
    want = [127, 0, 2, 2, 0, -2, 4, -126]
    assert qx.numpy().tolist() == [want]
    assert numpy_grid(x)[0].tolist() == [want]


def test_dequant_matmul_routes_cpu_to_plain_and_kernel_refuses_cpu():
    rng = np.random.RandomState(4)
    x2, tqw, tsw = port_inputs(rng.randn(3, 8).astype(np.float32),
                               *int8_weight(rng, 8, 5), torch.float32)
    before = qm.dequant_matmul_kernel.launches
    got = qm.dequant_matmul(x2, tqw, tsw, "dynamic")
    torch.testing.assert_close(
        got, qm.dequant_matmul_reference(x2, tqw, tsw, "dynamic"),
        rtol=0, atol=0)
    assert qm.dequant_matmul_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        qm.dequant_matmul_kernel(x2, tqw, tsw)
    with pytest.raises(ValueError, match="unknown dequant_matmul mode"):
        qm.dequant_matmul_reference(x2, tqw, tsw, "int4")


# ---------------------------------------------------------------------------
# fake-quant ops, clone/prune and the pass, against the JAX package
# ---------------------------------------------------------------------------

def _run_both(jprog, feed, fetch, jscope=None, tscope=None):
    """Run a JAX program and its port copy (``from_dict``) on ``feed``."""
    jscope = jscope or fluid.Scope()
    want = fluid.Executor(fluid.CPUPlace()).run(
        jprog, feed=feed, fetch_list=fetch, scope=jscope)
    tprog = pt.Program.from_dict(jprog.to_dict())
    got = pt.Executor(pt.CPUPlace()).run(
        tprog, feed=feed, fetch_list=fetch, scope=tscope or pt.Scope())
    return got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", ["abs_max", "abs_max_axis0",
                                  "abs_max_axis1", "range_train",
                                  "range_test", "dequant"])
def test_fake_quant_ops_match_jax(case):
    main = fluid.Program()
    block = main.global_block()
    x = block.create_var(name="x", shape=(-1, 6), dtype="float32",
                         is_data=True)
    out = block.create_var(name="q", dtype="float32")
    scale = block.create_var(name="qs", dtype="float32")
    xv = np.asarray([[0.5, -1.0, 2.0, 0.1, -0.2, 4.0],
                     [0.25, 0.5, -1.0, 0.05, 0.1, -2.0]], "float32")
    feed, fetch = {"x": xv}, ["q", "qs"]
    if case.startswith("abs_max"):
        attrs = {"bit_length": 8}
        if case != "abs_max":
            attrs["quant_axis"] = int(case[-1])
        block.append_op(type="fake_quantize_abs_max", inputs={"X": [x]},
                        outputs={"Out": [out], "OutScale": [scale]},
                        attrs=attrs)
    elif case.startswith("range"):
        ins = block.create_var(name="ins", shape=(1,), dtype="float32",
                               is_data=True)
        feed["ins"] = np.asarray([3.0], "float32")
        block.append_op(type="fake_quantize_range_abs_max",
                        inputs={"X": [x], "InScale": [ins]},
                        outputs={"Out": [out], "OutScale": [scale]},
                        attrs={"bit_length": 8,
                               "is_test": case == "range_test"})
    else:
        s = block.create_var(name="s", shape=(1,), dtype="float32",
                             is_data=True)
        feed["s"] = np.asarray([2.0], "float32")
        block.append_op(type="fake_dequantize_max_abs",
                        inputs={"X": [x], "Scale": [s]},
                        outputs={"Out": [out]}, attrs={"max_range": 127.0})
        fetch = ["q"]
    got, want = _run_both(main, feed, fetch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_fake_quant_gradient_is_straight_through():
    """The port's grad maker emits the JAX package's ``ste_identity_grad``
    op, which passes the output gradient through unchanged."""
    from paddle_tpu_torch.registry import make_grad_ops

    x = pt.layers.data("x", shape=[4], stop_gradient=False)
    block = pt.default_main_program().global_block()
    out = block.create_var(name="q", dtype="float32")
    scale = block.create_var(name="qs", dtype="float32")
    op = block.append_op(type="fake_quantize_abs_max", inputs={"X": [x]},
                         outputs={"Out": [out], "OutScale": [scale]},
                         attrs={"bit_length": 8})
    (spec,) = make_grad_ops(op, set())
    assert spec == {"type": "ste_identity_grad",
                    "inputs": {"GRAD::Out": ["q@GRAD"]},
                    "outputs": {"GRAD::X": ["x@GRAD"]}, "attrs": {}}


def _fc_programs(pkg, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[64])
        h = pkg.layers.fc(x, size=128, act="relu")
        pred = pkg.layers.fc(h, size=16, act="relu")
    return main, startup, pred


def _jax_fc_state():
    main, startup, pred = _fc_programs(fluid)
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=jscope)
    return main, pred, jscope


def _port_scope(jscope, names):
    scope = pt.Scope()
    load_numpy_params(scope, {n: np.array(jscope.find_var(n), copy=True)
                              for n in names if jscope.find_var(n)
                              is not None}, "cpu")
    return scope


def _assert_pass_equal(jq, tq, jscope, tscope):
    assert tq.to_dict() == jq.to_dict()
    assert tq._quantize_info == jq._quantize_info
    for w in jq._quantize_info["weights"]:
        for name in (w + QUANT_SUFFIX, w + SCALE_SUFFIX):
            a = tscope.var(name)
            b = np.asarray(jscope.find_var(name))
            assert a.dtype == torch.from_numpy(b).dtype
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_inference_matches_jax(mode):
    """Same fc program, same weights: equal rewritten programs, bit-equal
    int8 weights and scales, equal ``_quantize_info``; the rewritten
    programs' outputs agree (weight_only 1e-5; dynamic 1e-5 relative L1:
    the int8 products are exact, the float rounding around them need not
    be; 0 observed)."""
    main, pred, jscope = _jax_fc_state()
    tprog = pt.Program.from_dict(main.to_dict())
    tscope = _port_scope(jscope, [v.name for v in main.list_vars()])
    jq = jax_quantize(main, scope=jscope, mode=mode)
    tq = quantize_inference(tprog, scope=tscope, mode=mode)
    _assert_pass_equal(jq, tq, jscope, tscope)
    # the input program is untouched
    assert "dequant_matmul" not in [op.type
                                    for op in tprog.global_block().ops]
    feed = {"x": np.random.RandomState(0).rand(8, 64).astype("float32")}
    (want,) = fluid.Executor(fluid.CPUPlace()).run(
        jq, feed=feed, fetch_list=[pred.name], scope=jscope)
    (got,) = pt.Executor(pt.CPUPlace()).run(
        tq, feed=feed, fetch_list=[pred.name], scope=tscope)
    if mode == "weight_only":
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert rel_l1(want, got) < 1e-5


@pytest.mark.parametrize("mode", MODES)
def test_quantize_inference_consumes_qat_scales_like_jax(mode):
    """A frozen QAT program (range_abs_max fake-quants on the weight and
    the activation, 3 SGD steps in the JAX package): the port's pass
    consumes the trained ``OutScale`` (and, in dynamic mode, the
    activation's ``XScale``) exactly as the JAX pass does."""
    from paddle_tpu.contrib.quantize import QuantizeTranspiler

    qt = QuantizeTranspiler(weight_quantize_type="range_abs_max",
                            activation_quantize_type="range_abs_max")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred = fluid.layers.fc(x, size=4)
        qt.training_transpile(main, startup)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(pred, label))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    jscope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=jscope)
    rng = np.random.RandomState(0)
    for _ in range(3):
        exe.run(main, feed={"x": rng.rand(8, 16).astype("float32"),
                            "label": rng.randint(0, 4, (8, 1))
                            .astype("int64")},
                fetch_list=[loss], scope=jscope)
    frozen = qt.freeze_program(main, fluid.CPUPlace(), scope=jscope) \
        .prune_feed_fetch(["x"], [pred.name])
    tprog = pt.Program.from_dict(frozen.to_dict())
    tscope = _port_scope(jscope, [v.name for v in frozen.list_vars()
                                  if v.persistable])
    jq = jax_quantize(frozen, scope=jscope, mode=mode)
    tq = quantize_inference(tprog, scope=tscope, mode=mode)
    _assert_pass_equal(jq, tq, jscope, tscope)
    assert tq._quantize_info["weights"]["fc_0.w_0"]["calibration"] == \
        "qat_out_scale"
    dq = [op for op in tq.global_block().ops if op.type == "dequant_matmul"]
    assert ("XScale" in dq[0].inputs) == (mode == "dynamic")
    feed = {"x": rng.rand(4, 16).astype("float32")}
    (want,) = exe.run(jq, feed=feed, fetch_list=[pred.name], scope=jscope)
    (got,) = pt.Executor(pt.CPUPlace()).run(
        tq, feed=feed, fetch_list=[pred.name], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["clone_for_test", "prune"])
def test_clone_and_prune_serialize_like_jax(which):
    """``clone(for_test=True)`` sets ``is_test`` on dropout and the range
    fake-quant; ``prune_feed_fetch`` keeps the ops and vars the fetch
    needs.  The port's results serialize like the JAX package's."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        h = fluid.layers.dropout(fluid.layers.fc(x, size=8), 0.5)
        y = fluid.layers.fc(h, size=4)
        fluid.layers.fc(x, size=3)        # a branch the fetch does not need
    tmain = pt.Program.from_dict(main.to_dict())
    if which == "clone_for_test":
        a, b = main.clone(for_test=True), tmain.clone(for_test=True)
        assert any(op.attrs.get("is_test") for op in b.global_block().ops)
    else:
        a = main.prune_feed_fetch(["x"], [y.name])
        b = tmain.prune_feed_fetch(["x"], [y.name])
        assert len(b.global_block().ops) < len(tmain.global_block().ops)
    assert b.to_dict() == a.to_dict()
    assert tmain.to_dict() == main.to_dict()     # neither mutates


# ---------------------------------------------------------------------------
# the decoder and the generation engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_decoder_quantize_programs_match_jax(mode):
    """``DecoderSpec.quantize``: the three rewritten programs equal the JAX
    package's, every weight is quantized once (the later programs reuse
    the scope values) and the int8 values are bit-equal."""
    jspec, jscope, params = jax_spec_and_params(**SMALL)
    jq = jspec.quantize(jscope, mode=mode)
    spec = build_decoder_lm(**SMALL)
    scope = pt.Scope()
    load_numpy_params(scope, params, "cpu")
    tq = spec.quantize(scope, mode=mode)
    for name in ("score", "prefill", "decode"):
        a = getattr(jq, name + "_program")
        b = getattr(tq, name + "_program")
        assert b.to_dict() == a.to_dict(), name
        assert b._quantize_info == a._quantize_info, name
    types = [op.type for op in tq.decode_program.global_block().ops]
    # 6 per layer (q, k, v, o, fc1, fc2) and the logits
    assert types.count("dequant_matmul") == 6 * SMALL["n_layer"] + 1
    assert "mul" not in types
    calib = {w["calibration"] for w in
             tq.prefill_program._quantize_info["weights"].values()}
    assert calib == {"reused"}
    for w in tq.score_program._quantize_info["weights"]:
        np.testing.assert_array_equal(
            scope.var(w + QUANT_SUFFIX).numpy(),
            np.asarray(jscope.find_var(w + QUANT_SUFFIX)))


@pytest.mark.parametrize("mode", MODES)
def test_engine_quantized_decode_matches_jax(mode):
    """The CPU ``GenerationEngine(quantize=)`` on the JAX weights records
    decode logits that match the JAX package's quantized score program's
    full forward: weight_only within 2e-4 (the serving contract), dynamic
    within relative L1 1e-3 (a per-row int8 grid may round one activation
    differently when the float activations differ in the last bits; 5e-8
    to 9e-8 observed)."""
    jspec, jscope, params = jax_spec_and_params(**SMALL)
    jq = jspec.quantize(jscope, mode=mode)
    spec = build_decoder_lm(**SMALL)
    scope = pt.Scope()
    spec.init_scope(pt.Executor(pt.CPUPlace()), scope)
    load_numpy_params(scope, params, "cpu")
    eng = GenerationEngine(spec, place=pt.CPUPlace(), scope=scope,
                           record_logits=True, timeout_s=120.0,
                           quantize=mode, start=False)
    assert eng.quantize_mode == mode
    assert eng._scope.var("declm_logits.w_0" + QUANT_SUFFIX).dtype \
        == torch.int8
    total = 9
    prompts = [[3, 5, 7], [2, 9, 4, 6, 8], [1, 2], [11, 12, 13, 14]]
    try:
        eng.start()
        results = [r.result(120) for r in
                   [eng.submit(p, max_new_tokens=total - len(p))
                    for p in prompts]]
    finally:
        eng.close()
    seqs = [p + r["tokens"] for p, r in zip(prompts, results)]
    (full,) = fluid.Executor(fluid.CPUPlace()).run(
        jq.score_program, feed=score_feed(seqs),
        fetch_list=[jq.score_logits], scope=jscope)
    full = np.asarray(full)
    for i, (p, res) in enumerate(zip(prompts, results)):
        got = np.stack(res["logits"])
        want = full[i, len(p) - 1:total - 1]
        if mode == "weight_only":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        else:
            assert rel_l1(want, got) < 1e-3


# ---------------------------------------------------------------------------
# io and the inference engine
# ---------------------------------------------------------------------------

def _save_jax_score_artifact(path, quantize=None):
    """The JAX decoder's score program as an inference artifact (feeds
    tok, tok@LEN, pos; fetch the logits); returns (spec, scope)."""
    jspec, jscope, _ = jax_spec_and_params(**SMALL)
    prog, logits = jspec.score_program, jspec.score_logits
    if quantize:
        prog = jax_quantize(prog, scope=jscope, mode=quantize)
        logits = prog.global_block().var(logits.name)
    with fluid.scope_guard(jscope):
        fluid.io.save_inference_model(
            path, ["tok", "tok@LEN", "pos"], [logits],
            fluid.Executor(fluid.CPUPlace()), main_program=prog)
    return jspec, jscope


def _requests(lens, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for n in lens:
        out.append({"tok": rng.randint(0, SMALL["vocab_size"], (n, 1))
                    .astype("int64"),
                    "pos": np.arange(n, dtype="int64").reshape(n, 1)})
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("params_filename", [None, "params"])
def test_inference_model_round_trip_across_packages(tmp_path, direction,
                                                    params_filename):
    """An artifact written by either package loads in the other, int8
    weights included (one .npy per var, or one combined .npz); both run
    it to the same logits (1e-5)."""
    d = str(tmp_path / "model")
    jspec, jscope, params = jax_spec_and_params(**SMALL)
    jq = jax_quantize(jspec.score_program, scope=jscope, mode="weight_only")
    feed = score_feed([[3, 5, 7, 1], [2, 9]])
    if direction == "jax_to_port":
        with fluid.scope_guard(jscope):
            fluid.io.save_inference_model(
                d, ["tok", "tok@LEN", "pos"],
                [jq.global_block().var(jspec.score_logits.name)],
                fluid.Executor(fluid.CPUPlace()), main_program=jq,
                params_filename=params_filename)
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.Scope()
        with pt.scope_guard(scope):
            prog, feeds, fetches = pt.io.load_inference_model(
                d, exe, params_filename=params_filename)
        assert scope.var("declm_logits.w_0" + QUANT_SUFFIX).dtype \
            == torch.int8
        (got,) = exe.run(prog, feed=feed, fetch_list=fetches, scope=scope)
        with fluid.scope_guard(jscope):
            (want,) = fluid.Executor(fluid.CPUPlace()).run(
                jq, feed=feed, fetch_list=[jspec.score_logits.name],
                scope=jscope)
    else:
        spec = build_decoder_lm(**SMALL)
        scope = pt.Scope()
        load_numpy_params(scope, params, "cpu")
        tq = quantize_inference(spec.score_program, scope=scope)
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(scope):
            pt.io.save_inference_model(
                d, ["tok", "tok@LEN", "pos"],
                [tq.global_block().var(spec.score_logits.name)], exe,
                main_program=tq, params_filename=params_filename)
        (want,) = exe.run(tq, feed=feed,
                          fetch_list=[spec.score_logits.name], scope=scope)
        jscope2 = fluid.Scope()
        jexe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(jscope2):
            prog, feeds, fetches = fluid.io.load_inference_model(
                d, jexe, params_filename=params_filename)
            (got,) = jexe.run(prog, feed=feed, fetch_list=fetches)
        assert np.asarray(jscope2.find_var(
            "declm_logits.w_0" + QUANT_SUFFIX)).dtype == np.int8
    assert feeds == ["tok", "tok@LEN", "pos"]
    # the artifact ships the int8 persistables and drops the fp masters
    with open(os.path.join(d, "__model__")) as f:
        names = [v["name"] for b in json.load(f)["program"]["blocks"]
                 for v in b["vars"]]
    assert "declm_logits.w_0" + QUANT_SUFFIX in names
    assert "declm_logits.w_0" not in names
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_save_load_params_round_trip(tmp_path):
    """``save_params``/``load_params`` and the persistables pair: values
    and declared dtypes survive (onto the executor's device)."""
    main, startup, _ = _fc_programs(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_params(exe, str(tmp_path / "p"), main)
        pt.io.save_persistables(exe, str(tmp_path / "s"), main,
                                filename="all")
    for sub, load, kw in (("p", pt.io.load_params, {}),
                          ("s", pt.io.load_persistables, {"filename": "all"})):
        fresh = pt.Scope()
        with pt.scope_guard(fresh):
            load(exe, str(tmp_path / sub), main, **kw)
        for p in main.all_parameters():
            assert fresh.var(p.name).dtype == p.dtype
            torch.testing.assert_close(fresh.var(p.name), scope.var(p.name),
                                       rtol=0, atol=0)


@pytest.mark.parametrize("quantize", [None, "weight_only", "dynamic"])
def test_inference_engine_on_jax_artifact_matches_jax(tmp_path, quantize):
    """The port's CPU ``InferenceEngine`` on a JAX artifact of the decoder
    score program against the JAX package's ``InferenceEngine`` on the
    same artifact: each request's logits, trimmed to its own length, fp
    and weight_only within 2e-4, dynamic within relative L1 1e-3 (up to
    8e-8 observed)."""
    d = str(tmp_path / "model")
    _save_jax_score_artifact(d)
    reqs = _requests([5, 3, 8, 2, 7, 1])
    jeng = JaxInferenceEngine(model_dir=d, place=fluid.CPUPlace(), slots=4,
                              bucket_bounds=[4, 8], quantize=quantize)
    try:
        want = [jeng.run(r, timeout=120)[0] for r in reqs]
    finally:
        jeng.close()
    eng = InferenceEngine(model_dir=d, place=pt.CPUPlace(), slots=4,
                          bucket_bounds=[4, 8], quantize=quantize)
    try:
        got = [r.result(120)[0] for r in [eng.submit(q) for q in reqs]]
    finally:
        eng.close()
    assert eng.quantize_mode == quantize
    for q, g, w in zip(reqs, got, want):
        assert g.shape == (len(q["tok"]), SMALL["vocab_size"])
        if quantize == "dynamic":
            assert rel_l1(w, g) < 1e-3
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4,
                                       atol=2e-4)


def test_inference_engine_loads_a_quantized_artifact_cold(tmp_path):
    """A JAX artifact saved after the pass runs int8 in the port with no
    pass: ``dequant_matmul`` ops, int8 values in the engine's scope, and
    the JAX package's outputs on the same artifact."""
    d = str(tmp_path / "model")
    _save_jax_score_artifact(d, quantize="weight_only")
    eng = InferenceEngine(model_dir=d, place=pt.CPUPlace(), slots=2,
                          bucket_bounds=[8], start=False)
    types = [op.type for op in eng._program.global_block().ops]
    assert eng.quantize_mode is None and "mul" not in types
    assert types.count("dequant_matmul") == 6 * SMALL["n_layer"] + 1
    assert eng._scope.var("declm_logits.w_0" + QUANT_SUFFIX).dtype \
        == torch.int8
    assert eng._scope.find_var("declm_logits.w_0") is None
    (req,) = _requests([6], seed=3)
    try:
        eng.start()
        (got,) = eng.run(req, timeout=120)
    finally:
        eng.close()
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        prog, _, fetches = fluid.io.load_inference_model(d, jexe)
        (want,) = jexe.run(prog, feed=score_feed([list(req["tok"][:, 0])]),
                           fetch_list=fetches)
    np.testing.assert_allclose(got, np.asarray(want)[0], rtol=1e-5,
                               atol=1e-5)


def test_inference_engine_multi_row_requests_and_quarantine():
    """Fixed-shape micro-batches (``rows``) co-batch into one dispatch and
    come back with their leading dim; a request with a non-finite row
    fails as quarantined while the others in its batch complete."""
    main, startup, pred = _fc_programs(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    eng = InferenceEngine(program=main, feed_names=["x"], fetch_vars=[pred],
                          scope=scope, place=pt.CPUPlace(), slots=8,
                          quantize="weight_only", start=False)
    rng = np.random.RandomState(5)
    xs = [rng.rand(3, 64).astype("float32"), rng.rand(4, 64).astype(
        "float32"), rng.rand(64).astype("float32")]
    bad = rng.rand(64).astype("float32")
    bad[3] = np.nan
    reqs = [eng.submit({"x": xs[0]}, rows=3), eng.submit({"x": xs[1]},
                                                         rows=4),
            eng.submit({"x": xs[2]}), eng.submit({"x": bad})]
    try:
        eng.start()
        outs = [r.result(120)[0] for r in reqs[:3]]
        with pytest.raises(PoisonedRequestError):
            reqs[3].result(120)
    finally:
        eng.close()
    assert reqs[3].status == "quarantined"
    assert [o.shape for o in outs] == [(3, 16), (4, 16), (16,)]
    (want,) = pt.Executor(pt.CPUPlace()).run(
        eng._program, feed={"x": np.concatenate([xs[0], xs[1],
                                                 xs[2][None]])},
        fetch_list=[pred.name], scope=scope)
    np.testing.assert_allclose(np.concatenate([outs[0], outs[1],
                                               outs[2][None]]), want,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exceed"):
        eng._sched.submit({}, rows=9)


def test_scheduler_admits_multi_row_requests():
    """Rows, not requests, fill the slots; ``max_batch`` caps the rows of
    one admission; a request too wide for the free rows waits in FIFO
    order and ``pending``/``running``/``closed`` report the state."""
    t = [0.0]
    s = ContinuousBatchingScheduler(8, clock=lambda: t[0])
    a = s.submit("a", rows=3)
    b = s.submit("b", rows=4)
    c = s.submit("c", rows=2)
    plan, _ = s.admit()
    assert plan.requests == [a, b] and len(plan.slots) == 7
    assert s.pending() == [c] and s.busy_slots() == 7
    assert sorted(s.running()) == [a.slot, b.slot]
    plan, _ = s.admit()
    assert plan is None                # c needs 2 rows, 1 is free
    s.complete(a, "done")
    plan, _ = s.admit(max_batch=1)
    assert plan is None                # capped below c's rows
    plan, _ = s.admit(max_batch=2)
    assert plan.requests == [c] and s.busy_slots() == 6
    assert not s.closed
    s.close()
    assert s.closed and b.status == "cancelled"


@pytest.mark.parametrize("engine", ["inference", "generation"])
def test_engine_without_place_needs_a_card(monkeypatch, tmp_path, engine):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if engine == "inference":
            InferenceEngine(model_dir=str(tmp_path))
        else:
            GenerationEngine(build_decoder_lm(**SMALL), quantize="dynamic")
