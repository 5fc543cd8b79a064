"""The port's Transformer training slice held against the JAX package, on
the CPU at a tiny size (2+2 layers, d_model 32, 2 heads, d_inner 64,
vocab 20, max_len 8).

Both packages build the same train program (forward, ``append_backward``,
noam schedule, Adam); with the JAX startup state carried across
(``convert.load_numpy_state``) the port's CPU executor follows the JAX
package's loss trajectory, and the generic grad's forward recompute draws
the forward's attention-dropout mask."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch import backward as pt_backward
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import optimizer as pt_optimizer
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.framework import Parameter
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.registry import ComputeContext

TINY = dict(n_layer=2, n_head=2, d_model=32, d_inner=64)
VOCAB, MAX_LEN = 20, 8


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """Fresh port default programs, scope and name counter per test."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def build_train(pkg, transformer, optimizer, dropout, warmup=4000, seed=5):
    """(main, startup, cost) of the tiny Transformer train program:
    label smoothing 0.1, noam(d_model, warmup), Adam as bench.py sets it.
    Both programs carry ``seed``: with ``random_seed`` 0 the JAX executor
    draws the startup seed from numpy's global generator, so the initial
    state would depend on whichever tests ran earlier in the process."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup):
        words = [pkg.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = transformer.transformer(
            *words, MAX_LEN, MAX_LEN, VOCAB, VOCAB, dropout_rate=dropout,
            **TINY)
        lr = pkg.layers.noam_decay(TINY["d_model"], warmup)
        optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                       epsilon=1e-9).minimize(cost)
    return main, startup, cost


def feed(rng, batch=4):
    lens = rng.randint(3, MAX_LEN + 1, size=batch).astype("int32")
    out = {n: rng.randint(0, VOCAB, (batch, MAX_LEN, 1)).astype("int64")
           for n in ("src_word", "tgt_word", "lbl_word")}
    out.update({n + "@LEN": lens for n in ("src_word", "tgt_word",
                                           "lbl_word")})
    return out


@pytest.mark.parametrize("program", ["main", "startup"])
def test_train_program_serializes_like_jax(program):
    """Forward, grad ops (with their ``__fwd_op_index__``), sums, the noam
    ops and the Adam updates: op for op and attr for attr."""
    a = build_train(fluid, jax_transformer, fluid.optimizer, 0.1)
    b = build_train(pt, pt_transformer, pt_optimizer, 0.1)
    i = 0 if program == "main" else 1
    assert b[i].to_dict() == a[i].to_dict()
    assert b[i].to_json() == a[i].to_json()


@pytest.mark.parametrize("seed", [5, 21, 40])
def test_adam_trajectory_matches_jax(seed):
    """20 Adam steps at dropout 0 from the JAX startup state of a pinned
    program seed: per-step losses within rtol 1e-4 (the JAX package's
    trajectory band); final parameters within 1e-3 of each parameter's
    largest magnitude.

    Why the seed is pinned and which seeds hold.  Over program seeds 1-40
    the one-step gradients of the two packages agree within ~1e-6
    relative L2 from the same state, and 38 seeds keep both bands (worst
    parameter 8e-6..9.4e-4; seeds 5, 21 and 40 read 1.6e-5, 3.1e-5 and
    3.0e-5).  Two do not:

    * seed 29 — rounding noise amplified by Adam.  At step 0 the gradient
      of ``dec_logits.w_0[28, 9]`` is 6.44e-8 in the port and 5.52e-8 in
      the JAX package (2e-7 of that parameter's largest gradient, 0.31).
      Adam divides m by sqrt(v) + 1e-9 with sqrt(v) = 0.055 |g| at step 1,
      so near |g| ~ 1e-8 the update depends on |g| itself: the element
      moves 4.36e-3 against 4.20e-3.  Left to run, such elements drift
      apart by 0.15 of a parameter's largest magnitude in 20 steps, and the
      losses by 9.7e-4.
    * seed 31 — the reference's own step 0 is not reproducible.  The JAX
      package's step-0 gradients move by 4.0e-2 relative L2 when the
      first residual sum ``elementwise_add_0.tmp_0`` is also fetched (XLA
      then compiles the step without fusing it into the layer norm); the
      port agrees with that second compile within 1.1e-6, and a 1e-6
      perturbation of the state moves the port's gradients by only 8e-6.

    An unpinned startup seed lands on such a state now and then: one run
    of the unseeded test failed on ``dec1_ffn_fc1.w_0`` (5.3e-3 against a
    bound of 5.5e-4)."""
    jm, js, jc = build_train(fluid, jax_transformer, fluid.optimizer, 0.0,
                             warmup=10, seed=seed)
    tm, ts, tc = build_train(pt, pt_transformer, pt_optimizer, 0.0,
                             warmup=10, seed=seed)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    assert load_numpy_state(tscope, ts, state, "cpu") == len(state)
    rng = np.random.RandomState(0)
    for _ in range(20):
        f = feed(rng)
        (want,) = jexe.run(jm, feed=f, fetch_list=[jc], scope=jscope)
        (got,) = texe.run(tm, feed=f, fetch_list=[tc], scope=tscope)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4)
    params = [v.name for v in tm.list_vars() if isinstance(v, Parameter)]
    # every persistable came across: the parameters, 4 Adam accumulators
    # per trainable one (all but the 2 position tables), the step counter
    assert len(state) == len(params) + 4 * (len(params) - 2) + 1
    for n in params:
        want = np.asarray(jscope.find_var(n))
        got = tscope.var(n).numpy()
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), n
    # the step counter advanced once per step
    assert float(tscope.var("@LR_DECAY_COUNTER@begin=1")[0]) == 20.0


def test_load_numpy_state_refuses_a_missing_persistable():
    _, ts, _ = build_train(pt, pt_transformer, pt_optimizer, 0.0)
    with pytest.raises(KeyError, match="moment1"):
        load_numpy_state(pt.Scope(), ts, {}, "cpu")


def test_attention_dropout_grad_recomputes_the_forward_mask():
    """With attention dropout 0.1 the port's ``fused_attention_grad`` (the
    generic recompute) equals autograd of ONE forward call with the seed
    the forward op drew: the grad reruns the forward with the forward
    op's index (``__fwd_op_index__``), not its own."""
    b, h, t, d = 2, 2, 8, 16
    names = ("q", "k", "v")
    qkv = [pt.layers.data(n, shape=[h, t, d], stop_gradient=False)
           for n in names]
    klen = pt.layers.data("klen", shape=[], dtype="int32")
    w = pt.layers.data("w", shape=[h, t, d])
    out = pt.layers.fused_attention(*qkv, k_len=klen, causal=True,
                                    dropout_rate=0.1)
    loss = pt.layers.reduce_sum(pt.layers.elementwise_mul(out, w))
    pt_backward.append_backward(loss)
    main = pt.default_main_program()
    main.random_seed = 7
    ops = main.global_block().ops
    fwd_index = [op.type for op in ops].index("fused_attention")
    grad_op = ops[[op.type for op in ops].index("fused_attention_grad")]
    assert grad_op.attrs["__fwd_op_index__"] == fwd_index
    assert ops.index(grad_op) != fwd_index

    rng = np.random.RandomState(0)
    f = {n: rng.randn(b, h, t, d).astype("float32") for n in names}
    f["klen"] = np.asarray([8, 5], "int32")
    f["w"] = rng.randn(b, h, t, d).astype("float32")
    grads = pt.Executor(pt.CPUPlace()).run(
        main, feed=f, fetch_list=[n + "@GRAD" for n in names])

    # the run's seeds: the run key is the first draw of the executor's
    # generator for the program seed 7
    seed = ComputeContext("cpu", torch.Generator().manual_seed(7),
                          len(ops)).seed32(fwd_index)
    leaves = [torch.from_numpy(f[n]).requires_grad_() for n in names]
    o = fa.flash_attention(*leaves, torch.from_numpy(f["klen"]), seed, True,
                           0.1)
    want = torch.autograd.grad(o, leaves, torch.from_numpy(f["w"]))
    for g, wv in zip(grads, want):
        np.testing.assert_allclose(g, wv.numpy(), rtol=1e-6, atol=1e-6)
    # and the mask really drops weights: without dropout the grads differ
    o0 = fa.flash_attention(*leaves, torch.from_numpy(f["klen"]), seed,
                            True, 0.0)
    g0 = torch.autograd.grad(o0, leaves, torch.from_numpy(f["w"]))
    assert not np.allclose(grads[0], g0[0].numpy(), atol=1e-4)


def test_layer_norm_mean_has_no_gradient():
    """Mean/Variance are not differentiable in the port: a loss that reads
    Mean raises in the generic grad instead of dropping its cotangent."""
    x = pt.layers.data("x", shape=[4], stop_gradient=False)
    y = pt.layers.layer_norm(x)
    ln_op = pt.default_main_program().global_block().ops[-1]
    mean = pt.default_main_program().global_block().var(
        ln_op.outputs["Mean"][0])
    loss = pt.layers.reduce_sum(pt.layers.elementwise_add(
        pt.layers.reduce_sum(y), pt.layers.reduce_sum(mean)))
    pt_backward.append_backward(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    with pytest.raises(NotImplementedError, match="not differentiable"):
        exe.run(feed={"x": np.random.RandomState(0).randn(3, 4)
                      .astype("float32")}, fetch_list=["x@GRAD"])


def test_training_options_not_ported_raise():
    words = [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
             for n in ("src_word", "tgt_word", "lbl_word")]
    with pytest.raises(NotImplementedError, match="pipeline"):
        pt_transformer.transformer(*words, MAX_LEN, MAX_LEN, VOCAB, VOCAB,
                                   pipeline_microbatches=2, **TINY)
    logits = pt.layers.data("logits", shape=[VOCAB], stop_gradient=False)
    label = pt.layers.data("label", shape=[1], dtype="int64")
    # ignore_index is ported (it raised before the RNN slice): a row whose
    # label is the ignored one has loss 0
    loss = pt.layers.reduce_sum(pt.layers.softmax_with_cross_entropy(
        logits, label, ignore_index=0))
    (lv,) = pt.Executor(pt.CPUPlace()).run(
        feed={"logits": np.zeros((2, VOCAB), "float32"),
              "label": np.array([[0], [3]], "int64")}, fetch_list=[loss])
    np.testing.assert_allclose(lv, [np.log(VOCAB)], rtol=1e-6)
    # the regularizers and gradient clips are ported (they raised before
    # the sparse-embedding slice): a parameter's decay and clip append
    # their ops between the backward and the update
    w = pt.layers.fc(logits, 3, param_attr=pt.ParamAttr(
        regularizer=pt.regularizer.L2Decay(0.1)))
    c = pt.layers.fc(logits, 3, bias_attr=False, param_attr=pt.ParamAttr(
        gradient_clip=pt.clip.GradientClipByValue(1.0)))
    pt_optimizer.SGD(0.1).minimize(pt.layers.reduce_sum(
        pt.layers.elementwise_add(w, c)))
    ops = pt.default_main_program().global_block().ops
    first_sgd = [op.type for op in ops].index("sgd")
    assert {"clip", "scale", "sum"} <= {op.type for op in ops[:first_sgd]}


def test_executor_frees_temporaries_and_keeps_fetches():
    """A training step drops each temporary after its last reader; the
    fetched ones and the persistable state survive."""
    tm, ts, tc = build_train(pt, pt_transformer, pt_optimizer, 0.0)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(ts, scope=scope)
    logits = tm.global_block().ops[
        [op.type for op in tm.global_block().ops]
        .index("softmax_with_cross_entropy")].inputs["Logits"][0]
    f = feed(np.random.RandomState(1))
    cost, lg = exe.run(tm, feed=f, fetch_list=[tc, logits], scope=scope)
    assert cost.shape == (1,) and lg.shape == (4, MAX_LEN, VOCAB)
    (_, _, _, release, _, _), = [a for k, a in exe._analysis.items()
                                 if k[0] == id(tm)]
    freed = {n for names in release for n in names}
    assert logits not in freed and tc.name not in freed
    assert not any(tm.global_block()._find_var_recursive(n).persistable
                   for n in freed if tm.global_block()._find_var_recursive(n))
    assert "dec_logits.tmp_0" in freed
