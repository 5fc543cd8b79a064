"""The plain versions of the port's backward and loss kernels held against
the JAX package's Pallas ``custom_vjp``s (interpret mode on the CPU) and
their XLA references.

``attention_bwd_reference`` (kernel #2), ``layer_norm_bwd_reference``
(#4) and ``softmax_xent_reference`` / ``softmax_xent_bwd_reference`` (#5,
#6) are what the port runs for tensors on the CPU and what the CUDA kernels
are compared with on the card, so they must compute exactly the JAX
package's functions: the masks, the fully-masked-row contract, the
dropout hash and the out-of-range label.  The autograd Functions that pair
each forward with its backward are checked here too: on CPU tensors they
run the plain backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import registry as jax_registry
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu.ops.pallas import softmax_xent as jsx

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.ops import cuda
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import layer_norm as ln
from paddle_tpu_torch.ops.cuda import softmax_xent as sx

# float32 sums of a few dozen terms in other orders than XLA's
TOL = dict(rtol=2e-5, atol=2e-5)


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


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# kernel #2: flash-attention backward
# ---------------------------------------------------------------------------

def _attention_grads(q, k, v, k_len, seed, causal, rate, dout):
    """(port plain backward, JAX Pallas vjp in interpret mode, JAX XLA
    reference vjp), each a (dq, dk, dv) tuple of numpy arrays."""
    tq_, tk_, tv_, tdo = _t(q, k, v, dout)
    tkl = None if k_len is None else torch.from_numpy(k_len)
    out, lse = fa.reference_attention_lse(tq_, tk_, tv_, tkl, seed, causal,
                                          rate)
    got = fa.attention_bwd_reference(tq_, tk_, tv_, tkl, seed, causal, rate,
                                     None, out, lse, tdo)
    jkl = None if k_len is None else jnp.asarray(k_len, jnp.int32)
    js = None if seed is None else jnp.asarray(seed, jnp.uint32)

    def vjp(fn):
        _, pull = jax.vjp(lambda a, b, c: fn(a, b, c, jkl, js), jnp.asarray(q),
                          jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(g) for g in pull(jnp.asarray(dout))]

    pallas = vjp(lambda a, b, c, kl, s: jfa.flash_attention(
        a, b, c, kl, s, causal, rate, None, True))
    ref = vjp(lambda a, b, c, kl, s: jfa.reference_attention(
        a, b, c, kl, s, causal, rate, None))
    return [g.numpy() for g in got], pallas, ref


# The mask cases of test_torch_kernels.py, each batch row its own key
# length (one Pallas interpret compile per case, so rows share a call):
# no klen, klen with a fully masked row, top-aligned and suffix causal,
# Tq != Tk, and dropout 0.1 with and without causal.
@pytest.mark.parametrize("tq,tk,causal,k_len,rate", [
    (16, 16, False, None, 0.0), (64, 64, True, None, 0.0),
    (16, 16, True, [16, 7, 1, 0], 0.0),
    (24, 40, False, [40, 7, 1, 0], 0.0),
    (4, 40, True, [40, 17, 4, 0], 0.0),       # suffix (decode) alignment
    (16, 16, False, [16, 9, 0, 3], 0.1), (16, 16, True, [16, 9, 0, 3], 0.1),
])
def test_attention_bwd_matches_jax(tq, tk, causal, k_len, rate):
    rng = np.random.RandomState(tq * 100 + tk)
    b = 3 if k_len is None else len(k_len)
    q, k, v, do = (rng.randn(b, 2, t, 8).astype("float32")
                   for t in (tq, tk, tk, tq))
    kl = None if k_len is None else np.asarray(k_len, "int32")
    seed = 1234 if rate else None
    got, pallas, ref = _attention_grads(q, k, v, kl, seed, causal, rate, do)
    for g, p, r in zip(got, pallas, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, p, **TOL)
        np.testing.assert_allclose(g, r, **TOL)
    if kl is not None:
        for i in np.flatnonzero(kl == 0):
            assert all(np.all(g[i] == 0.0) for g in got)


def test_attention_function_backward_is_the_plain_backward():
    """On CPU tensors autograd through ``flash_attention`` runs
    ``attention_bwd_reference`` and launches nothing."""
    cuda.reset_launch_counts()
    rng = np.random.RandomState(5)
    q, k, v, do = _t(*(rng.randn(2, 2, 12, 8).astype("float32")
                       for _ in range(4)))
    kl = torch.tensor([12, 5], dtype=torch.int32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, kl, 77, True, 0.1)
    grads = torch.autograd.grad(out, leaves, do)
    o, lse = fa.reference_attention_lse(q, k, v, kl, 77, True, 0.1)
    assert torch.equal(out.detach(), o)
    want = fa.attention_bwd_reference(q, k, v, kl, 77, True, 0.1, None, o,
                                      lse, do)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert set(cuda.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# kernel #4: layer-norm backward
# ---------------------------------------------------------------------------

def _jax_ln_xla(x, g, b):
    """The JAX package's layer_norm op on its XLA path (no Pallas)."""
    ctx = jax_registry.ComputeContext()
    outs = jax_registry.get_op_def("layer_norm").compute(
        {"X": [x], "Scale": [g], "Bias": [b]},
        {"epsilon": 1e-5, "begin_norm_axis": 1}, ctx, 0)
    return outs["Y"]


@pytest.mark.parametrize("n,d", [(0, 32), (0, 512), (13, 32), (64, 512)])
def test_layer_norm_bwd_matches_jax(n, d):
    rng = np.random.RandomState(n * 7 + d)
    x = (rng.randn(n, d) * 3 + 1).astype("float32")
    g = rng.randn(d).astype("float32")
    b = rng.randn(d).astype("float32")
    dy = rng.randn(n, d).astype("float32")
    tx, tg, tb, tdy = _t(x, g, b, dy)
    _, mean, var = ln.layer_norm_reference(tx, tg, tb, 1e-5)
    got = ln.layer_norm_bwd_reference(tx, tg, mean, torch.rsqrt(var + 1e-5),
                                      tdy)
    assert [t.shape for t in got] == [(n, d), (d,), (d,)]
    for fn in (lambda a, c, e: jln.layer_norm(a, c, e, 1e-5, True),
               _jax_ln_xla):
        _, pull = jax.vjp(fn, jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
        for mine, want in zip(got, pull(jnp.asarray(dy))):
            # dgamma/dbeta sum n products in another order than XLA's
            np.testing.assert_allclose(mine.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)


def test_layer_norm_function_backward_is_the_plain_backward():
    rng = np.random.RandomState(3)
    x, g, b, dy = _t(rng.randn(9, 32).astype("float32"),
                     rng.randn(32).astype("float32"),
                     rng.randn(32).astype("float32"),
                     rng.randn(9, 32).astype("float32"))
    leaves = [t.clone().requires_grad_() for t in (x, g, b)]
    y, mean, var = ln.layer_norm(*leaves, 1e-5)
    assert not mean.requires_grad and not var.requires_grad
    grads = torch.autograd.grad(y, leaves, dy)
    want = ln.layer_norm_bwd_reference(x, g, mean, torch.rsqrt(var + 1e-5),
                                       dy)
    for a, w in zip(grads, want):
        assert torch.equal(a, w)


# ---------------------------------------------------------------------------
# kernels #5 and #6: softmax + cross-entropy
# ---------------------------------------------------------------------------

def _jax_swce_xla(logits, label, eps):
    ctx = jax_registry.ComputeContext()
    outs = jax_registry.get_op_def("softmax_with_cross_entropy").compute(
        {"Logits": [logits], "Label": [label.reshape(-1, 1)]},
        {"soft_label": False, "ignore_index": -100,
         "label_smooth_eps": eps}, ctx, 0)
    return outs["Loss"], outs["Softmax"]


def _xent_inputs(n, c, seed):
    """Logits, labels with two rows past [0, C) (C and -1), and the rng."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 2).astype("float32")
    label = rng.randint(0, c, n).astype("int64")
    label[3], label[7] = c, -1
    return logits, label, rng


def _in_range(label, c):
    # the XLA path gathers with take_along_axis, which has no
    # matches-no-column semantics: compare it on in-range rows only
    return (label >= 0) & (label < c)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_softmax_xent_fwd_matches_jax(eps):
    logits, label, _ = _xent_inputs(13, 37, 1)
    loss, sm = sx.softmax_xent_reference(*_t(logits, label), eps)
    assert loss.shape == (13, 1) and sm.shape == (13, 37)
    jl, js = jsx.softmax_xent(jnp.asarray(logits), jnp.asarray(label), True,
                              eps)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(sm.numpy(), np.asarray(js), **TOL)
    ok = _in_range(label, 37)
    xl, xs = _jax_swce_xla(jnp.asarray(logits), jnp.asarray(label), eps)
    np.testing.assert_allclose(loss.numpy()[ok], np.asarray(xl)[ok], **TOL)
    np.testing.assert_allclose(sm.numpy(), np.asarray(xs), **TOL)


# eps 0.1 without dsm is the Transformer step's case; the other two
# cover eps 0 and the softmax cotangent's term
@pytest.mark.parametrize("eps,with_dsm", [(0.0, False), (0.1, False),
                                          (0.1, True)])
def test_softmax_xent_bwd_matches_jax(eps, with_dsm):
    logits, label, rng = _xent_inputs(13, 37, 2)
    dloss = rng.randn(13, 1).astype("float32")
    dsm = rng.randn(13, 37).astype("float32") if with_dsm else None
    _, sm = sx.softmax_xent_reference(*_t(logits, label), eps)
    got = sx.softmax_xent_bwd_reference(
        sm, torch.from_numpy(label), torch.from_numpy(dloss),
        None if dsm is None else torch.from_numpy(dsm), eps).numpy()
    cts = (jnp.asarray(dloss),
           jnp.zeros((13, 37)) if dsm is None else jnp.asarray(dsm))
    _, pull = jax.vjp(lambda a: jsx.softmax_xent(
        a, jnp.asarray(label), True, eps), jnp.asarray(logits))
    np.testing.assert_allclose(got, np.asarray(pull(cts)[0]), **TOL)
    ok = _in_range(label, 37)
    _, pull = jax.vjp(lambda a: _jax_swce_xla(a, jnp.asarray(label), eps),
                      jnp.asarray(logits))
    np.testing.assert_allclose(got[ok], np.asarray(pull(cts)[0])[ok], **TOL)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_softmax_xent_out_of_range_label_picks_zero(eps):
    """A label outside [0, C) matches no column, in the plain version as in
    the Pallas kernel's iota compare (the two tests above hold both on
    such rows): the row's loss has no picked term and its dlogits no
    onehot term."""
    logits, label, rng = _xent_inputs(13, 37, 3)
    loss, sm = sx.softmax_xent_reference(*_t(logits, label), eps)
    x = logits.astype("float64")
    log_z = np.log(np.exp(x).sum(-1))
    dloss = rng.randn(13, 1).astype("float32")
    dl = sx.softmax_xent_bwd_reference(sm, torch.from_numpy(label),
                                       torch.from_numpy(dloss), None, eps)
    for i in (3, 7):
        want = (1 - eps) * log_z[i] + eps * (log_z[i] - x[i].mean())
        np.testing.assert_allclose(loss.numpy()[i, 0], want, rtol=1e-5)
        np.testing.assert_allclose(
            dl.numpy()[i], (sm.numpy()[i] - eps / 37) * dloss[i, 0],
            rtol=1e-6, atol=1e-7)


def test_softmax_xent_function_passes_none_for_a_missing_cotangent():
    """Autograd of the loss alone reaches the backward with dsm None (the
    Transformer step's case), and gives the plain backward's result."""
    logits, label, rng = _xent_inputs(13, 9, 4)
    tl, tlab = _t(logits, label)
    leaf = tl.clone().requires_grad_()
    loss, sm = sx.softmax_xent(leaf, tlab, 0.1)
    dloss = torch.from_numpy(rng.randn(13, 1).astype("float32"))
    (grad,) = torch.autograd.grad(loss, [leaf], dloss)
    want = sx.softmax_xent_bwd_reference(sm.detach(), tlab, dloss, None, 0.1)
    assert torch.equal(grad, want)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors only; the CPU is the
    plain versions' and counts no launch."""
    cuda.reset_launch_counts()
    q = torch.zeros(1, 1, 4, 64)
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd(q, q, q, None, None, False, 0.0, None, q,
                               torch.zeros(1, 1, 4), q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln.layer_norm_bwd(x, torch.ones(8), torch.zeros(3), torch.ones(3), x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sx.softmax_xent_fwd(x, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sx.softmax_xent_bwd(x, torch.zeros(3, dtype=torch.int64),
                            torch.zeros(3, 1))
    assert set(cuda.launch_counts().values()) == {0}
