"""One-op programs built in both packages and run on the CPU: the port's
op computes against the JAX package's, on the same numpy inputs and the
JAX side's initial weights."""

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_numpy_params

from test_torch_serving import (fresh_torch_programs,  # noqa: F401
                                params_from_jax_scope)


def run_both(build, feed, state=None, rtol=1e-5, atol=1e-5):
    """Build ``build(pkg)`` (returns the fetch vars) in each package, run
    the JAX startup, carry its parameters (and ``state``) into the port,
    run both main programs on ``feed``; compares the serialized programs
    and every fetch, and returns (port fetches, the two scopes)."""
    outs, scopes, params = [], [], None
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard("t_"):
            fetch = build(pkg)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is fluid:
            exe.run(startup, scope=scope)
            params = params_from_jax_scope(main, scope)
            want_dict = main.to_dict()
        else:
            assert main.to_dict() == want_dict
            load_numpy_params(scope, params, "cpu")
        for name, arr in (state or {}).items():
            if pkg is fluid:
                scope.set_var(name, jnp.asarray(arr))
            else:
                load_numpy_params(scope, {name: arr}, "cpu")
        outs.append(exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
        scopes.append(scope)
    for want, got in zip(*outs):
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                                   atol=atol)
    return outs[1], scopes


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


@pytest.mark.parametrize("causal,k_len,dropout", [
    (False, None, 0.0), (True, [6, 3], 0.0),
    # is_test with a rate: downgrade_in_infer's (1 - p) post-scale
    (True, [6, 2], 0.1),
])
def test_fused_attention_op(causal, k_len, dropout):
    b, h, t, d = 2, 2, 6, 8

    def build(pkg):
        q, k, v = (pkg.layers.data(n, shape=[b, h, t, d],
                                   append_batch_size=False)
                   for n in ("q", "k", "v"))
        kl = pkg.layers.data("kl", shape=[b], append_batch_size=False,
                             dtype="int32") if k_len else None
        return [pkg.layers.fused_attention(q, k, v, k_len=kl, causal=causal,
                                           dropout_rate=dropout,
                                           is_test=True, scale=0.3)]

    feed = {"q": _rand(b, h, t, d, seed=1), "k": _rand(b, h, t, d, seed=2),
            "v": _rand(b, h, t, d, seed=3)}
    if k_len:
        feed["kl"] = np.asarray(k_len, "int32")
    run_both(build, feed, rtol=2e-5, atol=2e-5)


def test_fused_attention_post_scale_is_one_minus_rate():
    """is_test=True with a rate scales the dropout-free output by (1-p)."""
    def build(rate):
        def f(pkg):
            q = pkg.layers.data("q", shape=[1, 1, 4, 8],
                                append_batch_size=False)
            return [pkg.layers.fused_attention(q, q, q, dropout_rate=rate,
                                               is_test=True)]
        return f

    feed = {"q": _rand(1, 1, 4, 8)}
    (plain,), _ = run_both(build(0.0), feed)
    (scaled,), _ = run_both(build(0.25), feed)
    np.testing.assert_allclose(scaled, plain * 0.75, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,axis", [((4, 6, 16), 2), ((5, 32), 1)])
def test_layer_norm_op(shape, axis):
    def build(pkg):
        x = pkg.layers.data("x", shape=list(shape), append_batch_size=False)
        return [pkg.layers.layer_norm(x, begin_norm_axis=axis)]

    run_both(build, {"x": _rand(*shape) * 2 + 0.5})


def test_mul_num_flatten_dims_2_via_fc():
    def build(pkg):
        x = pkg.layers.data("x", shape=[3, 5, 7], append_batch_size=False)
        return [pkg.layers.fc(x, size=4, num_flatten_dims=2, act="relu")]

    (out,), _ = run_both(build, {"x": _rand(3, 5, 7)})
    assert out.shape == (3, 5, 4)


def test_lookup_table_and_elementwise_add():
    def build(pkg):
        tok = pkg.layers.data("tok", shape=[2, 5, 1], append_batch_size=False,
                              dtype="int64")
        pos = pkg.layers.data("pos", shape=[2, 5, 1], append_batch_size=False,
                              dtype="int64")
        a = pkg.layers.embedding(tok, size=[11, 6])
        b = pkg.layers.embedding(pos, size=[5, 6])
        return [a, pkg.layers.elementwise_add(a, b)]

    rng = np.random.RandomState(0)
    feed = {"tok": rng.randint(0, 11, (2, 5, 1)).astype("int64"),
            "pos": np.tile(np.arange(5, dtype="int64"), (2, 1))[..., None]}
    (emb, _), _ = run_both(build, feed)
    assert emb.shape == (2, 5, 6)


def _kv_build(with_slot, s, h, tmax, d, bx, t):
    def build(pkg):
        block = pkg.default_main_program().global_block()
        cache = block.create_var(name="cache", shape=[s, h, tmax, d],
                                 dtype="float32", persistable=True)
        x = pkg.layers.data("x", shape=[bx, h, t, d], append_batch_size=False)
        inputs = {"Cache": [cache], "X": [x],
                  "Pos": [pkg.layers.data("p", shape=[bx],
                                          append_batch_size=False,
                                          dtype="int32")]}
        if with_slot:
            inputs["Slot"] = [pkg.layers.data("sl", shape=[bx],
                                              append_batch_size=False,
                                              dtype="int32")]
        block.append_op(type="kv_cache_write", inputs=inputs,
                        outputs={"Out": [cache]})
        return [cache]
    return build


@pytest.mark.parametrize("case", ["identity", "scattered_duplicate_slot",
                                  "identity_clamped", "scattered_clamped"])
def test_kv_cache_write_op(case):
    """Identity (decode), scattered Slot with a duplicated slot (the
    engine's padding rows), and start indices that clamp as
    ``lax.dynamic_update_slice`` clamps them when pos + t > Tmax."""
    s, h, tmax, d = 3, 2, 8, 4
    if case == "identity":
        bx, t, pos, slot = 3, 1, [0, 5, 7], None
    elif case == "identity_clamped":
        bx, t, pos, slot = 3, 3, [6, 9, 2], None
    elif case == "scattered_duplicate_slot":
        bx, t, pos, slot = 4, 3, [0, 2, 0, 0], [2, 0, 2, 2]
    else:
        bx, t, pos, slot = 2, 5, [6, 1], [1, 5]
    cache0 = _rand(s, h, tmax, d, seed=7)
    x = _rand(bx, h, t, d, seed=8)
    if case == "scattered_duplicate_slot":
        x[2:] = x[0]        # padding rows duplicate row 0, slot included
    feed = {"x": x, "p": np.asarray(pos, "int32")}
    if slot is not None:
        feed["sl"] = np.asarray(slot, "int32")
    (out,), (jscope, tscope) = run_both(
        _kv_build(slot is not None, s, h, tmax, d, bx, t), feed,
        state={"cache": cache0}, rtol=0, atol=0)
    # the port updated the scope's cache tensor in place and wrote it back
    np.testing.assert_array_equal(tscope.find_var("cache").numpy(), out)
    np.testing.assert_array_equal(
        np.asarray(jscope.find_var("cache")), out)
    if case.endswith("clamped"):
        # a clamped write still lands t whole rows (a slice would not)
        assert not np.array_equal(out, cache0)


def run_both_raw(build, feed):
    """Build ``build(pkg)`` (returns the fetch vars) in each package and
    run it on the CPU with ``return_numpy=False``; returns [(JAX fetch,
    port fetch), ...] after checking that the programs serialize alike."""
    outs, want_dict = [], None
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard("t_"):
            fetch = build(pkg)
        if pkg is fluid:
            want_dict = main.to_dict()
        else:
            assert main.to_dict() == want_dict
        outs.append(pkg.Executor(pkg.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=pkg.Scope(),
            return_numpy=False))
    return list(zip(*outs))


def _dtype_names(want, got):
    """(JAX dtype name with int32 read as int64, port dtype name)."""
    from paddle_tpu_torch.core import dtype_name

    wd = str(np.dtype(want.dtype))
    return ("int64" if wd == "int32" else wd), dtype_name(got.dtype)


@pytest.mark.parametrize("src,dst", [
    ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("float32", "int64"), ("int64", "float32"),
    ("bfloat16", "int64"), ("int64", "bfloat16"),
])
def test_cast_op(src, dst):
    """``layers.cast`` (and ``Variable.astype``) between float32, bfloat16
    and int64, against the JAX ``cast`` compute: equal dtypes and equal
    values (round to nearest even into bfloat16, truncation toward zero
    into int64)."""
    rng = np.random.RandomState(0)
    if src == "int64":
        feed = {"x": rng.randint(-300, 300, (4, 6)).astype("int64")}
    else:
        feed = {"x": (rng.randn(4, 6) * 50).astype("float32")}

    def build(pkg):
        x = pkg.layers.data("x", shape=[6],
                            dtype="int64" if src == "int64" else "float32")
        a = pkg.layers.cast(x, "bfloat16") if src == "bfloat16" else x
        return [a, pkg.layers.cast(a, dst), a.astype(dst)]

    for want, got in run_both_raw(build, feed):
        wd, gd = _dtype_names(want, got)
        assert wd == gd
        np.testing.assert_array_equal(
            got.float().numpy() if gd == "bfloat16" else got.numpy(),
            np.asarray(want).astype(np.float32 if wd == "bfloat16"
                                    else np.asarray(want).dtype))
    assert gd == dst


@pytest.mark.parametrize("case", ["dequantize_0dim_scale", "add_bias",
                                  "mul_one_element", "min_one_element"])
def test_mixed_dtype_promotion(case):
    """A bfloat16 activation meets a float32 operand, as under AMP: the
    dtype follows ``jnp`` promotion.  ``fake_dequantize_max_abs`` reshapes
    its float32 scale to 0-dim, which torch would promote like a Python
    number (to bfloat16) and ``jnp`` does not (float32); the elementwise
    ops with a float32 bias or one-element operand give float32."""
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(3, 8).astype("float32"),
            "s": np.abs(rng.randn(1)).astype("float32") + 0.5,
            "b": rng.randn(8).astype("float32")}

    def build(pkg):
        x = pkg.layers.data("x", shape=[8])
        s = pkg.layers.data("s", shape=[1], append_batch_size=False)
        b = pkg.layers.data("b", shape=[8], append_batch_size=False)
        xb = pkg.layers.cast(x, "bfloat16")
        block = pkg.default_main_program().global_block()
        out = block.create_var(name="out", dtype="float32")
        if case == "dequantize_0dim_scale":
            block.append_op(type="fake_dequantize_max_abs",
                            inputs={"X": [xb], "Scale": [s]},
                            outputs={"Out": [out]},
                            attrs={"max_range": 127.0})
        else:
            op_type, y = {"add_bias": ("elementwise_add", b),
                          "mul_one_element": ("elementwise_mul", s),
                          "min_one_element": ("elementwise_min", s)}[case]
            block.append_op(type=op_type, inputs={"X": [xb], "Y": [y]},
                            outputs={"Out": [out]}, attrs={"axis": -1})
        return [out]

    ((want, got),) = run_both_raw(build, feed)
    assert _dtype_names(want, got) == ("float32", "float32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
