"""The Fluid frontend of the port held against the JAX package on the CPU.

* every layer the port gained (the rest of ``layers/tensor.py``'s
  ``__all__``, ``layers/nn.py``'s plain-op layers, ``Print`` and
  ``is_empty``, the generator's layers) builds main and startup programs
  equal to the JAX package's, and the same fetches from the JAX startup
  state (bit for bit for bool and integer outputs, rtol 1e-5 for float;
  the random layers by shape and range);
* every ``Variable`` operator, with a Variable or a Python number on
  either side, and ``astype``, builds the JAX patch's ops and computes the
  same values, also on a batch dim of -1 (``fill_constant_batch_size_like``);
* ``generate_layer_fn`` and its kin, ``lod_tensor``, ``metrics``,
  ``op.Operator``, ``default_scope_funcs``, ``compat`` and
  ``annotations`` against the JAX modules on the same inputs."""

import operator
import warnings

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.models.mnist  # noqa: F401
from paddle_tpu import compat as jax_compat
from paddle_tpu import default_scope_funcs as jax_dsf
from paddle_tpu import lod_tensor as jax_lod
from paddle_tpu import metrics as jax_metrics
from paddle_tpu import op as jax_op
from paddle_tpu.layers import tensor as jax_tensor, nn as jax_nn

import paddle_tpu_torch as pt
from paddle_tpu_torch import compat, default_scope_funcs, lod_tensor, metrics
from paddle_tpu_torch import op as pt_op
from paddle_tpu_torch.convert import load_numpy_state

from test_torch_serving import fresh_torch_programs  # noqa: F401


def _run(pkg, build, feed, state=None):
    """(main dict, startup dict, fetches, the startup's state) of the
    program ``build(pkg)`` makes; the port starts from ``state``, the JAX
    startup's."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fetch = build(pkg)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    if pkg is fluid:
        exe.run(startup, scope=scope)
        state = {v.name: np.array(scope.find_var(v.name), copy=True)
                 for v in startup.list_vars() if v.persistable}
    else:
        load_numpy_state(scope, startup, state, "cpu")
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return main.to_dict(), startup.to_dict(), \
        [np.asarray(g) for g in got], state


def follows_jax(build, feed, random=False, rtol=1e-5):
    """Equal programs; the fetches of both packages (bit for bit where
    bool or integer; by shape and dtype kind where ``random``)."""
    want_main, want_start, want, state = _run(fluid, build, feed)
    got_main, got_start, got, _ = _run(pt, build, feed, state)
    assert got_main == want_main
    assert got_start == want_start
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if random:
            assert g.dtype.kind == w.dtype.kind
        elif g.dtype.kind in "biu":
            assert g.dtype.kind == w.dtype.kind
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6)
    return got


RNG = np.random.RandomState(0)
X = RNG.randn(3, 4).astype("float32")
IMG = RNG.randn(2, 3, 5, 6).astype("float32")
IDS = np.asarray([[2], [0], [3]], "int64")
FEED = {"x": X, "y": RNG.randn(3, 4).astype("float32"), "img": IMG,
        "ids": IDS, "b": RNG.rand(3, 4) > 0.5}


def _inputs(pkg):
    L = pkg.layers
    return (L.data("x", shape=[4]), L.data("y", shape=[4]),
            L.data("img", shape=[3, 5, 6]),
            L.data("ids", shape=[1], dtype="int64"),
            L.data("b", shape=[4], dtype="bool"))


def _tensor_layers(pkg):
    """{layer name: fn(pkg) -> fetches}: every name the port's
    ``layers/tensor.py`` gained."""
    def fx(f):
        def build(p):
            x, y, img, ids, b = _inputs(p)
            return f(p.layers, x, y, img, ids, b)
        return build

    return {
        "create_tensor": fx(lambda L, x, *_: [L.assign(
            x, L.create_tensor("float32"))]),
        "create_global_var": fx(lambda L, x, *_: [L.elementwise_add(
            x, L.create_global_var([4], 1.5, "float32", persistable=True,
                                   name="gv"))]),
        "create_parameter": fx(lambda L, x, *_: [L.elementwise_mul(
            x, L.create_parameter(
                [4], "float32", name="w0",
                default_initializer=pkg.initializer.ConstantInitializer(
                    0.5)))]),
        "assign": fx(lambda L, x, *_: [L.assign(x), L.assign(
            np.arange(6, dtype="float32").reshape(2, 3))]),
        "argmin": fx(lambda L, x, *_: [L.argmin(x, axis=1)]),
        "argmax": fx(lambda L, x, *_: [L.argmax(x, axis=0)]),
        "argsort": fx(lambda L, x, *_: list(L.argsort(x, axis=1))),
        "ones": fx(lambda L, *_: [L.ones([2, 3], "float32")]),
        "zeros": fx(lambda L, *_: [L.zeros([2, 3], "int64")]),
        "reverse": fx(lambda L, x, y, img, *_: [L.reverse(img, [1, 3]),
                                                L.reverse(x, 0)]),
        "split": fx(lambda L, x, y, img, *_: L.split(img, [2, 4], dim=-1)
                    + L.split(img, 3, dim=1)),
        "stack": fx(lambda L, x, y, *_: [L.stack([x, y], axis=1)]),
        "expand": fx(lambda L, x, *_: [L.expand(x, [2, 3])]),
        "shape": fx(lambda L, x, y, img, *_: [L.shape(img)]),
        "reduce_max": fx(lambda L, x, y, img, *_: [
            L.reduce_max(img, dim=[1, 3]), L.reduce_max(x)]),
        "reduce_min": fx(lambda L, x, y, img, *_: [
            L.reduce_min(img, dim=-1, keep_dim=True)]),
        "reduce_prod": fx(lambda L, x, *_: [L.reduce_prod(x, dim=1)]),
        "gather": fx(lambda L, x, y, img, ids, b: [L.gather(x, ids)]),
        "scatter": fx(lambda L, x, y, img, ids, b: [
            L.scatter(x, ids, y, overwrite=False)]),
        "pad": fx(lambda L, x, *_: [L.pad(x, [1, 0, 0, 2], 0.5)]),
        "pad2d": fx(lambda L, x, y, img, *_: [
            L.pad2d(img, [1, 0, 2, 1], mode="reflect")]),
        "pad_constant_like": fx(lambda L, x, y, img, *_: [
            L.pad_constant_like(img, L.reduce_sum(img, dim=[2],
                                                  keep_dim=True))]),
        "crop": fx(lambda L, x, y, img, *_: [
            L.crop(img, shape=[2, 2, 3, 4], offsets=[0, 1, 1, 2])]),
        "random_crop": fx(lambda L, x, y, img, *_: [
            L.random_crop(img, [3, 4])]),
        "unstack": fx(lambda L, x, *_: L.unstack(x, axis=1)),
        "uniform_random_batch_size_like": fx(lambda L, x, *_: [
            L.uniform_random_batch_size_like(x, [-1, 7])]),
        "gaussian_random_batch_size_like": fx(lambda L, x, *_: [
            L.gaussian_random_batch_size_like(x, [-1, 7], std=2.0)]),
        "cumsum": fx(lambda L, x, *_: [
            L.cumsum(x, axis=1, exclusive=True, reverse=True)]),
        "increment": fx(lambda L, x, *_: [
            L.increment(L.reduce_sum(x), value=2.0, in_place=False)]),
        "isfinite": fx(lambda L, x, *_: [L.isfinite(x)]),
        "has_inf": fx(lambda L, x, *_: [L.has_inf(x)]),
        "has_nan": fx(lambda L, x, *_: [L.has_nan(x)]),
        "less_than": fx(lambda L, x, y, *_: [L.less_than(x, y)]),
        "equal": fx(lambda L, x, y, *_: [L.equal(x, x)]),
        "less_equal": fx(lambda L, x, y, *_: [L.less_equal(x, y)]),
        "greater_than": fx(lambda L, x, y, *_: [L.greater_than(x, y)]),
        "greater_equal": fx(lambda L, x, y, *_: [L.greater_equal(x, y)]),
        "not_equal": fx(lambda L, x, y, *_: [L.not_equal(x, y)]),
        "logical_and": fx(lambda L, x, y, img, ids, b: [
            L.logical_and(b, L.less_than(x, y))]),
        "logical_or": fx(lambda L, x, y, img, ids, b: [
            L.logical_or(b, L.less_than(x, y))]),
        "logical_xor": fx(lambda L, x, y, img, ids, b: [
            L.logical_xor(b, L.less_than(x, y))]),
        "logical_not": fx(lambda L, x, y, img, ids, b: [
            L.logical_not(b)]),
    }


def _nn_layers(pkg):
    def fx(f):
        def build(p):
            x, y, img, ids, b = _inputs(p)
            return f(p.layers, x, y, img, ids, b)
        return build

    return {
        "one_hot": fx(lambda L, x, y, img, ids, b: [L.one_hot(ids, 5)]),
        "mul": fx(lambda L, x, y, img, *_: [
            L.mul(img, L.reshape(y, [6, -1]), x_num_col_dims=3),
            L.mul(x, L.transpose(y, [1, 0]))]),
        "label_smooth": fx(lambda L, x, y, img, ids, b: [
            L.label_smooth(L.one_hot(ids, 5), epsilon=0.2)]),
        "sampling_id": fx(lambda L, x, *_: [
            L.sampling_id(L.softmax(x))]),
        "smooth_l1": fx(lambda L, x, y, *_: [
            L.smooth_l1(x, y, inside_weight=y, sigma=2.0)]),
        "clip": fx(lambda L, x, *_: [L.clip(x, -0.5, 0.7)]),
        "clip_by_norm": fx(lambda L, x, *_: [L.clip_by_norm(x, 1.0)]),
        "flatten": fx(lambda L, x, y, img, *_: [L.flatten(img, axis=2)]),
        "sum": fx(lambda L, x, y, *_: [L.sum([x, y, x]), L.sum(x)]),
        "multiplex": fx(lambda L, x, y, img, ids, b: [
            L.multiplex([x, y], L.cast(L.reduce_sum(
                L.cast(ids, "int32"), dim=1, keep_dim=True) * 0 + 1,
                "int32"))]),
        "rank_loss": fx(lambda L, x, y, *_: [
            L.rank_loss(L.cast(L.less_than(x, y), "float32"), x, y)]),
        "sigmoid_cross_entropy_with_logits": fx(lambda L, x, y, *_: [
            L.sigmoid_cross_entropy_with_logits(x, L.sigmoid(y))]),
        "gaussian_random": fx(lambda L, *_: [
            L.gaussian_random([3, 5], mean=1.0, std=0.5)]),
        "dice_loss": fx(lambda L, x, y, img, ids, b: [
            L.dice_loss(L.softmax(L.fc(x, 5)), ids)]),
        "Print": fx(lambda L, x, *_: [L.Print(x, message="m",
                                              print_phase="forward")]),
        "is_empty": fx(lambda L, x, *_: [L.is_empty(x)]),
    }


RANDOM_LAYERS = {"random_crop", "uniform_random_batch_size_like",
                 "gaussian_random_batch_size_like", "sampling_id",
                 "gaussian_random"}
LAYERS = sorted(_tensor_layers(pt)) + sorted(_nn_layers(pt))


def test_layer_names_cover_the_jax_modules():
    """``layers`` has every name of ``layers/tensor.py``'s ``__all__`` and
    of ``layers/nn.py``'s (``nce``, ``hsigmoid``,
    ``bilinear_tensor_product`` and ``mean_iou`` since their op types
    came, with their cases in ``test_torch_sampled_metric.py``), plus
    ``Print``, ``is_empty`` and the generator's five; each of the
    frontend slice's names has a case below."""
    missing = [n for n in jax_tensor.__all__ + jax_nn.__all__
               if not hasattr(pt.layers, n)]
    assert missing == []
    for n in ("Print", "is_empty", "deprecated", "generate_layer_fn",
              "generate_layer_fn_noattr", "autodoc", "templatedoc"):
        assert callable(getattr(pt.layers, n)), n
    assert sorted(pt.layers.tensor.__all__) == sorted(jax_tensor.__all__)
    new = [n for n in jax_tensor.__all__ if n in _tensor_layers(pt)]
    assert len(new) == 42
    assert len([n for n in _nn_layers(pt) if n in jax_nn.__all__]) == 14


@pytest.mark.parametrize("name", LAYERS)
def test_layer_follows_jax(name):
    def build(pkg):
        return {**_tensor_layers(pkg), **_nn_layers(pkg)}[name](pkg)

    follows_jax(build, FEED, random=name in RANDOM_LAYERS)


# -- Variable operators ------------------------------------------------------

OPERATORS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "pow": operator.pow,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt,
    "ge": operator.ge,
}


@pytest.mark.parametrize("side", ["var_var", "var_num", "num_var"])
@pytest.mark.parametrize("op_name", sorted(OPERATORS))
def test_variable_operator_follows_jax(op_name, side):
    """``a op b`` with a Variable or a number on either side (number 2.5 on
    a batch of -1: ``fill_constant_batch_size_like``)."""
    fn = OPERATORS[op_name]
    pos = {"x": np.abs(X) + 0.5, "y": np.abs(FEED["y"]) + 0.5}

    def build(pkg):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.data("y", shape=[4])
        if side == "var_var":
            out = fn(x, y)
        elif side == "var_num":
            out = fn(x, 2.5)
        else:
            out = fn(2.5, x)
        return [out]

    if side == "num_var" and op_name == "pow":
        with pytest.raises(TypeError):
            build(pt)     # no __rpow__, in either package
        return
    follows_jax(build, pos)


@pytest.mark.parametrize("shape", [[4], [-1, 4], [3, 4]],
                         ids=["batch", "explicit_batch", "static"])
def test_variable_operators_compose(shape):
    """A script in the Fluid style: ``-a``, ``astype``, comparisons and
    arithmetic mixed with numbers, on a static shape too (``fill_constant``
    of shape [1] then)."""
    feed = {"x": X, "y": FEED["y"]}

    def build(pkg):
        kw = {} if shape == [4] else {"append_batch_size": False}
        x = pkg.layers.data("x", shape=shape, **kw)
        y = pkg.layers.data("y", shape=shape, **kw)
        loss = pkg.layers.mean((x - y) * (x - y)) * 0.5 + 1
        frac = (x < y).astype("float32")
        z = -x / 3 + (y * 0 + 1) ** 2 - (1.0 - x) * 4
        return [loss, frac, z, (x >= 0.25), 3 - y, y / 2.0]

    follows_jax(build, feed)


def test_astype_is_the_patch_s():
    """One definition: the patch installs ``Variable.astype``; its program
    is the JAX patch's (``cast`` with the dtype's name)."""
    from paddle_tpu_torch.layers import math_op_patch

    assert pt.Variable.astype is math_op_patch._astype
    assert "astype" not in pt.framework.Variable.__dict__ or \
        pt.framework.Variable.__dict__["astype"] is math_op_patch._astype
    follows_jax(lambda pkg: [pkg.layers.data("ids", shape=[1],
                                             dtype="int64").astype("float32")],
                {"ids": IDS})


def test_variables_stay_hashable_and_equal_by_identity():
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data("x", shape=[4])
        y = pt.layers.data("y", shape=[4])
    n_ops = len(main.global_block().ops)
    assert {x: 1, y: 2}[x] == 1
    assert x == x and x != y and x in [y, x]
    assert len(main.global_block().ops) == n_ops


# -- layer_function_generator -------------------------------------------------

def test_generated_layers_follow_jax():
    """``generate_layer_fn`` over a registered op (slots by position and by
    name, attrs as keywords, ``act``), ``generate_layer_fn_noattr``; the
    docs come from ``OpDef.doc``."""
    def build(pkg):
        g = pkg.layers.layer_function_generator
        x, y = pkg.layers.data("x", shape=[4]), pkg.layers.data("y",
                                                                shape=[4])
        clip = g.generate_layer_fn("clip")
        mod = g.generate_layer_fn("elementwise_floordiv")
        tanh = g.generate_layer_fn_noattr("tanh")
        sort_out, sort_ids = g.generate_layer_fn("argsort")(x, axis=1)
        return [clip(x, min=-0.3, max=0.4, act="relu"), mod(x, Y=y),
                tanh(y), sort_out, sort_ids]

    follows_jax(build, FEED)
    g = pt.layers.layer_function_generator
    assert g.generate_layer_fn("clip").__doc__ == \
        "clip layer (generated from the op registry)"
    pt.registry.OPS["clip"].doc = "Clip X to [min, max]."
    try:
        assert g.generate_layer_fn("clip").__doc__ == "Clip X to [min, max]."

        @g.templatedoc("clip")
        def f():
            """Says: ${comment}"""

        @g.autodoc("note: ")
        def clip():
            pass

        assert f.__doc__ == "Says: Clip X to [min, max]."
        assert clip.__doc__ == "note: Clip X to [min, max]."
    finally:
        pt.registry.OPS["clip"].doc = ""
    with pytest.raises(ValueError):
        g.generate_layer_fn("no_such_op")


def test_deprecated_warns_like_jax():
    def mark(pkg):
        @pkg.layers.deprecated("0.15", "new_api", "see the notes")
        def old_api(a):
            """Old."""
            return a + 1
        return old_api

    for pkg in (fluid, pt):
        f = mark(pkg)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            assert f(1) == 2
        assert [str(w.message) for w in seen] == [
            "API old_api is deprecated since 0.15. Please use new_api "
            "instead. see the notes"]
    assert mark(pt).__doc__ == mark(fluid).__doc__


# -- lod_tensor, metrics, op, default_scope_funcs, compat ---------------------

def _lod_pairs():
    words = [[1, 2, 3], [4], [5, 6]]
    flat = np.arange(12, dtype="float32").reshape(6, 2)
    return [
        (lambda m: m.create_lod_tensor(words, [[3, 1, 2]])),
        (lambda m: m.create_lod_tensor(flat, [[2, 4]])),
        (lambda m: m.create_lod_tensor(m.create_lod_tensor(flat, [[2, 4]]),
                                       [[3, 3]])),
    ]


@pytest.mark.parametrize("i", range(3))
def test_create_lod_tensor_follows_jax(i):
    make = _lod_pairs()[i]
    got, want = make(lod_tensor), make(jax_lod)
    for a, b in ((got.data, want.data), (got.seq_lens, want.seq_lens)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.lod() == want.lod()
    assert got.recursive_sequence_lengths() == \
        want.recursive_sequence_lengths()
    assert got.has_valid_recursive_sequence_lengths()
    assert sorted(got.as_feed("w")) == ["w", "w@LEN"]


def test_lod_tensor_surface_follows_jax():
    out = []
    for m in (lod_tensor, jax_lod):
        t = m.LoDTensor()
        t.set(np.ones((2, 3, 1), "int64"))
        t.set_recursive_sequence_lengths([[3, 1]])
        lod = t.lod()
        t.set_lod([[0, 2, 5]])
        np.random.seed(4)
        r = m.create_random_int_lodtensor([[2, 3]], [1], low=0, high=9)
        out.append((lod, t.seq_lens.tolist(), r.data, r.seq_lens,
                    np.asarray(t).shape, isinstance(m.LoDTensorArray(), list)))
        with pytest.raises(NotImplementedError):
            t.set_lod([[0, 1], [0, 1]])
        with pytest.raises(ValueError):
            t.set_lod([[1, 2]])
    (a, b) = out
    assert a[0] == b[0] == [[0, 3, 4]] and a[1] == b[1] == [2, 3]
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3], b[3])
    assert a[4:] == b[4:]
    assert pt.create_lod_tensor is lod_tensor.create_lod_tensor
    assert pt.LoDTensor is lod_tensor.LoDTensor


def test_lod_tensor_feeds_a_sequence_program():
    """A ``create_lod_tensor`` batch feeds a ``lod_level=1`` data var as
    its padded data plus ``@LEN``."""
    seq = lod_tensor.create_lod_tensor([[1, 2, 3], [4]], [[3, 1]])
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        w = pt.layers.data("w", shape=[1], dtype="int64", lod_level=1)
        emb = pt.layers.embedding(w, size=[8, 2], param_attr="e")
        out = pt.layers.sequence_pool(emb, "sum")
    scope = pt.Scope()
    scope.set_var("e", np.arange(16, dtype="float32").reshape(8, 2))
    got, = pt.Executor(pt.CPUPlace()).run(main, feed=seq.as_feed("w"),
                                          fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(got, [[12, 15], [8, 9]])


def _metric_runs(m):
    rng = np.random.RandomState(3)
    acc = m.Accuracy()
    prec, rec = m.Precision(), m.Recall()
    auc = m.Auc("auc", num_thresholds=50)
    comp = m.CompositeMetric()
    comp.add_metric(m.Precision())
    comp.add_metric(m.Recall())
    ed = m.EditDistance("ed")
    chunk = m.ChunkEvaluator()
    for _ in range(4):
        acc.update(value=rng.rand(), weight=int(rng.randint(1, 9)))
        preds = rng.randint(0, 2, (16, 1))
        labels = rng.randint(0, 2, (16, 1))
        prec.update(preds, labels)
        rec.update(preds, labels)
        comp.update(preds, labels)
        probs = rng.rand(16, 2)
        auc.update(probs, labels)
        ed.update(rng.rand(5, 1) * 3, 5)
        chunk.update(*rng.randint(5, 12, 3))
    res = [acc.eval(), prec.eval(), rec.eval(), auc.eval(), comp.eval(),
           ed.eval(), chunk.eval()]
    acc.reset()
    return res, acc.value, acc.weight


def test_metrics_follow_jax():
    got, want = _metric_runs(metrics), _metric_runs(jax_metrics)
    np.testing.assert_equal(got, want)
    assert metrics.__all__ == jax_metrics.__all__


def test_metric_detection_map_follows_jax():
    def run(m, version):
        dm = m.DetectionMAP(overlap_threshold=0.5, ap_version=version)
        for det, boxes, labels in (
                ([[1, 0.9, 0, 0, 2, 2], [1, 0.6, 5, 5, 7, 7],
                  [2, 0.8, 1, 1, 3, 3]],
                 [[0, 0, 2, 2], [1, 1, 3, 4]], [1, 2]),
                ([[2, 0.7, 0, 0, 1, 1], [1, 0.3, 2, 2, 4, 4]],
                 [[0, 0, 1, 1], [2, 2, 4, 5], [6, 6, 7, 7]], [2, 1, 1])):
            dm.update(np.asarray(det, "float32"), np.asarray(boxes,
                                                             "float32"),
                      np.asarray(labels))
        return dm.eval()

    for version in ("integral", "11point"):
        assert run(metrics, version) == run(jax_metrics, version)


def test_operator_specs_follow_jax():
    """``op.Operator`` checks the keywords against the registry and builds
    the same spec; every registered type of the port lists."""
    for m in (pt_op, jax_op):
        spec = m.Operator("scale", X="x", Out=["y"], scale=2.0)
        assert spec == {"type": "scale", "inputs": {"X": ["x"]},
                        "outputs": {"Out": ["y"]}, "attrs": {"scale": 2.0}}
        assert m.Operator("less_than", X="a", Y="b", Out="c") == \
            jax_op.Operator("less_than", X="a", Y="b", Out="c")
        with pytest.raises(ValueError):
            m.Operator("scale", "x")
        with pytest.raises(KeyError):
            m.Operator("no_such_op")
    assert [d.type for d in pt_op.get_all_op_protos()] == \
        sorted(pt.registry.OPS)
    assert pt_op.Operator.types() == sorted(pt.registry.OPS)
    with pytest.raises(TypeError):
        pt_op.OpDescCreationMethod("scale")
    # a spec appends as an op
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data("x", shape=[3])
        spec = pt_op.Operator("scale", X=x.name, Out="y", scale=3.0)
        main.global_block().create_var(name="y")
        main.global_block().append_op(**spec)
    got, = pt.Executor(pt.CPUPlace()).run(
        main, feed={"x": np.ones((2, 3), "float32")}, fetch_list=["y"],
        scope=pt.Scope())
    np.testing.assert_array_equal(got, np.full((2, 3), 3.0))


def test_default_scope_funcs_follow_jax():
    for m, pkg in ((default_scope_funcs, pt), (jax_dsf, fluid)):
        root = m.get_cur_scope()
        assert root is pkg.global_scope()
        kid = m.enter_local_scope()
        assert m.get_cur_scope() is kid and kid.parent is root
        assert kid in root.kids
        v = m.var("dsf_a")
        assert repr(v) == "<unset var>"
        assert m.find_var("dsf_a") is v
        seen = m.scoped_function(lambda: m.get_cur_scope())
        assert seen is not kid and seen.parent is kid
        assert kid.kids == []
        m.leave_local_scope()
        assert m.get_cur_scope() is root and root.kids == []
        with pytest.raises(RuntimeError):
            m.leave_local_scope()


@pytest.mark.parametrize("call", [
    lambda c: c.to_text([b"a", {b"k": b"v"}, {b"s"}, 3, None]),
    lambda c: c.to_bytes(["a", {"k": "v"}, 2.5]),
    lambda c: [c.round(x, d) for x in (2.5, -2.5, 0.125, -1.0, 0.0)
               for d in (0, 2)],
    lambda c: (c.floor_division(-7, 2), c.int_type, c.long_type),
    lambda c: c.get_exception_message(ValueError("boom")),
    lambda c: c.to_text(["x", b"y"], inplace=True),
], ids=["to_text", "to_bytes", "round", "floor_division", "exception",
        "inplace"])
def test_compat_follows_jax(call):
    assert call(compat) == call(jax_compat)
    assert compat.__all__ == jax_compat.__all__


def test_mnist_models_are_exported():
    from paddle_tpu_torch.models import mnist

    assert mnist.__all__ == ["mlp", "cnn_model"]
    assert pt.models.mnist is mnist
    follows_jax(lambda pkg: [pkg.models.mnist.mlp(
        pkg.layers.data("x", shape=[4]), hidden_sizes=(6, 5), class_dim=3)],
        {"x": X})
