"""The port's predictor API (``paddle_tpu_torch.inference``): the cases of
the JAX package's ``tests/test_inference_api.py`` on the port, on the CPU
(``use_gpu=False``), plus a model saved by the JAX package served by both
packages' predictors with the same outputs, and the place a config picks:
``CUDAPlace`` for ``use_gpu=True`` whether or not a card is present (no
fallback to the host)."""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import inference as j_inference

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                        PaddleTensor, create_paddle_predictor)

from test_torch_serving import fresh_torch_programs  # noqa: F401


def _mlp(pkg):
    x = pkg.layers.data("x", shape=[6])
    h = pkg.layers.fc(x, size=8, act="relu")
    h = pkg.layers.dropout(h, dropout_prob=0.5)
    return pkg.layers.fc(h, size=3, act="softmax")


def _save(pkg, path):
    pkg.default_startup_program().random_seed = 7
    pred = _mlp(pkg)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(pkg.default_startup_program())
        pkg.io.save_inference_model(path, ["x"], [pred], exe)
    return path


@pytest.fixture
def saved_model(tmp_path):
    return _save(pt, str(tmp_path / "model"))


def _cpu(cls, model_dir, **kw):
    return cls(model_dir=model_dir, use_gpu=False, **kw)


def test_native_predictor_runs(saved_model):
    pred = create_paddle_predictor(_cpu(NativeConfig, saved_model))
    assert pred.feed_names == ["x"]
    xv = np.random.RandomState(0).rand(4, 6).astype("float32")
    (out,) = pred.run([PaddleTensor(name="x", data=xv)])
    assert out.shape == (4, 3)
    np.testing.assert_allclose(np.asarray(out.data).sum(1), np.ones(4),
                               rtol=1e-5)
    (out2,) = pred.Run({"x": xv})
    np.testing.assert_array_equal(out.data, out2.data)


def test_analysis_predictor_deterministic_dropout(saved_model):
    """A saved model is an inference program: dropout is off, so two runs
    agree exactly."""
    pred = create_paddle_predictor(_cpu(AnalysisConfig, saved_model))
    xv = np.random.RandomState(1).rand(2, 6).astype("float32")
    np.testing.assert_array_equal(pred.run({"x": xv})[0].data,
                                  pred.run({"x": xv})[0].data)


def test_predictor_clone_shares_weights_and_is_threadsafe(saved_model):
    base = create_paddle_predictor(_cpu(AnalysisConfig, saved_model))
    xv = np.random.RandomState(2).rand(3, 6).astype("float32")
    want = base.run({"x": xv})[0].data
    results = {}

    def worker(i):
        results[i] = base.Clone().run({"x": xv})[0].data

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(4):
        np.testing.assert_array_equal(results[i], want)


def test_predictor_input_validation(saved_model):
    pred = create_paddle_predictor(_cpu(NativeConfig, saved_model))
    with pytest.raises(ValueError, match="not a feed target"):
        pred.run({"bogus": np.zeros((1, 6), "float32")})
    with pytest.raises(ValueError, match="missing inputs"):
        pred.run([])
    with pytest.raises(ValueError, match="has no data"):
        pred.run([PaddleTensor(name="x")])


def test_predictor_sequence_input_with_lod(tmp_path):
    pt.default_startup_program().random_seed = 3
    ids = pt.layers.data("ids", shape=[1], dtype="int64", lod_level=1)
    emb = pt.layers.embedding(ids, size=[20, 4])
    pooled = pt.layers.sequence_pool(emb, "sum")
    out = pt.layers.fc(pooled, size=2, act="softmax")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        pt.io.save_inference_model(str(tmp_path / "m2"), ["ids", "ids@LEN"],
                                   [out], exe)
    pred = create_paddle_predictor(_cpu(NativeConfig, str(tmp_path / "m2")))
    idv = np.random.RandomState(4).randint(0, 20, (2, 5, 1)).astype("int64")
    (o,) = pred.run([PaddleTensor(name="ids", data=idv, lod=[5, 3])])
    assert o.shape == (2, 2)
    # the lengths reach the pool: the second row sums 3 of its 5 ids
    (full,) = pred.run([PaddleTensor(name="ids", data=idv, lod=[5, 5])])
    np.testing.assert_array_equal(o.data[0], full.data[0])
    assert not np.array_equal(o.data[1], full.data[1])


def test_inference_transpiler_folds_bn_into_conv():
    """BN folding through the top-level ``InferenceTranspiler``: no
    ``batch_norm`` left, the same outputs as the unfolded inference
    program; the input program untouched; a train program folds too."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 9
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", shape=[3, 8, 8])
        c1 = pt.layers.conv2d(img, 8, 3, padding=1, bias_attr=False)
        b1 = pt.layers.batch_norm(c1, act="relu")
        c2 = pt.layers.conv2d(b1, 4, 1, bias_attr=False)
        b2 = pt.layers.batch_norm(c2, act=None)
        out = pt.layers.reduce_mean(b2, dim=[2, 3])
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            c = scope.var(op.inputs["Mean"][0]).shape[0]
            scope.set_var(op.inputs["Mean"][0],
                          torch.from_numpy(
                              rng.rand(c).astype("float32")))
            scope.set_var(op.inputs["Variance"][0],
                          torch.from_numpy(
                              (rng.rand(c) + 0.5).astype("float32")))
    infer = main.clone(for_test=True)
    xv = np.random.RandomState(0).rand(2, 3, 8, 8).astype("float32")
    (ref,) = exe.run(infer, feed={"img": xv}, fetch_list=[out.name],
                     scope=scope)
    opt = pt.InferenceTranspiler().transpile(infer, pt.CPUPlace(), scope)
    assert "batch_norm" not in [op.type for op in opt.global_block().ops]
    assert any(op.type == "batch_norm" for op in infer.global_block().ops)
    (got,) = exe.run(opt, feed={"img": xv}, fetch_list=[out.name],
                     scope=scope)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    opt2 = pt.InferenceTranspiler().transpile(main, pt.CPUPlace(), scope)
    assert not any(op.type == "batch_norm" for op in opt2.global_block().ops)


def test_clone_concurrency_separate_executors_shared_weights(saved_model):
    """Each clone owns its executor (and its entries), all share the one
    weight scope and program, and concurrent runs equal the base's."""
    base = create_paddle_predictor(_cpu(AnalysisConfig, saved_model))
    xv = np.random.RandomState(5).rand(4, 6).astype("float32")
    want = base.run({"x": xv})[0].data
    clones = [base.clone() for _ in range(2)]
    for c in clones:
        assert c._exe is not base._exe
        assert c._exe._analysis is not base._exe._analysis
        assert c._scope is base._scope and c._program is base._program
    results = {}

    def worker(i, p):
        results[i] = p.run({"x": xv})[0].data

    threads = [threading.Thread(target=worker, args=(i, c))
               for i, c in enumerate(clones)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, c in enumerate(clones):
        np.testing.assert_array_equal(results[i], want)
        assert len(c._exe._analysis) == 1


def test_predictor_serving_delegation_matches_direct(saved_model):
    """``enable_serving``: the batch goes through one shared
    continuous-batching engine in slot-sized requests; the outputs equal a
    direct run's and clones share the engine."""
    direct = create_paddle_predictor(_cpu(AnalysisConfig, saved_model))
    xv = np.random.RandomState(7).rand(5, 6).astype("float32")
    want = direct.run({"x": xv})[0].data
    pred = create_paddle_predictor(_cpu(AnalysisConfig, saved_model)
                                   .enable_serving(slots=4, timeout_s=60.0))
    try:
        np.testing.assert_array_equal(pred.run({"x": xv})[0].data, want)
        clone = pred.clone()
        np.testing.assert_array_equal(clone.run({"x": xv})[0].data, want)
        assert clone.serving_engine() is pred.serving_engine()
        assert pred.serving_engine().metrics.summary()["counts"][
            "completed"] == 4
    finally:
        pred.serving_engine().close()


def test_enable_serving_refuses_what_is_not_ported():
    cfg = AnalysisConfig(model_dir="unused", use_gpu=False)
    for kw in ({"tuned_config": "t.json"}, {"quarantine_dir": "q"}):
        with pytest.raises(NotImplementedError, match="A5"):
            cfg.enable_serving(**kw)
    assert cfg.enable_quantization() is cfg
    assert cfg.quantize_mode == "weight_only"


def test_quantized_predictor_runs(saved_model):
    """``enable_quantization``: int8 weights, outputs close to fp."""
    xv = np.random.RandomState(8).rand(3, 6).astype("float32")
    fp = create_paddle_predictor(_cpu(AnalysisConfig, saved_model))
    q = create_paddle_predictor(_cpu(AnalysisConfig, saved_model)
                                .enable_quantization("weight_only"))
    assert any(op.type == "dequant_matmul"
               for op in q._program.global_block().ops)
    np.testing.assert_allclose(q.run({"x": xv})[0].data,
                               fp.run({"x": xv})[0].data, atol=2e-2)


def test_jax_saved_model_serves_alike(tmp_path):
    """A model the JAX package saved, run by both packages' predictors on
    the CPU: the same outputs (rtol 1e-5)."""
    path = _save(fluid, str(tmp_path / "jax_model"))
    xv = np.random.RandomState(9).rand(4, 6).astype("float32")
    want = j_inference.create_paddle_predictor(j_inference.NativeConfig(
        model_dir=path, use_gpu=False)).run({"x": xv})[0].data
    got = create_paddle_predictor(_cpu(NativeConfig, path)).run(
        {"x": xv})[0].data
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cls", [NativeConfig, AnalysisConfig])
def test_config_place_has_no_fallback(cls):
    """``use_gpu=True`` is ``CUDAPlace(device)`` even with no card here (a
    run then fails instead of moving to the host); ``use_gpu=False`` is the
    CPU."""
    assert cls(model_dir="m", device=1)._place() == pt.CUDAPlace(1)
    assert cls(model_dir="m")._place() == pt.CUDAPlace(0)
    assert isinstance(cls(model_dir="m", use_gpu=False)._place(),
                      pt.CPUPlace)
