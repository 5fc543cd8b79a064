"""The rest of the CNN op family held against the JAX package on the CPU.

Every op type the port gained with it (``conv3d``, the three transposed
convolutions, ``conv_shift``; ``pool3d`` and adaptive ``pool2d`` /
``pool3d``, ``max_pool2d_with_index`` / ``max_pool3d_with_index`` and
their grad op ``max_pool_with_index_grad``, ``spp``, ``unpool``;
``group_norm``, ``norm``, ``bilinear_interp``, ``nearest_interp``) runs as
a one-op program built in both packages: the programs serialize alike, the
forward outputs agree within rtol 1e-5 / atol 1e-6 (adaptive pooling rtol
1e-6; ``Mask``, ``unpool``'s placement and ``nearest_interp``'s gather
exactly), and the gradient of
``mean(Out * w)`` with respect to every floating input within relative L2
1e-4.  The layers (``conv3d``, ``conv2d_transpose``, ``conv3d_transpose``,
``pool3d``, ``group_norm``, ``image_resize``, ``resize_bilinear``,
``l2_normalize``, ``image_resize_short``) build programs equal to the JAX
package's and compute the same forward from the JAX startup state."""

import numpy as np
import pytest

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_numpy_params

from test_torch_serving import (fresh_torch_programs,  # noqa: F401
                                params_from_jax_scope)


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype("float32")


def _distinct(rng, *shape):
    """Values with no two equal in any window (a max has one argmax)."""
    n = int(np.prod(shape))
    return (rng.permutation(n).reshape(shape) / n * 4 - 2).astype("float32")


def one_op(pkg, op_type, inputs, attrs, outputs, diff):
    """(program dict, forward outputs, gradients of ``diff``'s slots) of one
    op on ``inputs`` ({slot: array}), the loss ``mean(outputs[0] * w)``."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        block = main.global_block()
        ins = {}
        for slot, arr in inputs.items():
            v = pkg.layers.data(slot.lower(), shape=list(arr.shape),
                                append_batch_size=False, dtype=str(arr.dtype))
            v.stop_gradient = slot not in diff
            ins[slot] = [v]
        outs = {s: block.create_var(name=pkg.unique_name.generate(s.lower()))
                for s in outputs}
        block.append_op(type=op_type, inputs=ins,
                        outputs={s: [v] for s, v in outs.items()},
                        attrs=dict(attrs))
        head = outs[outputs[0]]
        w = pkg.layers.data("w", shape=list(head.shape),
                            append_batch_size=False)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(head, w))
        pkg.backward.append_backward(loss)
    feed = {slot.lower(): arr for slot, arr in inputs.items()}
    feed["w"] = np.random.RandomState(1).rand(
        *[int(d) for d in head.shape]).astype("float32")
    fetch = [outs[s] for s in outputs] + [s.lower() + "@GRAD" for s in diff]
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    got = [np.asarray(v) for v in exe.run(main, feed=feed, fetch_list=fetch,
                                          scope=scope)]
    return main.to_dict(), got[:len(outputs)], got[len(outputs):]


def _unpool_inputs(rng):
    """X [2, 3, 3, 4] and int32 offsets into the 6 x 8 plane, distinct,
    with -1 (the last position), 48 and -60 (both out of the plane,
    dropped) in every plane."""
    x = _randn(rng, 2, 3, 3, 4)
    idx = np.stack([rng.permutation(47)[:12] for _ in range(6)])
    idx[:, 3], idx[:, 7], idx[:, 10] = -1, 48, -60
    return {"X": x, "Indices": idx.reshape(2, 3, 3, 4).astype("int32")}


def _case(op_type, inputs, attrs, outputs=("Out",), diff=("X",), exact=(),
          id=None):
    return pytest.param(op_type, inputs, attrs, outputs, diff, exact,
                        id=id or op_type)


# adaptive average pooling is a mean of means, axis by axis, in both
# packages: equal to a window mean only up to rounding, held tighter
ADAPTIVE_RTOL = 1e-6


def _cases():
    rng = np.random.RandomState(0)
    conv = ("Output",)
    return [
        _case("conv3d", {"Input": _randn(rng, 2, 3, 5, 6, 4),
                         "Filter": _randn(rng, 4, 3, 3, 3, 3, scale=0.3)},
              {"strides": [1, 2, 1], "paddings": [1, 0, 1],
               "dilations": [1, 1, 2], "groups": 1}, conv,
              ("Input", "Filter")),
        _case("conv3d", {"Input": _randn(rng, 2, 4, 4, 5, 4),
                         "Filter": _randn(rng, 6, 2, 2, 3, 2, scale=0.3)},
              {"strides": [1, 1, 1], "paddings": [0, 1, 0],
               "dilations": [1, 1, 1], "groups": 2}, conv,
              ("Input", "Filter"), id="conv3d_groups2"),
        _case("conv2d_transpose", {"Input": _randn(rng, 2, 4, 5, 6),
                                   "Filter": _randn(rng, 4, 3, 3, 3)},
              {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 2],
               "groups": 1}, conv, ("Input", "Filter")),
        _case("conv2d_transpose", {"Input": _randn(rng, 2, 4, 5, 5),
                                   "Filter": _randn(rng, 4, 3, 2, 3)},
              {"strides": [2, 2], "paddings": [0, 1], "dilations": [1, 1],
               "groups": 2}, conv, ("Input", "Filter"),
              id="conv2d_transpose_groups2"),
        _case("conv3d_transpose", {"Input": _randn(rng, 2, 4, 3, 4, 3),
                                   "Filter": _randn(rng, 4, 2, 2, 3, 2)},
              {"strides": [2, 1, 2], "paddings": [0, 1, 0],
               "dilations": [1, 1, 1], "groups": 1}, conv,
              ("Input", "Filter")),
        _case("depthwise_conv2d_transpose",
              {"Input": _randn(rng, 2, 4, 5, 5),
               "Filter": _randn(rng, 4, 1, 3, 3)},
              {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
               "groups": 4}, conv, ("Input", "Filter")),
        _case("conv_shift", {"X": _randn(rng, 3, 8), "Y": _randn(rng, 3, 5)},
              {}, diff=("X", "Y")),
        _case("pool2d", {"X": _randn(rng, 2, 3, 7, 9)},
              {"pooling_type": "avg", "ksize": [3, 4], "adaptive": True},
              id="pool2d_adaptive_avg"),
        _case("pool2d", {"X": _distinct(rng, 2, 3, 7, 9)},
              {"pooling_type": "max", "ksize": [3, 4], "adaptive": True},
              id="pool2d_adaptive_max"),
        _case("pool2d", {"X": _randn(rng, 2, 7, 9, 3)},
              {"pooling_type": "avg", "ksize": [2, 5], "adaptive": True,
               "data_format": "NHWC"}, id="pool2d_adaptive_avg_nhwc"),
        _case("pool3d", {"X": _distinct(rng, 2, 3, 5, 6, 7)},
              {"pooling_type": "max", "ksize": [2, 3, 2],
               "strides": [2, 2, 1], "paddings": [1, 0, 1],
               "ceil_mode": True}, id="pool3d_max_ceil"),
        _case("pool3d", {"X": _randn(rng, 2, 3, 5, 6, 7)},
              {"pooling_type": "avg", "ksize": [3, 3, 2],
               "strides": [2, 2, 2], "paddings": [1, 1, 0],
               "ceil_mode": True, "exclusive": True},
              id="pool3d_avg_exclusive_ceil"),
        _case("pool3d", {"X": _randn(rng, 2, 3, 5, 6, 7)},
              {"pooling_type": "avg", "ksize": [2, 2, 3],
               "strides": [1, 2, 2], "paddings": [1, 1, 1],
               "exclusive": False}, id="pool3d_avg_inclusive"),
        _case("pool3d", {"X": _randn(rng, 2, 3, 5, 6, 7)},
              {"pooling_type": "avg", "ksize": [2, 4, 3], "adaptive": True},
              id="pool3d_adaptive_avg"),
        _case("pool3d", {"X": _distinct(rng, 2, 3, 5, 6, 7)},
              {"pooling_type": "max", "ksize": [1, 1, 1],
               "global_pooling": True}, id="pool3d_global_max"),
        _case("max_pool2d_with_index", {"X": _distinct(rng, 2, 3, 7, 8)},
              {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
              ("Out", "Mask"), exact=("Mask",)),
        _case("max_pool2d_with_index", {"X": _distinct(rng, 2, 3, 5, 6)},
              {"ksize": [2, 2], "global_pooling": True}, ("Out", "Mask"),
              exact=("Mask",), id="max_pool2d_with_index_global"),
        _case("max_pool3d_with_index", {"X": _distinct(rng, 2, 2, 5, 6, 4)},
              {"ksize": [2, 3, 2], "strides": [2, 2, 2],
               "paddings": [1, 0, 1]}, ("Out", "Mask"), exact=("Mask",)),
        _case("spp", {"X": _distinct(rng, 2, 3, 9, 7)},
              {"pyramid_height": 3, "pooling_type": "max"}, id="spp_max"),
        _case("spp", {"X": _randn(rng, 2, 3, 9, 7)},
              {"pyramid_height": 2, "pooling_type": "avg"}, id="spp_avg"),
        _case("unpool", _unpool_inputs(rng),
              {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
               "unpooling_type": "max"}, exact=("Out",)),
        _case("group_norm", {"X": _randn(rng, 2, 6, 4, 5) + 0.5,
                             "Scale": _randn(rng, 6) + 1,
                             "Bias": _randn(rng, 6)},
              {"groups": 3, "epsilon": 1e-5}, ("Y", "Mean", "Variance"),
              ("X", "Scale", "Bias")),
        _case("group_norm", {"X": _randn(rng, 2, 4, 5, 6) + 0.5,
                             "Scale": _randn(rng, 6) + 1,
                             "Bias": _randn(rng, 6)},
              {"groups": 2, "epsilon": 1e-5, "data_layout": "NHWC"},
              ("Y", "Mean", "Variance"), ("X", "Scale", "Bias"),
              id="group_norm_nhwc"),
        _case("norm", {"X": _randn(rng, 3, 5, 4)},
              {"axis": 1, "epsilon": 1e-10}, ("Out", "Norm")),
        _case("bilinear_interp", {"X": _randn(rng, 2, 3, 5, 7)},
              {"out_h": 8, "out_w": 4}),
        _case("nearest_interp", {"X": _randn(rng, 2, 3, 5, 7)},
              {"out_h": 9, "out_w": 13}, exact=("Out",)),
    ]


@pytest.mark.parametrize("op_type,inputs,attrs,outputs,diff,exact",
                         _cases())
def test_op_follows_jax(op_type, inputs, attrs, outputs, diff, exact):
    want_prog, want, want_g = one_op(fluid, op_type, inputs, attrs, outputs,
                                     diff)
    got_prog, got, got_g = one_op(pt, op_type, inputs, attrs, outputs, diff)
    assert got_prog == want_prog
    for slot, g, w in zip(outputs, got, want):
        assert g.shape == w.shape, slot
        if slot in exact:
            assert g.dtype == w.dtype, slot
            np.testing.assert_array_equal(g, w, err_msg=slot)
        else:
            rtol = ADAPTIVE_RTOL if attrs.get("adaptive") else 1e-5
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6,
                                       err_msg=slot)
    for slot, g, w in zip(diff, got_g, want_g):
        w64 = np.asarray(w, np.float64)
        rel = np.linalg.norm(g - w64) / max(np.linalg.norm(w64), 1e-30)
        assert rel <= 1e-4, (slot, rel)


def test_mask_is_the_first_maximum():
    """A window holding its maximum twice points at the first (in the
    window's row-major order), as the JAX reduction's ``bv > av`` keeps;
    the ``Mask`` is int32 offsets into the unpadded plane."""
    x = np.zeros((1, 1, 2, 4), "float32")
    x[0, 0] = [[1, 5, 2, 2], [5, 0, 2, 1]]
    attrs = {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}
    _, (out, mask), _ = one_op(pt, "max_pool2d_with_index", {"X": x}, attrs,
                               ("Out", "Mask"), ("X",))
    assert mask.dtype == np.int32
    np.testing.assert_array_equal(out, [[[[5, 2]]]])
    np.testing.assert_array_equal(mask, [[[[1, 2]]]])


def test_unpool_drops_out_of_range_offsets():
    """Offsets in [-size, 0) count from the end of the plane, any other
    outside it is dropped (XLA's ``mode="drop"``); nothing is written
    twice."""
    x = np.arange(1, 5, dtype="float32").reshape(1, 1, 2, 2)
    idx = np.asarray([-1, 16, -17, 0], "int32").reshape(1, 1, 2, 2)
    attrs = {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}
    _, (out,), _ = one_op(pt, "unpool", {"X": x, "Indices": idx}, attrs,
                          ("Out",), ("X",))
    want = np.zeros(16, "float32")
    want[15], want[0] = 1, 4
    np.testing.assert_array_equal(out.reshape(-1), want)


def _layer_net(pkg):
    """Every new layer once, NCHW: fetches [each layer's output]."""
    L = pkg.layers
    img = L.data("img", shape=[3, 8, 10])
    vol = L.data("vol", shape=[2, 4, 5, 6])
    outs = [L.conv2d_transpose(img, 4, filter_size=3, stride=2, padding=1,
                               act="relu"),
            L.conv2d_transpose(img, 4, output_size=[10, 12], groups=1,
                               bias_attr=False),
            L.conv3d(vol, 3, 3, padding=1, act="relu"),
            L.conv3d_transpose(vol, 2, filter_size=2, stride=2),
            L.pool3d(vol, pool_size=2, pool_type="avg", pool_stride=2),
            L.pool3d(vol, pool_size=3, pool_stride=2, pool_padding=1,
                     ceil_mode=True),
            L.group_norm(img, groups=3, act="relu"),
            L.image_resize(img, out_shape=[5, 13]),
            L.image_resize(img, scale=1.5, resample="NEAREST"),
            L.resize_bilinear(img, out_shape=[12, 4]),
            L.l2_normalize(img, axis=1),
            L.image_resize_short(img, 6)]
    return outs


def test_layers_build_and_run_like_jax():
    rng = np.random.RandomState(4)
    feed = {"img": rng.randn(2, 3, 8, 10).astype("float32"),
            "vol": rng.randn(2, 2, 4, 5, 6).astype("float32")}
    res = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = _layer_net(pkg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        if pkg is fluid:
            exe.run(startup, scope=scope)
            params = params_from_jax_scope(main, scope)
            dicts = (main.to_dict(), startup.to_dict())
        else:
            assert (main.to_dict(), startup.to_dict()) == dicts
            load_numpy_params(scope, params, "cpu")
        res[pkg] = [np.asarray(v) for v in exe.run(main, feed=feed,
                                                   fetch_list=fetch,
                                                   scope=scope)]
    types = [op.type for op in main.global_block().ops]
    for t in ("conv2d_transpose", "conv3d", "conv3d_transpose", "pool3d",
              "group_norm", "bilinear_interp", "nearest_interp"):
        assert t in types, t
    assert res[pt][-1].shape == (2, 3, 6, 8)
    for g, w in zip(res[pt], res[fluid]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
