"""The slice's two programs on the CPU against the JAX package, at a small
size: the Paddle book's label_semantic_roles (``chip_smoke.build_srl``:
the db_lstm over eight features, ``linear_chain_crf``, ``crf_decoding``
pruned to an inference program and a ``ChunkEvaluator`` program) and the
SSD head (``chip_smoke.build_ssd``: ``multi_box_head``, ``ssd_loss`` and a
Momentum step; ``box_coder`` decoding, ``multiclass_nms`` and
``DetectionMAP``), the programs the card runs at full width.

Both build the JAX builder's programs; from the JAX startup state the
SRL miniature's 10 SGD steps give JAX's losses within rtol 1e-4 and its
decoded paths exactly, the chunk counts equal JAX's and a numpy count of
the same paths; the SSD head's loss and gradients after each of 3 steps
are JAX's within rtol 1e-4 / relative L2 1e-4, its NMS output and mAP
JAX's.  Neither program reads a value on the host in any op."""

import numpy as np
import torch

import paddle_tpu as fluid

import chip_smoke as cs
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.crf import chunk_counts

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_plain_ops import _same_values, rel_l2
from test_torch_rnn import started_scopes
from test_torch_serving import fresh_torch_programs  # noqa: F401

SRL_SMALL = dict(word_dict=30, pred_dict=10, mark_dict=2, word_dim=8,
                 mark_dim=4, hidden=32, depth=4, labels=7)
SRL_FEED = dict(batch=6, max_len=7, min_len=1)
SSD_SMALL = dict(maps=((8, 8), (8, 4), (8, 2)), image_size=64,
                 num_classes=4, base_size=64, min_ratio=20, max_ratio=90,
                 aspect_ratios=((2.0,), (2.0, 3.0), (2.0,)), max_gt=4)


def _srl_programs(lr=0.1):
    return {pkg: cs.build_srl(pkg, lr=lr, **SRL_SMALL)
            for pkg in (fluid, pt)}


def _srl_feeds(n, seed=0):
    return cs.srl_feeds(n, **SRL_FEED, **SRL_SMALL, seed=seed)


def test_srl_programs_are_the_jax_builders():
    progs = _srl_programs()
    for i in range(4):
        assert progs[pt][i].to_dict() == progs[fluid][i].to_dict(), i


def test_srl_trains_decodes_and_scores_like_jax():
    """10 SGD steps over two alternating batches from the JAX startup
    state: losses within rtol 1e-4 step by step, falling; then the pruned
    decoding program's paths equal JAX's, and the ChunkEvaluator over 3
    batches counts what JAX counts and what a numpy walk of the paths
    counts."""
    progs = _srl_programs()
    scopes = started_scopes({pkg: (p[0], p[1], None)
                             for pkg, p in progs.items()})
    feeds = _srl_feeds(2) * 5
    losses, paths, counts = {}, {}, {}
    for pkg in (fluid, pt):
        main, _, infer, evaluate, v = progs[pkg]
        exe, scope = pkg.Executor(pkg.CPUPlace()), scopes[pkg]
        losses[pkg] = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[v["cost"]], scope=scope)[0]).ravel()[0])
            for f in feeds]
        evals = _srl_feeds(3, seed=1)
        paths[pkg] = [np.asarray(exe.run(
            infer, feed=cs.srl_infer_feed(f), fetch_list=[v["path"].name],
            scope=scope)[0]) for f in evals]
        with pkg.scope_guard(scope):
            v["evaluator"].reset(exe)
            for f in evals:
                exe.run(evaluate, feed=f, fetch_list=[v["path"].name])
            states = v["evaluator"]._fetch_states(exe)
            prf = v["evaluator"].eval(exe)
        counts[pkg] = ([int(np.asarray(s).ravel()[0]) for s in states], prf)
    np.testing.assert_allclose(losses[pt], losses[fluid], rtol=1e-4)
    assert losses[pt][-2] < losses[pt][0]      # the same batch
    for g, w in zip(paths[pt], paths[fluid]):
        assert _same_values(g, w)
    assert counts[pt][0] == counts[fluid][0]
    evals = _srl_feeds(3, seed=1)
    want = np.sum([cs.numpy_chunk_counts(p, f["target"], f["word@LEN"],
                                         (SRL_SMALL["labels"] - 1) // 2)
                   for p, f in zip(paths[pt], evals)], axis=0)
    assert counts[pt][0] == list(want) and want[2] > 0
    for g, w in zip(counts[pt][1], counts[fluid][1]):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_numpy_chunk_count_is_chunk_eval():
    """``chip_smoke.numpy_chunk_counts`` (the card phase's witness) counts
    IOB chunks as the port's ``chunk_eval`` does, on random tags."""
    rng = np.random.RandomState(8)
    for _ in range(5):
        inf = rng.randint(0, 9, (6, 11))
        lab = np.where(rng.rand(6, 11) < 0.5, inf, rng.randint(0, 9,
                                                               (6, 11)))
        lens = rng.randint(0, 12, 6)
        got = [int(x) for x in chunk_counts(
            torch.from_numpy(inf), torch.from_numpy(lab),
            torch.from_numpy(lens), 4, "IOB")]
        assert got == list(cs.numpy_chunk_counts(inf, lab, lens, 4))


def test_srl_programs_read_nothing_on_the_host(host_read_guard):
    main, startup, infer, evaluate, v = cs.build_srl(pt, **SRL_SMALL)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    (f,) = _srl_feeds(1)
    exe.run(main, feed=f, fetch_list=[v["cost"]], scope=scope)
    exe.run(infer, feed=cs.srl_infer_feed(f), fetch_list=[v["path"]],
            scope=scope)
    with pt.scope_guard(scope):
        v["evaluator"].reset(exe)
        exe.run(evaluate, feed=f, fetch_list=[v["path"].name])
    assert not host_read_guard, host_read_guard


# ---------------------------------------------------------------------------
# the SSD head at 64 px
# ---------------------------------------------------------------------------

def _ssd_programs():
    return {pkg: cs.build_ssd(pkg, **SSD_SMALL) for pkg in (fluid, pt)}


def _ssd_feeds(n, batch=3, seed=0):
    return cs.ssd_feeds(n, batch, **SSD_SMALL, seed=seed)


def test_ssd_programs_are_the_jax_builders():
    progs = _ssd_programs()
    for i in range(3):
        assert progs[pt][i].to_dict() == progs[fluid][i].to_dict(), i
    _, _, box, _ = progs[pt][3]["head"]
    assert box.shape[0] == 8 * 8 * 4 + 4 * 4 * 6 + 2 * 2 * 4


def test_ssd_loss_gradients_nms_and_map_follow_jax():
    """3 Momentum steps of the SSD head from the JAX startup state: the
    loss within rtol 1e-4 and every conv parameter's gradient within
    relative L2 1e-4 at each step; then the inference program's NMS rows
    and counts equal JAX's (classes and boxes exactly, scores within rtol
    1e-5) and so does the batch mAP."""
    progs = _ssd_programs()
    scopes = started_scopes({pkg: (p[0], p[1], None)
                             for pkg, p in progs.items()})
    params = sorted(p.name for p in progs[pt][0].all_parameters())
    feeds = _ssd_feeds(3)
    got = {}
    for pkg in (fluid, pt):
        main, _, infer, v = progs[pkg]
        exe, scope = pkg.Executor(pkg.CPUPlace()), scopes[pkg]
        fetch = [v["loss"].name] + [n + "@GRAD" for n in params]
        steps = [[np.asarray(a) for a in exe.run(
            main, feed=f, fetch_list=fetch, scope=scope)] for f in feeds]
        out = [np.asarray(a) for a in exe.run(
            infer, feed=_ssd_feeds(1, seed=4)[0],
            fetch_list=[v["nms"].name, v["nms"]._seq_len_name,
                        v["map"].name], scope=scope)]
        got[pkg] = (steps, out)
    for g_step, w_step in zip(got[pt][0], got[fluid][0]):
        np.testing.assert_allclose(g_step[0], w_step[0], rtol=1e-4)
        for n, g, w in zip(params, g_step[1:], w_step[1:]):
            assert rel_l2(g, w) <= 1e-4, (n, rel_l2(g, w))
    (nms, count, m), (w_nms, w_count, w_m) = got[pt][1], got[fluid][1]
    assert _same_values(count, w_count) and count.sum() > 0
    np.testing.assert_array_equal(nms[..., 0], w_nms[..., 0])
    np.testing.assert_allclose(nms[..., 1], w_nms[..., 1], rtol=1e-5)
    np.testing.assert_allclose(nms[..., 2:], w_nms[..., 2:], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(m, w_m, rtol=1e-5)


def test_ssd_programs_read_nothing_on_the_host(host_read_guard):
    main, startup, infer, v = cs.build_ssd(pt, **SSD_SMALL)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    (f,) = _ssd_feeds(1)
    exe.run(main, feed=f, fetch_list=[v["loss"]], scope=scope)
    exe.run(infer, feed=f, fetch_list=[v["nms"], v["map"]], scope=scope)
    # the priors' sizes and variances: device constants made once
    assert set(host_read_guard) <= {("prior_box", "torch.from_numpy")}, \
        host_read_guard
