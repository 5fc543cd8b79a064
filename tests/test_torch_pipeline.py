"""Pipeline schedules (``parallel/pipeline.py``) on the CPU, against the
sequential fold of the stages and the JAX package's schedule tables.

The schedules run in worlds of 2 and 4 gloo ranks (``torch_mesh_world``:
each rank ``python tests/test_torch_pipeline.py --rank R ...``), one stage
(or, under ``interleaved``, two chunks) a rank.  The counterparts of
``tests/test_pipeline.py``'s cases outside ``slow``: gpipe, 1f1b (M above
and below 2S - 1) and interleaved (v = 2) against folding the stages in
order, outputs within 1e-5 and gradients of sum(out^2) within 2e-4; the
1f1b stash counted by the schedule, never above min(M, 2S - 1); bf16
activations over float32 parameters; ``schedule_stats`` equal to the JAX
function over a grid; and the validation errors."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_world import error_of, run_world  # noqa: E402

D, BATCH = 5, 16

# (schedule, stages a world of n holds, microbatches): the stage count is
# n, or 2n under interleaved (two chunks a rank)
RUNS = [("gpipe", 1, 4), ("gpipe", 1, 8), ("1f1b", 1, 8), ("1f1b", 1, 2),
        ("interleaved", 2, 4), ("interleaved", 2, 8)]


def _stage_fn(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _promoting_stage_fn(params, x):
    """The stage with JAX's type promotion (torch's matmul takes one
    dtype): bf16 x over float32 weights computes in float32."""
    w, b = params
    return torch.tanh(x.to(torch.promote_types(x.dtype, w.dtype)) @ w + b)


def _arrays(s_total, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(s_total, D, D).astype("float32") * 0.3,
            rng.randn(s_total, D).astype("float32") * 0.1,
            rng.randn(BATCH, D).astype("float32"))


def _tag(sched, per, m):
    return "%s_v%d_m%d" % (sched, per, m)


# ---------------------------------------------------------------------------
# the ranks' cases
# ---------------------------------------------------------------------------

def case_schedules(inputs, rank, world):
    """Every schedule of ``RUNS``: the output and the gradients of
    sum(out^2) w.r.t. the stacked weights and x, and this rank's counts
    (ticks, transfers, the 1f1b stash's peak)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import pipeline

    pmod = sys.modules["paddle_tpu_torch.parallel.pipeline"]
    mesh = pt.make_mesh((world,), ("pp",))
    out = {}
    for sched, per, m in RUNS:
        w, b, x = _arrays(per * world)
        w, b, x = (torch.tensor(a, requires_grad=True) for a in (w, b, x))
        y = pipeline(_stage_fn, (w, b), x, mesh, microbatches=m,
                     schedule=sched)
        (y ** 2).sum().backward()
        tag = _tag(sched, per, m)
        out[tag] = y.detach().numpy()
        for n, t in (("dw", w), ("db", b), ("dx", x)):
            out["%s_%s" % (tag, n)] = t.grad.numpy()
        runs = pmod.LAST_RUN
        out[tag + "_counts"] = np.array([
            runs["forward"]["ticks"], runs["backward"]["ticks"],
            runs["forward"]["transfers"], runs["backward"]["transfers"],
            runs["backward"]["stash_peak"]])
    return out


def case_mixed(inputs, rank, world):
    """bf16 activations over float32 parameters: the carries run in the
    stage's output dtype (float32)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import pipeline

    w, b, x = _arrays(world, seed=3)
    y = pipeline(_promoting_stage_fn, (torch.tensor(w), torch.tensor(b)),
                 torch.tensor(x).to(torch.bfloat16),
                 pt.make_mesh((world,), ("pp",)), microbatches=4)
    return {"dtype": np.array(str(y.dtype)), "out": y.numpy()}


CASES = {"schedules": case_schedules, "mixed": case_mixed}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    res = run_world(os.path.abspath(__file__), n, sorted(CASES),
                    tmp_path_factory.mktemp("pipe%d" % n))
    for case, ranks in res.items():
        for r in ranks:
            assert not error_of(r), (case, r.get("__trace__"))
    return n, res


def _sequential(w, b, x):
    w, b, x = (torch.tensor(a, requires_grad=True) for a in (w, b, x))
    y = x
    for i in range(w.shape[0]):
        y = _stage_fn((w[i], b[i]), y)
    (y ** 2).sum().backward()
    return y.detach().numpy(), [w.grad.numpy(), b.grad.numpy(),
                                x.grad.numpy()]


@pytest.mark.parametrize("sched,per,m", RUNS,
                         ids=[_tag(*r) for r in RUNS])
def test_schedule_matches_sequential(world, sched, per, m):
    n, res = world
    tag = _tag(sched, per, m)
    ranks = res["schedules"]
    for r in ranks[1:]:
        for k in (tag, tag + "_dw", tag + "_db", tag + "_dx"):
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    want, grads = _sequential(*_arrays(per * n))
    np.testing.assert_allclose(ranks[0][tag], want, atol=1e-5)
    for name, g in zip(("dw", "db", "dx"), grads):
        np.testing.assert_allclose(ranks[0]["%s_%s" % (tag, name)], g,
                                   atol=2e-4, err_msg=name)
    ticks_f, ticks_b, sent_f, sent_b, stash = np.array(
        [r[tag + "_counts"] for r in ranks]).T
    s = n
    if sched == "interleaved":
        assert set(ticks_f) == {per * m + s - 1}
    else:
        assert set(ticks_f) == {m + s - 1}
    # one activation a microbatch crosses each of the S - 1 edges (and
    # under interleaved the wrap edge v - 1 times more), each transfer
    # posted by its sender and its receiver
    edges = (s - 1) * m if sched != "interleaved" else (per * s - 1) * m
    assert sum(sent_f) == 2 * edges
    if sched == "1f1b":
        assert set(ticks_b) == {m + 2 * (s - 1)}
        # the stash never holds more than min(M, 2S - 1) inputs, and the
        # first stage's reaches it
        assert max(stash) == min(m, 2 * s - 1)
        assert sum(sent_b) == 4 * edges
    else:
        assert set(stash) == {0}
        assert sum(sent_b) == 2 * edges


def test_pipeline_bf16_activations_float32_params(world):
    n, res = world
    got = res["mixed"][0]
    assert str(got["dtype"]) == "torch.float32"
    w, b, x = _arrays(n, seed=3)
    want, _ = _sequential(w, b, x)
    np.testing.assert_allclose(got["out"], want, atol=0.05)


def test_schedule_stats_equal_jax():
    from paddle_tpu.parallel.pipeline import schedule_stats as jax_stats

    from paddle_tpu_torch.parallel import SCHEDULES, schedule_stats

    assert SCHEDULES == ("gpipe", "1f1b", "interleaved")
    for sched in SCHEDULES + (None,):
        for s in (1, 2, 4, 8):
            for m in (1, 2, 4, 8, 16, 64):
                for v in (1, 2, 3):
                    assert schedule_stats(sched, s, m, v) == \
                        jax_stats(sched, s, m, v), (sched, s, m, v)
    g = schedule_stats("gpipe", 4, 8)
    assert g["bubble_fraction"] == pytest.approx(3 / 11)
    assert schedule_stats("interleaved", 4, 8, 2)["bubble_fraction"] < \
        g["bubble_fraction"]
    assert schedule_stats("1f1b", 4, 64)["in_flight"] == 7
    with pytest.raises(ValueError, match="unknown"):
        schedule_stats("zigzag", 4, 8)
    with pytest.raises(ValueError, match=">= 1"):
        schedule_stats("gpipe", 0, 8)


def test_stage_dropout_bits_are_the_uint32_hash():
    """A pipeline stage's dropout draws (``ops/random.hash_bits``, int32
    bit patterns whose products wrap) equal the same hash in exact uint32
    arithmetic, are 24 bits, and keep close to 1 - p of a large draw."""
    from paddle_tpu_torch.hash32 import M32, mul32
    from paddle_tpu_torch.ops.random import hash_bits

    seed = torch.tensor([-123456789], dtype=torch.int32)
    got = hash_bits(seed, (4, 3, 1000), "cpu").reshape(-1).long()

    def shr(h, k):
        return h >> k

    h = mul32(torch.arange(12000, dtype=torch.int64), 0x9E3779B1)
    h = h ^ (-123456789 & M32)
    h = h ^ shr(h, 16)
    h = mul32(h, 0x21F0AAAD)
    h = h ^ shr(h, 15)
    h = mul32(h, 0x735A2D97)
    h = h ^ shr(h, 15)
    assert torch.equal(got, h >> 8)
    assert int(got.min()) >= 0 and int(got.max()) < 1 << 24
    keep = hash_bits(seed, (1 << 20,), "cpu") >= int(0.1 * (1 << 24))
    assert abs(float(keep.float().mean()) - 0.9) < 2e-3
    other = hash_bits(seed + 1, (1 << 20,), "cpu") >= int(0.1 * (1 << 24))
    assert abs(float((keep == other).float().mean()) - 0.82) < 3e-3


def test_pipeline_validation_errors():
    """The refusals, raised before any transfer (no world needed)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import pipeline

    mesh = pt.make_mesh((4,), ("pp",))

    def stage(s):
        w, b, _ = _arrays(s)
        return torch.tensor(w[:, :3, :3]), torch.tensor(b[:, :3])

    with pytest.raises(ValueError, match="no axis"):
        pipeline(_stage_fn, stage(8), torch.zeros(4, 3),
                 pt.make_mesh((8,), ("dp",)))
    with pytest.raises(ValueError, match="must divide"):
        pipeline(_stage_fn, stage(4), torch.zeros(10, 3), mesh,
                 microbatches=4)
    with pytest.raises(ValueError, match="multiple"):
        pipeline(_stage_fn, stage(6), torch.zeros(8, 3), mesh,
                 microbatches=4, schedule="interleaved")
    with pytest.raises(ValueError, match="multiple"):
        pipeline(_stage_fn, stage(8), torch.zeros(12, 3), mesh,
                 microbatches=6, schedule="interleaved")
    with pytest.raises(ValueError, match="must equal"):
        pipeline(_stage_fn, stage(8), torch.zeros(8, 3), mesh)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        pipeline(_stage_fn, stage(4), torch.zeros(8, 3), mesh,
                 schedule="zigzag")
    w, b = stage(4)
    with pytest.raises(ValueError, match="disagree"):
        pipeline(_stage_fn, (w, b[:2]), torch.zeros(8, 3), mesh)


if __name__ == "__main__":
    from torch_mesh_world import worker

    worker(CASES)
