"""Ring attention (``parallel/ring_attention.py``) on the CPU, against the
JAX package's ring and the port's single-device attention.

The port's ring runs in worlds of 2 and 4 gloo ranks
(``torch_mesh_world``: each rank ``python tests/test_torch_ring_attention.py
--rank R ...``), the JAX ring (``paddle_tpu.ops.attention._ring_attention``
and ``paddle_tpu.parallel.ring_attention``) in this process on conftest's
virtual devices at the same mesh shapes.  The counterparts of
``tests/test_ring_attention.py``: outputs (causal and not, ragged
``k_len``) within 1e-5 of both, gradients of sum(out * w) within 1e-4 of
JAX autodiff (``jax.vjp``) and of autograd through the plain attention,
the dropout keep-mask read back bit for bit against the single-device
hash (Q = 0 and V = I make the output the mask over the key count), dp x
tp x sp composition, bf16 inputs accumulating in float32, and the axis
refusals."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_world import error_of, run_world  # noqa: E402

B, H, D = 2, 4, 8
SEED = 12345


def _qkv(t, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, t, D).astype("float32") for _ in range(3)]


def _inputs(world):
    t = 4 * world
    q, k, v = _qkv(t)
    w = np.random.RandomState(9).rand(B, H, t, D).astype("float32")
    return {"q": q, "k": k, "v": v, "w": w,
            "klen": np.array([t, t - 3], "int32")}


# ---------------------------------------------------------------------------
# the ranks' cases (no JAX in a rank)
# ---------------------------------------------------------------------------

def _rt(mesh):
    import torch

    from paddle_tpu_torch.parallel import distributed
    from paddle_tpu_torch.parallel.collective import MeshRuntime

    rt = MeshRuntime(mesh, distributed.process_id(), torch.device("cpu"))
    rt.prepare([(a,) for a in mesh.axis_names])
    return rt


def _grads(out, w, leaves):
    import torch

    (out * w).sum().backward()
    res = [t.grad.numpy().copy() for t in leaves]
    for t in leaves:
        t.grad = None
    return res


def case_ring(inputs, rank, world):
    """The functional ``ring_attention`` and the op's ring (with k_len)
    over an sp mesh of the whole world, causal and not: outputs and
    gradients, global on every rank."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.attention import _ring_attention
    from paddle_tpu_torch.parallel import ring_attention

    mesh = pt.make_mesh((world,), ("sp",))
    rt = _rt(mesh)
    qkv = [torch.tensor(inputs[n], requires_grad=True)
           for n in ("q", "k", "v")]
    w = torch.tensor(inputs["w"])
    klen = torch.tensor(inputs["klen"])
    out = {}
    for causal in (False, True):
        tag = "causal" if causal else "full"
        o = ring_attention(*qkv, mesh, causal=causal)
        out["fn_" + tag] = o.detach().numpy()
        for n, g in zip("qkv", _grads(o, w, qkv)):
            out["fn_%s_d%s" % (tag, n)] = g
        o = _ring_attention(rt, "sp", *qkv, klen, None, causal, 0.0, None,
                            None)
        out["op_" + tag] = o.detach().numpy()
        for n, g in zip("qkv", _grads(o, w, qkv)):
            out["op_%s_d%s" % (tag, n)] = g
    return out


def case_mask(inputs, rank, world):
    """The ring's keep-mask read back: Q = 0 weighs every key alike and
    V = I (T == D), so with dropout 0.3 the output is the keep-mask over
    T.  World 4 splits the heads over tp and the sequence over sp (the
    hash takes the head offset); the output gathered whole."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.attention import _ring_attention
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    t = 16
    if world == 4:
        mesh = pt.make_mesh((1, 2, 2), ("dp", "tp", "sp"))
    else:
        mesh = pt.make_mesh((1, 2), ("dp", "sp"))
    rt = _rt(mesh)
    h_local = H // rt.extent(("tp",))
    h0 = rt.index(("tp",)) * h_local
    z = torch.zeros((B, h_local, t, t))
    eye = torch.eye(t).expand(B, h_local, t, t).contiguous()
    seed = fa.seed_tensor(SEED, "cpu")
    rows = (0, h0, H)
    o = _ring_attention(rt, "sp", z, z, eye, None, seed, False, 0.3, None,
                        rows)
    o = rt.all_gather(o.contiguous(), ("tp",), 1)
    return {"kept": (o > 0).numpy(), "scale": o.max().numpy() * t}


def case_tp_dp(inputs, rank, world):
    """dp x tp x sp: ``ring_attention_shard`` on the rank's batch rows,
    heads and time block, dropout 0.3 hashed at the global rows; the
    blocks gathered whole (as ``__graft_entry__``'s dp x tp x sp step
    holds Q/K/V head-sharded over tp)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.parallel import ring_attention_shard

    dims = (1, 2, 2) if world == 4 else (1, 1, 2)
    mesh = pt.make_mesh(dims, ("dp", "tp", "sp"))
    rt = _rt(mesh)
    out = {}
    for rate in (0.0, 0.3):
        blocks = []
        for n in ("q", "k", "v"):
            x = torch.tensor(inputs[n])
            x = rt.slice(rt.slice(rt.slice(x, ("dp",), 0), ("tp",), 1),
                         ("sp",), 2)
            blocks.append(x)
        o = ring_attention_shard(*blocks, rt, "sp", dropout_rate=rate,
                                 seed=fa.seed_tensor(SEED, "cpu"),
                                 batch_axis_name="dp", head_axis_name="tp")
        for ax, dim in (("sp", 2), ("tp", 1), ("dp", 0)):
            o = rt.all_gather(o.contiguous(), (ax,), dim)
        out["rate%g" % rate] = o.numpy()
    return out


def case_bf16(inputs, rank, world):
    """bf16 inputs: scores and statistics accumulate in float32, the
    output comes back bf16."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import ring_attention

    mesh = pt.make_mesh((world,), ("sp",))
    q, k, v = (torch.tensor(inputs[n]).to(torch.bfloat16)
               for n in ("q", "k", "v"))
    o = ring_attention(q, k, v, mesh)
    return {"dtype": np.array(str(o.dtype)), "out": o.float().numpy()}


CASES = {"ring": case_ring, "mask": case_mask, "tp_dp": case_tp_dp,
         "bf16": case_bf16}


# ---------------------------------------------------------------------------
# the parent: the worlds and the JAX references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    inputs = _inputs(n)
    res = run_world(os.path.abspath(__file__), n, sorted(CASES),
                    tmp_path_factory.mktemp("ring%d" % n),
                    {c: inputs for c in CASES})
    for case, ranks in res.items():
        for r in ranks:
            assert not error_of(r), (case, r.get("__trace__"))
    return n, inputs, res


def _jax_ring(inputs, world, causal, k_len, fn):
    """The JAX ring's output and the vjp of sum(out * w) over q, k, v on
    an sp mesh of ``world`` virtual devices (``fn``: the functional
    surface, else the op's ``_ring_attention`` with ``k_len``)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.attention import _ring_attention
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel import ring_attention as jax_ring

    mesh = make_mesh((world,), ("sp",))
    w = jnp.asarray(inputs["w"])
    kl = jnp.asarray(inputs["klen"]) if k_len else None

    def run(q, k, v):
        if fn:
            return jax_ring(q, k, v, mesh, axis="sp", causal=causal)
        return _ring_attention(mesh, q, k, v, kl, None, causal, 0.0, None)

    def both(q, k, v):
        out, vjp = jax.vjp(run, q, k, v)
        return out, vjp(w)

    args = [jnp.asarray(inputs[n]) for n in ("q", "k", "v")]
    out, grads = jax.jit(both)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _plain(inputs, causal, k_len):
    """The port's single-device plain attention and autograd through it."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    qkv = [torch.tensor(inputs[n], requires_grad=True)
           for n in ("q", "k", "v")]
    kl = torch.tensor(inputs["klen"]) if k_len else None
    out = fa.reference_attention(*qkv, kl, None, causal)
    (out * torch.tensor(inputs["w"])).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in qkv]


def _same_on_every_rank(ranks, keys):
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("surface", ["fn", "op"])
def test_ring_matches_jax_and_single_device(world, surface, causal):
    n, inputs, res = world
    ranks = res["ring"]
    tag = "%s_%s" % (surface, "causal" if causal else "full")
    keys = [tag] + [tag + "_d" + x for x in "qkv"]
    _same_on_every_rank(ranks, keys)
    got = ranks[0]
    k_len = surface == "op"
    want, wgrads = _jax_ring(inputs, n, causal, k_len, surface == "fn")
    plain, pgrads = _plain(inputs, causal, k_len)
    np.testing.assert_allclose(got[tag], want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[tag], plain, atol=1e-5, rtol=1e-5)
    for x, wg, pg in zip("qkv", wgrads, pgrads):
        np.testing.assert_allclose(got[tag + "_d" + x], wg, atol=1e-4,
                                   rtol=1e-4, err_msg=x)
        np.testing.assert_allclose(got[tag + "_d" + x], pg, atol=1e-4,
                                   rtol=1e-4, err_msg=x)


def test_ring_dropout_keep_mask_is_the_single_device_hash(world):
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    n, _, res = world
    got = res["mask"][0]
    t = 16
    gq = torch.arange(t)[:, None]
    gk = torch.arange(t)[None, :]
    bh = torch.arange(B * H).reshape(B, H, 1, 1)
    want = fa.keep_mask(fa.seed_tensor(SEED, "cpu"), bh, gq, gk, 0.3)
    np.testing.assert_array_equal(got["kept"], want.numpy())
    assert 0.6 < want.float().mean() < 0.8
    # a kept weight is 1/T, unscaled (downgrade_in_infer)
    np.testing.assert_allclose(float(got["scale"]), 1.0, rtol=1e-6)


def test_ring_composes_with_dp_and_tp(world):
    """dp x tp x sp against the JAX ring at the same mesh shape (heads
    over tp, dropout hashed at the global heads) and the single-device
    plain attention with the same seed."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops.attention import _ring_attention
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    n, inputs, res = world
    dims = (1, 2, 2) if n == 4 else (1, 1, 2)
    got = res["tp_dp"][0]
    mesh = make_mesh(dims, ("dp", "tp", "sp"))
    args = [jnp.asarray(inputs[x]) for x in ("q", "k", "v")]
    for rate in (0.0, 0.3):
        seed = jnp.asarray(SEED, jnp.uint32) if rate else None
        want = np.asarray(_ring_attention(mesh, *args, None, seed, False,
                                          rate, None))
        plain = fa.reference_attention(
            *(torch.tensor(inputs[x]) for x in ("q", "k", "v")), None,
            fa.seed_tensor(SEED, "cpu"), False, rate).numpy()
        np.testing.assert_allclose(got["rate%g" % rate], want, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got["rate%g" % rate], plain, atol=1e-5,
                                   rtol=1e-5)


def test_ring_bf16_accumulates_in_float32(world):
    n, inputs, res = world
    got = res["bf16"][0]
    assert str(got["dtype"]) == "torch.bfloat16"
    plain, _ = _plain(inputs, False, False)
    np.testing.assert_allclose(got["out"], plain, atol=0.05)


def test_ring_attention_rejects_unknown_axis():
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import ring_attention

    z = torch.zeros((1, 1, 8, 4))
    with pytest.raises(ValueError, match="no axis"):
        ring_attention(z, z, z, pt.make_mesh((2,), ("dp",)), axis="sp")
    with pytest.raises(ValueError, match="must differ"):
        ring_attention(z, z, z, pt.make_mesh((2,), ("sp",)), axis="sp",
                       batch_axis="sp")


if __name__ == "__main__":
    from torch_mesh_world import worker

    worker(CASES)
