"""Host-side logic of the Transformer-training backward kernels #2
(``ops/cuda/flash_attention.py``) and #4 (``ops/cuda/layer_norm.py``):
the dQ scratch planner and the key-tile decomposition it stands for, the
layer-norm row-grid planner and its two-pass column sums, and the
wrappers' refusals.  The kernels themselves run only on the card
(``chip_smoke.py``); here their plain versions carry the arithmetic, and
the JAX package's kernels are the reference (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import cuda
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import layer_norm as ln


def _attention_inputs(b, h, tq, tk, seed):
    rng = np.random.RandomState(seed)
    q, dout = (rng.randn(b, h, tq, 64).astype("float32") for _ in range(2))
    k, v = (rng.randn(b, h, tk, 64).astype("float32") for _ in range(2))
    klen = rng.randint(0, tk + 1, b).astype("int32")
    return q, k, v, dout, klen


@pytest.mark.parametrize("tq,tk", [(64, 64), (1, 64), (5, 40), (200, 200),
                                   (70, 300), (64, 65)])
def test_dq_partials_cover_each_query_key_tile_pair_once(tq, tk):
    """Kernel #2 writes dQ directly when one 64-key tile covers Tk, else
    one float32 [Tq, 64] part per (b*h, key tile), added in key-tile
    order: the key tiles partition the keys, and the parts add up to the
    plain dQ, which matches the JAX kernels' (interpret mode)."""
    b, h = 2, 3
    shape = fa._dq_partials(b, h, tq, tk)
    nkt = -(-tk // fa._BWD_TILE)
    if tk <= fa._BWD_TILE:
        assert shape is None
        return
    assert shape == (b * h, nkt, tq, 64)
    tiles = [range(kt * fa._BWD_TILE, min((kt + 1) * fa._BWD_TILE, tk))
             for kt in range(nkt)]
    assert sorted(i for t in tiles for i in t) == list(range(tk))
    assert all(len(t) > 0 for t in tiles)

    causal = tq <= tk
    q, k, v, dout, klen = _attention_inputs(b, h, tq, tk, tq + tk)
    tq_, tk_, tv_, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    kl = torch.from_numpy(klen)
    out, lse = fa.reference_attention_lse(tq_, tk_, tv_, kl, None, causal)
    dq_ref, _, _ = fa.attention_bwd_reference(
        tq_, tk_, tv_, kl, None, causal, 0.0, None, out, lse, tdo)
    # the key tiles' parts, as the kernel forms them: dS of the tile's
    # keys times the tile's K, added in tile order and scaled at the end
    valid, _ = fa._masks(tq_, tk_, kl, None, causal, 0.0)
    s = torch.einsum("bhqd,bhkd->bhqk", tq_ * torch.tensor(0.125), tk_)
    p = torch.where(valid, torch.exp(torch.where(valid, s, fa._NEG_INF)
                                     - lse[..., None]), 0.0)
    g = torch.einsum("bhqd,bhkd->bhqk", tdo, tv_)
    ds = p * (g - (tdo * out).sum(dim=-1, keepdim=True))
    part = torch.empty(shape)
    for kt, keys in enumerate(tiles):
        part[:, kt] = torch.einsum(
            "bhqk,bhkd->bhqd", ds[..., keys.start:keys.stop],
            tk_[:, :, keys.start:keys.stop]).reshape(b * h, tq, 64)
    total = torch.zeros(b * h, tq, 64)
    for kt in range(nkt):
        total = total + part[:, kt]
    np.testing.assert_allclose(
        (total * 0.125).reshape(b, h, tq, 64).numpy(), dq_ref.numpy(),
        rtol=1e-5, atol=1e-5)

    def loss(qq):
        return jnp.sum(jfa.flash_attention(qq, k, v, klen, None, causal, 0.0,
                                           None, True) * dout)
    np.testing.assert_allclose(dq_ref.numpy(), np.asarray(jax.grad(loss)(q)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n", [1, 5, 1000, 16384])
@pytest.mark.parametrize("resident", [1, 132, 264])
def test_layer_norm_row_blocks_cover_every_row_once(n, resident):
    """Kernel #4's row pass: ``_row_blocks`` blocks of ``_BWD_WARPS``
    warps, warp w of block b taking rows b * W + w, then every (W *
    blocks)-th: every row exactly once, no more blocks than the card
    holds at once, and no block without a row."""
    blocks = ln._row_blocks(n, resident)
    w = ln._BWD_WARPS
    assert 1 <= blocks <= resident
    assert (blocks - 1) * w < n
    seen = np.zeros(n, int)
    for blk in range(blocks):
        for warp in range(w):
            seen[np.arange(blk * w + warp, n, blocks * w)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n,d", [(5, 7), (1000, 96), (300, 512)])
def test_layer_norm_two_pass_column_sums(n, d):
    """dgamma and dbeta as the kernel forms them: per-block partials over
    its warps' rows, then the column pass's 32 slices of partial rows,
    each in a fixed order, agree with the plain version and the JAX
    kernel's backward (interpret mode)."""
    from paddle_tpu.ops.pallas import layer_norm as jln

    rng = np.random.RandomState(n + d)
    x = (rng.randn(n, d) * 3 + 1).astype("float32")
    gamma, beta = (rng.randn(d).astype("float32") for _ in range(2))
    dy = rng.randn(n, d).astype("float32")
    xt, gt, dyt = (torch.from_numpy(a) for a in (x, gamma, dy))
    _, mean, var = ln.layer_norm_reference(xt, gt, torch.from_numpy(beta))
    rstd = torch.rsqrt(var + 1e-5)
    dx, dg, db = ln.layer_norm_bwd_reference(xt, gt, mean, rstd, dyt)
    xhat = (xt - mean[:, None]) * rstd[:, None]
    blocks, w = ln._row_blocks(n, 7), ln._BWD_WARPS

    def block_partials(terms):
        # a block's warps' rows, each warp's in order, warps in order
        return torch.stack([
            sum((terms[i] for wi in range(w)
                 for i in range(blk * w + wi, n, blocks * w)),
                torch.zeros(d)) for blk in range(blocks)])

    def columns(part, slices=32):
        return sum((part[sl::slices].sum(0) for sl in range(slices)),
                   torch.zeros(d))

    got_g = columns(block_partials(dyt * xhat))
    got_b = columns(block_partials(dyt))
    np.testing.assert_allclose(got_g.numpy(), dg.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), db.numpy(), rtol=1e-4,
                               atol=1e-4)
    _, pull = jax.vjp(lambda a, c, e: jln.layer_norm(a, c, e, 1e-5, True),
                      jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    for mine, want in zip((dx, dg, db), pull(jnp.asarray(dy))):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def _att(b=1, h=1, tq=4, tk=4, d=64, dtype=torch.float32):
    return (torch.zeros(b, h, tq, d, dtype=dtype),
            torch.zeros(b, h, tk, d, dtype=dtype))


@pytest.mark.parametrize("case,match", [
    ("head_dim", "head dim 32"),
    ("dout_shape", "dout must be"),
    ("lse_shape", "lse must be"),
    ("causal", "causal needs Tq <= Tk"),
    ("k_len", "k_len has 3 entries"),
    ("dtype", "float32 or bfloat16"),
    ("cpu", "CUDA tensors"),
])
def test_flash_attention_bwd_refuses(case, match):
    """Kernel #2's wrapper raises on what the kernel does not take, with
    the shapes in the message, before it builds or launches anything; a
    well-formed call on CPU tensors is refused too."""
    cuda.reset_launch_counts()
    q, k = _att()
    lse = torch.zeros(1, 1, 4)
    kl, causal, dout = None, False, q
    if case == "head_dim":
        q, k = _att(d=32)
        dout = q
    elif case == "dout_shape":
        dout = torch.zeros(1, 1, 5, 64)
    elif case == "lse_shape":
        lse = torch.zeros(1, 4)
    elif case == "causal":
        q, k = _att(tq=8, tk=4)
        dout, lse, causal = q, torch.zeros(1, 1, 8), True
    elif case == "k_len":
        kl = torch.ones(3, dtype=torch.int32)
    elif case == "dtype":
        q, k = _att(dtype=torch.float16)
        dout = q
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd(q, k, k, kl, None, causal, 0.0, None, q, lse,
                               dout)
    assert set(cuda.launch_counts().values()) == {0}


@pytest.mark.parametrize("case,match", [
    ("wide", "row width 2048"),
    ("dy_shape", "dy must be"),
    ("rstd_dtype", "rstd must be"),
    ("dtype", "float32 or bfloat16"),
    ("cpu", "CUDA tensors"),
])
def test_layer_norm_bwd_refuses(case, match):
    """Kernel #4's wrapper raises on what the kernel does not take, with
    the shapes in the message; a well-formed call on CPU tensors is
    refused too, and nothing counts a launch."""
    cuda.reset_launch_counts()
    n, d = 3, 8
    if case == "wide":
        d = 2048
    x, dy = torch.zeros(n, d), torch.zeros(n, d)
    gamma, mean, rstd = torch.ones(d), torch.zeros(n), torch.ones(n)
    if case == "dy_shape":
        dy = torch.zeros(n, d + 1)
    elif case == "rstd_dtype":
        rstd = rstd.double()
    elif case == "dtype":
        x = x.half()
    with pytest.raises(ValueError, match=match):
        ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
    assert set(cuda.launch_counts().values()) == {0}
