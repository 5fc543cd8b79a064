"""The plain versions of the port's two kernels held against the JAX
package's Pallas kernels (interpret mode on the CPU) and their XLA
references.

``paddle_tpu_torch.ops.cuda.flash_attention.reference_attention`` and
``...layer_norm.layer_norm_reference`` are what the port runs for tensors
on the CPU and what the CUDA kernels are compared with on the card, so
they must compute exactly the JAX package's function: masks, the suffix
decode alignment, the fully-masked-row contract and the dropout hash."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import layer_norm as jln

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import layer_norm as ln

TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_flash_attention.py's band


def _qkv(b, h, tq, tk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, tq, d).astype("float32"),
            rng.randn(b, h, tk, d).astype("float32"),
            rng.randn(b, h, tk, d).astype("float32"))


def _both(q, k, v, k_len=None, seed=None, causal=False, rate=0.0):
    """(port plain version, JAX Pallas interpret, JAX reference)."""
    got = fa.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if k_len is None else torch.from_numpy(k_len), seed, causal,
        rate).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             None if k_len is None else jnp.asarray(k_len, jnp.int32),
             None if seed is None else jnp.asarray(seed, jnp.uint32))
    pallas = np.asarray(jfa.flash_attention(*jargs, causal, rate, None,
                                            True))
    ref = np.asarray(jfa.reference_attention(*jargs, causal, rate, None))
    return got, pallas, ref


@pytest.mark.parametrize("tq,tk,causal,k_len", [
    (16, 16, False, None), (16, 16, True, None),
    (24, 40, False, None), (64, 64, True, None),
    (16, 16, False, [16, 7, 1]), (16, 16, True, [16, 7, 1]),
    (24, 40, False, [40, 7, 1]),
])
def test_attention_matches_jax(tq, tk, causal, k_len):
    q, k, v = _qkv(3, 2, tq, tk, 8)
    kl = None if k_len is None else np.asarray(k_len, "int32")
    got, pallas, ref = _both(q, k, v, kl, causal=causal)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_klen_zero_row_is_zero(causal):
    q, k, v = _qkv(2, 2, 8, 8, 4, seed=1)
    kl = np.asarray([8, 0], "int32")
    got, pallas, ref = _both(q, k, v, kl, causal=causal)
    assert np.all(got[1] == 0.0)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("tq", [1, 4])
def test_attention_suffix_decode_matches_jax(tq):
    """Tq < Tk with causal: query i sits at key position klen - Tq + i
    (the KV-cache decode shape), klen per batch row."""
    q, k, v = _qkv(3, 2, tq, 40, 8, seed=2)
    kl = np.asarray([40, 17, tq], "int32")
    got, pallas, ref = _both(q, k, v, kl, causal=True)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("seed", [1234, 0xDEADBEEF])
def test_dropout_keep_mask_is_bitwise_jax(seed):
    bh = np.arange(6, dtype="int32").reshape(6, 1, 1)
    gq = np.arange(16, dtype="int32").reshape(1, 16, 1)
    gk = np.arange(40, dtype="int32").reshape(1, 1, 40)
    want = np.asarray(jfa._keep_mask(jnp.asarray(seed, jnp.uint32),
                                     jnp.asarray(bh), jnp.asarray(gq),
                                     jnp.asarray(gk), 0.1))
    got = fa.keep_mask(seed, torch.from_numpy(bh), torch.from_numpy(gq),
                       torch.from_numpy(gk), 0.1).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    assert 0.8 < got.mean() < 0.98


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_matches_jax(causal):
    q, k, v = _qkv(2, 3, 16, 16, 8, seed=3)
    kl = np.asarray([16, 9], "int32")
    got, pallas, ref = _both(q, k, v, kl, seed=1234, causal=causal,
                             rate=0.1)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n", [0, 13, 64])
@pytest.mark.parametrize("d", [32, 512])
def test_layer_norm_matches_jax(n, d):
    rng = np.random.RandomState(n * 1000 + d)
    x = (rng.randn(n, d) * 3 + 1).astype("float32")
    g = rng.randn(d).astype("float32")
    b = rng.randn(d).astype("float32")
    y, mean, var = ln.layer_norm_reference(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    assert y.shape == (n, d) and mean.shape == (n,) and var.shape == (n,)
    assert mean.dtype == torch.float32 and var.dtype == torch.float32
    want = np.asarray(jln.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), 1e-5, True))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
    if n:
        _, (_, _, mu, rstd) = jln._fwd(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(b), 1e-5, True)
        np.testing.assert_allclose(mean.numpy(), np.asarray(mu)[:, 0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            1.0 / np.sqrt(var.numpy() + 1e-5), np.asarray(rstd)[:, 0],
            rtol=1e-5, atol=1e-5)


def test_layer_norm_bf16_statistics_are_float32():
    x = torch.from_numpy(np.random.RandomState(0).randn(5, 32)
                         .astype("float32")).bfloat16()
    g = torch.ones(32, dtype=torch.bfloat16)
    b = torch.zeros(32, dtype=torch.bfloat16)
    y, mean, var = ln.layer_norm_reference(x, g, b)
    assert y.dtype == torch.bfloat16
    assert mean.dtype == torch.float32 and var.dtype == torch.float32


def test_cpu_entries_take_the_plain_versions_and_count_no_launch():
    """On a CPU tensor the op entries run the plain versions; the kernel
    wrappers refuse it, and no launch is counted."""
    from paddle_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 4, 4, 32))
    out = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, fa.reference_attention(q, k, v, causal=True))
    x = torch.randn(3, 32)
    y = ln.layer_norm(x, torch.ones(32), torch.zeros(32))[0]
    assert torch.equal(y, ln.layer_norm_reference(
        x, torch.ones(32), torch.zeros(32))[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln.layer_norm_fwd(x, torch.ones(32), torch.zeros(32))
    counts = cuda.launch_counts()
    assert counts["flash_attention_fwd"] == 0 and counts["layer_norm_fwd"] == 0
    assert set(counts.values()) == {0}
