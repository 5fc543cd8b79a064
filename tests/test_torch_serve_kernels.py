"""Host-side logic of the serving kernels #1 (``ops/cuda/flash_attention.py``,
the forward) and #7 (``ops/cuda/quant_matmul.py``): #1's decode key split
and the rank-order combine it stands for, #7's K split and the arithmetic
of its tensor-core products (int8 weights exact in TF32 and bfloat16, two
TF32 passes of a float32 activation), and the wrappers' refusals.  The
kernels themselves run only on the card (``chip_smoke.py``); here their
plain versions carry the arithmetic, and the JAX package's kernel is the
reference (interpret mode)."""

import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import cuda
from paddle_tpu_torch.ops.cuda import conv_bn as cb
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import quant_matmul as qm

ATOL, RTOL = 1e-4, 1e-4   # chip_smoke.py's TOL[torch.float32]
DECODE_KLEN = [0, 1, 2, 65, 1024]


@pytest.mark.parametrize("cluster", [1, 2, 8])
@pytest.mark.parametrize("klen", DECODE_KLEN)
def test_decode_key_slices_cover_each_key_once(klen, cluster):
    """Kernel #1's decode split: the ranks' slices, in rank order, are
    whole 64-key tiles but the last, cover every key below ``klen``
    exactly once and none past it; the serving decode shape takes 8
    ranks."""
    assert fa._split_cluster(8, 8, 1, 1024) == 8
    slices = fa._key_slices(klen, cluster)
    assert len(slices) == cluster
    seen = np.zeros(1024, int)
    for start, end in slices:
        assert 0 <= start <= end <= klen
        assert start % 64 == 0 or start == end
        seen[start:end] += 1
    assert (seen[:klen] == 1).all() and (seen[klen:] == 0).all()
    # slices run in key order: rank r's keys precede rank r + 1's
    ends = [e for s, e in slices if e > s]
    assert ends == sorted(ends)


def _combine(parts):
    """The kernel's rank-order combine of per-slice (O, LSE), each taken
    as the partial (m = LSE, l = 1, unnormalised O = O); an empty slice
    (LSE = +1e30) is the kernel's (-1e30, 0, 0)."""
    ms, ls, os = [], [], []
    for o, lse in parts:
        empty = lse >= 1e30
        ms.append(torch.where(empty, torch.tensor(-1e30), lse))
        ls.append(torch.where(empty, 0.0, 1.0))
        os.append(torch.where(empty[..., None], 0.0, o))
    m = ms[0]
    for x in ms[1:]:
        m = torch.maximum(m, x)
    big_l, big_o = torch.zeros_like(m), torch.zeros_like(os[0])
    for mr, lr, orr in zip(ms, ls, os):
        w = torch.exp(mr - m)
        big_l = big_l + lr * w
        big_o = big_o + orr * w[..., None]
    valid = big_l > 0
    out = big_o / torch.where(valid, big_l, 1.0)[..., None]
    lse = torch.where(valid, m + torch.log(big_l.clamp_min(1e-37)), 1e30)
    return out, lse


@pytest.mark.parametrize("cluster", [2, 8])
def test_rank_order_combine_equals_the_whole(cluster):
    """A decode step (one query over a 1024-key cache, suffix-causal)
    split as kernel #1 splits it: the plain version over each rank's
    slice, combined in rank order, equals the plain version over all the
    keys, and the JAX kernel (interpret mode), within the card's float32
    band; rows with no key (klen 0) give zeros and +1e30."""
    rng = np.random.RandomState(cluster)
    b, h, tk = len(DECODE_KLEN), 2, 1024
    q = rng.randn(b, h, 1, 64).astype("float32")
    k, v = (rng.randn(b, h, tk, 64).astype("float32") for _ in range(2))
    klen = np.asarray(DECODE_KLEN, "int32")
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    whole, whole_lse = fa.reference_attention_lse(
        tq_, tk_, tv_, torch.from_numpy(klen), None, True)
    parts = []
    for r in range(cluster):
        # each row's own slice: the kernel cuts [0, klen) per (b, h)
        o_r, lse_r = torch.zeros(b, h, 1, 64), torch.zeros(b, h, 1)
        for i, kl in enumerate(klen):
            start, end = fa._key_slices(int(kl), cluster)[r]
            n = max(end - start, 1)
            o, lse = fa.reference_attention_lse(
                tq_[i:i + 1], tk_[i:i + 1, :, start:start + n],
                tv_[i:i + 1, :, start:start + n],
                torch.tensor([end - start]), None, False)
            o_r[i], lse_r[i] = o[0], lse[0]
        parts.append((o_r, lse_r))
    got, got_lse = _combine(parts)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    ok = whole_lse < 1e30
    np.testing.assert_allclose(got_lse[ok].numpy(), whole_lse[ok].numpy(),
                               rtol=1e-5, atol=1e-5)
    jax_out = np.asarray(jfa.flash_attention(q, k, v, klen, None, True, 0.0,
                                             None, True))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=RTOL, atol=ATOL)
    assert (got[0] == 0).all() and (got_lse[0] == 1e30).all()
    assert torch.isfinite(got_lse[1:]).all()


def _tile_split_emulation(q, k, v, klen, causal, cluster, seed, rate):
    """Kernel #1 with its keys split for Tq > 1, emulated: each 64-query
    tile's keys up to the last one its rows can see (causal top- or
    suffix-aligned) cut into the ranks' slices; each rank's partial
    (m, l counting dropped keys, unnormalised O after dropout) of the
    tile's rows; the partials combined in rank order as ``combine``
    does.  Returns (O, LSE) float32, zeros and +1e30 on rows with no
    key."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q * (1.0 / d ** 0.5), k)
    valid, keep = fa._masks(q, k, torch.from_numpy(klen), seed, causal, rate)
    out, lse = torch.zeros(b, h, tq, d), torch.zeros(b, h, tq)
    for i, kl in enumerate(np.minimum(klen, tk)):
        for q0 in range(0, tq, 64):
            rows = slice(q0, min(q0 + 64, tq))
            kend = int(kl)
            if causal:
                last_q = rows.stop - 1
                kend = min(kend, (last_q if tq == tk
                                  else last_q + int(kl) - tq) + 1)
            ms, ls, os = [], [], []
            for start, end in fa._key_slices(kend, cluster):
                cols = slice(start, end)
                vm = valid[i, :, rows, cols]
                sv = torch.where(vm, s[i, :, rows, cols], -1e30)
                m = (sv.amax(-1) if end > start
                     else torch.full(sv.shape[:-1], -1e30))
                p = torch.where(vm, torch.exp(sv - m[..., None]), 0.0)
                ls.append(p.sum(-1))
                if keep is not None:
                    p = torch.where(keep[i, :, rows, cols], p, 0.0)
                ms.append(m)
                os.append(p @ v[i, :, cols])
            big_m = torch.stack(ms).amax(0)
            big_l = sum(lr * torch.exp(mr - big_m) for mr, lr in zip(ms, ls))
            big_o = sum(o_r * torch.exp(mr - big_m)[..., None]
                        for mr, o_r in zip(ms, os))
            ok = big_l > 0
            out[i, :, rows] = big_o / torch.where(ok, big_l, 1.0)[..., None]
            lse[i, :, rows] = torch.where(
                ok, big_m + torch.log(big_l.clamp_min(1e-37)), 1e30)
    return out, lse


@pytest.mark.parametrize("b,tq,tk,klen,cluster,rate", [
    # the 128 prefill bucket of 8 slots (prefill-style klen with 0 and 1)
    (8, 128, 128, [128, 100, 65, 64, 1, 0, 127, 33], 2, 0.0),
    # the suffix (Tq < Tk) alignment, with dropout
    (8, 70, 300, [300, 150, 70, 71, 299, 100, 3, 250], 4, 0.1),
    # the B = 1 causal score program over a served sequence
    (1, 732, 732, [732], 4, 0.0)])
def test_query_tile_split_equals_the_whole(b, tq, tk, klen, cluster, rate):
    """Kernel #1 splits a query tile's keys over a cluster at the main
    path's small-grid shapes (the 8-head planner says so); the rank-order
    combine of the tiles' 64-row partials equals the plain version over
    all the keys, and the JAX kernel (interpret mode), within the card's
    float32 band; rows with no key give zeros and +1e30."""
    assert fa._split_cluster(b, 8, tq, tk) == cluster
    rng = np.random.RandomState(tq + tk)
    q = rng.randn(b, 2, tq, 64).astype("float32")
    k, v = (rng.randn(b, 2, tk, 64).astype("float32") for _ in range(2))
    klen = np.asarray(klen, "int32")
    seed = 99 if rate else None
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    got, got_lse = _tile_split_emulation(tq_, tk_, tv_, klen, True,
                                         cluster, seed, rate)
    whole, whole_lse = fa.reference_attention_lse(
        tq_, tk_, tv_, torch.from_numpy(klen), seed, True, rate)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got_lse >= 1e30, whole_lse >= 1e30)
    ok = whole_lse < 1e30
    np.testing.assert_allclose(got_lse[ok].numpy(), whole_lse[ok].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (got[~ok] == 0).all()
    jax_out = np.asarray(jfa.flash_attention(
        q, k, v, klen, None if seed is None else np.uint32(seed), True,
        rate, None, True))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=RTOL, atol=ATOL)


def test_int8_values_are_exact_in_tf32_and_bfloat16():
    """Every int8 weight value -127..127 survives TF32 rounding (as
    ``cvt.rna.tf32.f32`` rounds) and bfloat16 unchanged: kernel #7 takes
    the weight into its products without a lo part."""
    w = torch.arange(-127, 128, dtype=torch.float32)
    assert torch.equal(cb.tf32_round(w), w)
    assert torch.equal(w.to(torch.bfloat16).float(), w)
    assert torch.equal(w.to(torch.float16).float(), w)


def _tf32_trunc(v):
    """float32 ``v`` cut to TF32's 10 mantissa bits (the low 13 cleared):
    the hi part kernel #7 takes, and what the tensor core reads of a
    .tf32 operand."""
    return (v.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _two_pass(x, qw, scale, passes):
    """x @ qw * scale as kernel #7 takes a float32 x on the tensor cores:
    hi = x truncated to TF32, lo = x - hi (of which the tensor core reads
    TF32's bits), x_lo qw + x_hi qw (small terms first), or x_hi qw
    alone."""
    qwf = qw.float()
    x_hi = _tf32_trunc(x)
    acc = x_hi @ qwf
    if passes == 2:
        acc = _tf32_trunc(x - x_hi) @ qwf + acc
    return acc * scale


@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (5, 130, 200)])
def test_two_tf32_passes_hold_the_float32_band(m, k, n):
    """Two TF32 passes of x against an int8 weight stay within the card's
    float32 band of the float64 product; one pass does not."""
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randn(m, k).astype("float32"))
    w = rng.randn(k, n) * 0.05
    scale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
    qw = torch.from_numpy(np.clip(np.round(w / scale), -127, 127)
                          .astype("int8"))
    scale = torch.from_numpy(scale.astype("float32"))
    want = (x.double() @ qw.double()) * scale.double()

    def within(got):
        return bool(((got.double() - want).abs()
                     <= ATOL + RTOL * want.abs()).all())
    assert within(_two_pass(x, qw, scale, 2))
    assert not within(_two_pass(x, qw, scale, 1))
    # and the plain version holds the same band
    assert within(qm.dequant_matmul_reference(x, qw, scale))


@pytest.mark.parametrize("m,k,n", [
    (8, 512, 32000), (8, 512, 512), (8, 512, 2048), (8, 2048, 512),
    (5, 130, 200), (8, 40, 512), (8, 520, 512), (32, 4096, 512),
    (16, 20000, 100), (4096, 512, 32000)])
def test_dequant_k_splits_cover_k_once(m, k, n):
    """Kernel #7's K split: the decode kernel's ranks take rows [r
    kchunk, (r + 1) kchunk) of the weight, clipped to K, in whole 64-row
    stages; together every row exactly once.  More than 32 rows, or an x
    slice past the decode kernel's 64 KB, go to the prefill kernel, which
    takes K whole.  The serving decode projections split 8 ways."""
    gemv, splits, kchunk = qm._k_splits(m, n, k)
    assert 1 <= splits <= 8
    if not gemv:
        assert splits == 1 and (m > 32 or k * 4 * 8 > 65536)
        return
    bm = 8 if m <= 8 else 16 if m <= 16 else 32
    assert kchunk % 64 == 0 and kchunk * bm * 4 <= 65536
    seen = np.zeros(k, int)
    for r in range(splits):
        seen[min(r * kchunk, k):min((r + 1) * kchunk, k)] += 1
    assert (seen == 1).all()
    if (m, k, n) in ((8, 512, 512), (8, 512, 2048), (8, 2048, 512)):
        assert splits == 8


def _qkv(b=1, h=1, tq=4, tk=4, d=64, dtype=torch.float32):
    return (torch.zeros(b, h, tq, d, dtype=dtype),
            torch.zeros(b, h, tk, d, dtype=dtype))


@pytest.mark.parametrize("case,match", [
    ("rank", "expects \\[B,H,T,D\\]"),
    ("kv_shape", "k/v must be"),
    ("causal", "causal needs Tq <= Tk"),
    ("dtype", "float32 or bfloat16"),
    ("k_len", "k_len has 3 entries"),
    ("cpu", "CUDA tensors"),
])
def test_flash_attention_fwd_refuses(case, match):
    """Kernel #1's wrapper raises on what the kernel does not take, with
    the shapes in the message, before it builds or launches anything; a
    well-formed call on CPU tensors is refused too."""
    cuda.reset_launch_counts()
    q, k = _qkv()
    v, kl, causal = k, None, False
    if case == "rank":
        q = q[0]
    elif case == "kv_shape":
        v = torch.zeros(1, 1, 5, 64)
    elif case == "causal":
        q, k = _qkv(tq=8, tk=4)
        v, causal = k, True
    elif case == "dtype":
        q, k = _qkv(dtype=torch.float16)
        v = k
    elif case == "k_len":
        kl = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_fwd(q, k, v, kl, None, causal)
    assert set(cuda.launch_counts().values()) == {0}


@pytest.mark.parametrize("case,match", [
    ("mode", "unknown dequant_matmul mode"),
    ("x_rank", "expects a float32, bfloat16 or float16 x"),
    ("qw_dtype", "qw must be int8"),
    ("qw_rows", "qw must be int8"),
    ("scale", "scale must be"),
    ("xscale", "xscale is one value of the dynamic mode"),
    ("bits", "outside the int8 grid"),
    ("cpu", "CUDA tensors"),
])
def test_dequant_matmul_kernel_refuses(case, match):
    """Kernel #7's wrapper raises on what the kernel does not take, with
    the shapes in the message, before it builds or launches anything; a
    well-formed call on CPU tensors is refused too."""
    cuda.reset_launch_counts()
    x, qw = torch.zeros(8, 40), torch.zeros(40, 16, dtype=torch.int8)
    scale, mode, xscale, bits = torch.ones(16), "weight_only", None, 8
    if case == "mode":
        mode = "int4"
    elif case == "x_rank":
        x = torch.zeros(8)
    elif case == "qw_dtype":
        qw = qw.float()
    elif case == "qw_rows":
        qw = torch.zeros(41, 16, dtype=torch.int8)
    elif case == "scale":
        scale = torch.ones(15)
    elif case == "xscale":
        xscale = torch.ones(1)
    elif case == "bits":
        mode, bits = "dynamic", 9
    with pytest.raises(ValueError, match=match):
        qm.dequant_matmul_kernel(x, qw, scale, mode, xscale, bits)
    assert set(cuda.launch_counts().values()) == {0}
