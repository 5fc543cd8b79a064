"""The float32 arithmetic of the tensor-core kernels #8-#11 on the CPU.

Kernels #10/#11 (NHWC) and #8/#9 (NCHW) take a float32 product on the
tensor cores as three TF32 passes (``conv_bn.matmul_tf32x3``).  Here the
fused layer, forward and backward, is taken with that product in place of
the float32 one, in each layout, and held against the plain versions
``bn_act_matmul_reference`` / ``bn_act_matmul_bwd_reference`` in
``chip_smoke.py``'s float32 band, |got - plain| <= 1e-4 |plain| + 1e-5
sum|terms|: three passes hold it, one pass does not, so the band tells the
two apart.  NHWC takes M = 300 positions; NCHW 6 images of 7x7 (HW = 49,
so the positions run across images as in ResNet-50's stage 4).  The
kernels themselves run only on the card (``chip_smoke.py``'s ``kernels``
phase holds them in the same band).

The plain versions of #10/#11 are also held against the JAX package's
Pallas kernels in interpret mode at a scaled-down SE-ResNeXt-50 stage-1
conv2 ([2, 128 -> 256, 8x8] NHWC, the BN + ReLU prologue; backward with
the stats fold), the shape the NHWC + fused SE-ResNeXt program gives them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import conv_bn as jax_conv_bn

from paddle_tpu_torch.ops.cuda import conv_bn as cb

M, C, O = 300, 72, 40
B, HW = 6, 49             # NCHW: 294 positions
RTOL, STOL = 1e-4, 1e-5   # chip_smoke.py's CONV_BN_TOL[torch.float32]


class Layout:
    """How a layout shapes x, broadcasts a channel vector, sums over the
    positions, and writes the three products of the layer."""

    def __init__(self, nhwc):
        self.nhwc = nhwc
        self.view = (1, -1) if nhwc else (1, -1, 1)
        self.pos = (0,) if nhwc else (0, 2)

    def x_shape(self):
        return (M, C) if self.nhwc else (B, C, HW)

    def dz_shape(self):
        return (M, O) if self.nhwc else (B, O, HW)

    def flat(self, t):
        """[channels, positions] of an activation."""
        return t.t() if self.nhwc else t.transpose(0, 1).reshape(t.shape[1],
                                                                 -1)

    def z(self, mm, xn, w):
        return mm(xn, w.t()) if self.nhwc else mm(w, xn)

    def dxn(self, mm, d, w):
        return mm(d, w) if self.nhwc else mm(w.t(), d)

    def dw(self, mm, d, xn):
        return mm(self.flat(d), self.flat(xn).t())


def _inputs(seed, lay):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor((rng.randn(*shape) * scale + offset)
                            .astype("float32"))

    x = t(*lay.x_shape(), offset=0.5)
    # [O, C]: with the NHWC op's strides (a transposed [C, O]) or contiguous
    w = t(C, O, scale=C ** -0.5).t() if lay.nhwc \
        else t(O, C, scale=C ** -0.5)
    mean, beta = t(C, scale=0.1, offset=0.5), t(C, scale=0.1)
    rstd = torch.tensor(rng.rand(C).astype("float32") + 0.5)
    gamma = torch.tensor(rng.rand(C).astype("float32") + 0.5)
    shift = t(O, scale=0.1)
    dz, dsum, dsumsq = t(*lay.dz_shape()), t(O), t(O, scale=1e-2)
    return x, w, mean, rstd, gamma, beta, shift, dz, dsum, dsumsq


def _within(got, want, scale):
    return bool(((got - want).abs() <= RTOL * want.abs() + STOL * scale)
                .all())


def _forward(lay, x, w, mean, rstd, gamma, beta, shift, apply_bn, passes):
    """(outputs of the product ``passes``, plain outputs, scales)."""
    act = "relu" if apply_bn else ""
    args = (x, w, mean, rstd, gamma, beta, shift, act, apply_bn, True)
    want = cb.bn_act_matmul_reference(*args, nhwc=lay.nhwc)
    xn = cb._act_norm(x, mean, rstd, gamma, beta, act, apply_bn, lay.view)
    z = lay.z(lambda a, b: cb.matmul_tf32x3(a, b, passes), xn, w)
    sh = shift.view(lay.view)
    zc = z - sh
    absprod = lay.z(torch.matmul, xn.abs(), w.abs())
    wc = want[0] - sh
    scales = [absprod, (wc.abs() + absprod).sum(lay.pos),
              (wc * wc + 2 * wc.abs() * absprod).sum(lay.pos)]
    return [z, zc.sum(lay.pos), (zc * zc).sum(lay.pos)], want, scales


def _backward(lay, x, w, mean, rstd, gamma, beta, shift, dz, dsum, dsumsq,
              apply_bn, with_stats, passes):
    act = "relu" if apply_bn else ""
    z = cb.bn_act_matmul_reference(x, w, mean, rstd, gamma, beta, shift,
                                   act, apply_bn, False, nhwc=lay.nhwc)[0]
    if not with_stats:
        dsum = dsumsq = None
    want = cb.bn_act_matmul_bwd_reference(
        x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta, shift, act,
        apply_bn, with_stats, nhwc=lay.nhwc)
    v = lay.view
    d = dz + dsum.view(v) + 2 * (z - shift.view(v)) * dsumsq.view(v) \
        if with_stats else dz
    pre = (x - mean.view(v)) * rstd.view(v)
    ylin = pre * gamma.view(v) + beta.view(v) if apply_bn else x
    xn = torch.relu(ylin) if act else ylin
    mm = lambda a, b: cb.matmul_tf32x3(a, b, passes)  # noqa: E731
    dw = lay.dw(mm, d, xn)
    dxn = lay.dxn(mm, d, w)
    dxn_scale = lay.dxn(torch.matmul, d.abs(), w.abs())
    dw_scale = lay.dw(torch.matmul, d.abs(), xn.abs())
    zeros = torch.zeros(C)
    if apply_bn:
        dylin = dxn * (ylin > 0) if act else dxn
        gr = (gamma * rstd).view(v)
        got = [dylin * gr, dw, (dylin * pre).sum(lay.pos),
               dylin.sum(lay.pos)]
        scales = [dxn_scale * gr, dw_scale,
                  (dxn_scale * pre.abs()).sum(lay.pos),
                  dxn_scale.sum(lay.pos)]
    else:
        got = [dxn * (x > 0) if act else dxn, dw, zeros, zeros]
        scales = [dxn_scale, dw_scale, zeros, zeros]
    return got, want, scales


# NHWC's cases keep their ids from before the NCHW kernels joined them
CASES = [pytest.param(layout, *case,
                      id=("" if layout == "nhwc" else "nchw-")
                      + "-".join(map(str, case)))
         for layout in ("nhwc", "nchw")
         for case in ([("forward", apply_bn, False)
                       for apply_bn in (True, False)]
                      + [("backward", apply_bn, with_stats)
                         for apply_bn in (True, False)
                         for with_stats in (True, False)])]


def _run(layout, direction, apply_bn, with_stats, passes):
    """Per output: does the emulated kernel hold the plain version in the
    band?"""
    lay = Layout(layout == "nhwc")
    inputs = _inputs(7 + 2 * apply_bn + with_stats, lay)
    if direction == "forward":
        got, want, scales = _forward(lay, *inputs[:7], apply_bn, passes)
    else:
        got, want, scales = _backward(lay, *inputs, apply_bn, with_stats,
                                      passes)
    return [_within(g, w_, s) for g, w_, s in zip(got, want, scales)]


@pytest.mark.parametrize("layout,direction,apply_bn,with_stats", CASES)
def test_three_tf32_passes_hold_the_float32_band(layout, direction,
                                                  apply_bn, with_stats):
    """z, sum, sumsq (forward) and dx, dW, dgamma, dbeta (backward), with
    and without the BN + ReLU prologue and the stats fold."""
    assert all(_run(layout, direction, apply_bn, with_stats, 3))


@pytest.mark.parametrize("layout,direction,apply_bn,with_stats", CASES)
def test_one_tf32_pass_breaks_the_float32_band(layout, direction, apply_bn,
                                               with_stats):
    """One TF32 pass keeps ~2^-11 of each operand: the products (z; dx and
    dW) leave the band, so the band can tell one pass from three."""
    held = _run(layout, direction, apply_bn, with_stats, 1)
    assert not held[0] and (direction == "forward" or not held[1])


def test_tf32_round_is_cvt_rna():
    """Round to 10 mantissa bits, to nearest, ties away from zero; the low
    13 bits cleared; the split v = hi + lo leaves lo within half a TF32
    ulp of hi."""
    ulp = 2.0 ** -10
    v = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4,
                      -(1 + ulp / 2), 3.0e-30, -7.5e12, 0.0])
    want = [1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp)]
    got = cb.tf32_round(v)
    assert got[:5].tolist() == want
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    rng = np.random.RandomState(0)
    r = torch.tensor(rng.randn(4096).astype("float32") * 1e3)
    hi = cb.tf32_round(r)
    assert bool(((r - hi).abs() <= hi.abs() * 2.0 ** -11).all())
    assert torch.equal(cb.tf32_round(hi), hi)


# SE-ResNeXt-50's stage-1 conv2 (128 -> 256 after the grouped conv's BN +
# ReLU), cut to 2 images of 8x8
SE_B, SE_HW, SE_C, SE_O = 2, 64, 128, 256


@pytest.mark.parametrize("direction", ["forward", "backward"],
                         ids=["nhwc-se_resnext-forward",
                              "nhwc-se_resnext-backward-fold"])
def test_plain_follows_pallas_at_se_resnext_shape(direction):
    """``bn_act_matmul_nhwc`` (the plain #10 / #11 under autograd) against
    the JAX ``custom_vjp`` whose Pallas kernels run in interpret mode:
    z, sum, sumsq, and backward every cotangent with the stats fold, rtol
    1e-4 with an absolute term of 1e-5 of the output's largest magnitude
    (float32 sums over 128 positions or 128 channels in another order)."""
    rng = np.random.RandomState(11)
    m = SE_B * SE_HW
    args = [rng.randn(m, SE_C).astype("float32") + 0.5,
            (rng.randn(SE_C, SE_O) * SE_C ** -0.5).astype("float32"),
            (rng.randn(SE_C) * 0.1 + 0.5).astype("float32"),
            (rng.rand(SE_C) + 0.5).astype("float32"),
            (rng.rand(SE_C) + 0.5).astype("float32"),
            (rng.randn(SE_C) * 0.1).astype("float32")]
    shift = (rng.randn(SE_O) * 0.1).astype("float32")
    cts = [rng.randn(m, SE_O).astype("float32"),
           rng.randn(SE_O).astype("float32"),
           (rng.randn(SE_O) * 1e-2).astype("float32")]

    def ker(*a):
        return jax_conv_bn.bn_act_matmul_nhwc(*a, jnp.asarray(shift), 1e-5,
                                              "relu", True, True, True)

    want, vjp = jax.vjp(ker, *map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    got = cb.bn_act_matmul_nhwc(*leaves, torch.tensor(shift), 1e-5, "relu",
                                True, True)
    names = ["z", "sum", "sumsq"]
    if direction == "backward":
        want = vjp(tuple(map(jnp.asarray, cts)))
        got = torch.autograd.grad(got, leaves, [torch.tensor(c) for c in cts])
        names = ["dx", "dw", "dmean", "dvar", "dgamma", "dbeta"]
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=1e-4,
            atol=1e-5 * float(np.abs(w).max()) + 1e-7, err_msg=name)
