"""The float32 arithmetic of the NHWC kernels #10/#11 on the CPU.

The kernels take a float32 product on the tensor cores as three TF32
passes (``conv_bn.matmul_tf32x3``).  Here the fused layer, forward and
backward, is taken with that product in place of the float32 one and held
against the plain versions ``bn_act_matmul_reference`` /
``bn_act_matmul_bwd_reference`` in ``chip_smoke.py``'s float32 band,
|got - plain| <= 1e-4 |plain| + 1e-5 sum|terms|: three passes hold it, one
pass does not, so the band tells the two apart.  The kernels themselves run
only on the card (``chip_smoke.py``'s ``kernels`` phase holds them in the
same band).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import conv_bn as cb

M, C, O = 300, 72, 40
RTOL, STOL = 1e-4, 1e-5   # chip_smoke.py's CONV_BN_TOL[torch.float32]
VIEW = (1, -1)


def _inputs(seed):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor((rng.randn(*shape) * scale + offset)
                            .astype("float32"))

    x = t(M, C, offset=0.5)
    w = t(C, O, scale=C ** -0.5).t()   # [O, C] with the NHWC op's strides
    mean, beta = t(C, scale=0.1, offset=0.5), t(C, scale=0.1)
    rstd = torch.tensor(rng.rand(C).astype("float32") + 0.5)
    gamma = torch.tensor(rng.rand(C).astype("float32") + 0.5)
    shift = t(O, scale=0.1)
    dz, dsum, dsumsq = t(M, O), t(O), t(O, scale=1e-2)
    return x, w, mean, rstd, gamma, beta, shift, dz, dsum, dsumsq


def _within(got, want, scale):
    return bool(((got - want).abs() <= RTOL * want.abs() + STOL * scale)
                .all())


def _forward(x, w, mean, rstd, gamma, beta, shift, apply_bn, passes):
    """(outputs of the product ``passes``, plain outputs, scales)."""
    act = "relu" if apply_bn else ""
    args = (x, w, mean, rstd, gamma, beta, shift, act, apply_bn, True)
    want = cb.bn_act_matmul_reference(*args, nhwc=True)
    xn = cb._act_norm(x, mean, rstd, gamma, beta, act, apply_bn, VIEW)
    z = cb.matmul_tf32x3(xn, w.t(), passes)
    zc = z - shift
    absprod = xn.abs() @ w.abs().t()
    wc = want[0] - shift
    scales = [absprod, (wc.abs() + absprod).sum(0),
              (wc * wc + 2 * wc.abs() * absprod).sum(0)]
    return [z, zc.sum(0), (zc * zc).sum(0)], want, scales


def _backward(x, w, mean, rstd, gamma, beta, shift, dz, dsum, dsumsq,
              apply_bn, with_stats, passes):
    act = "relu" if apply_bn else ""
    z = cb.bn_act_matmul_reference(x, w, mean, rstd, gamma, beta, shift,
                                   act, apply_bn, False, nhwc=True)[0]
    if not with_stats:
        dsum = dsumsq = None
    want = cb.bn_act_matmul_bwd_reference(
        x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta, shift, act,
        apply_bn, with_stats, nhwc=True)
    d = dz + dsum + 2 * (z - shift) * dsumsq if with_stats else dz
    pre = (x - mean) * rstd
    ylin = pre * gamma + beta if apply_bn else x
    xn = torch.relu(ylin) if act else ylin
    dw = cb.matmul_tf32x3(d.t(), xn, passes)
    dxn = cb.matmul_tf32x3(d, w, passes)
    dxn_scale, dw_scale = d.abs() @ w.abs(), d.abs().t() @ xn.abs()
    if apply_bn:
        dylin = dxn * (ylin > 0) if act else dxn
        got = [dylin * gamma * rstd, dw, (dylin * pre).sum(0),
               dylin.sum(0)]
        scales = [dxn_scale * gamma * rstd, dw_scale,
                  (dxn_scale * pre.abs()).sum(0), dxn_scale.sum(0)]
    else:
        got = [dxn * (x > 0) if act else dxn, dw, torch.zeros(C),
               torch.zeros(C)]
        scales = [dxn_scale, dw_scale, torch.zeros(C), torch.zeros(C)]
    return got, want, scales


CASES = ([("forward", apply_bn, False) for apply_bn in (True, False)]
         + [("backward", apply_bn, with_stats) for apply_bn in (True, False)
            for with_stats in (True, False)])


def _run(direction, apply_bn, with_stats, passes):
    """Per output: does the emulated kernel hold the plain version in the
    band?"""
    inputs = _inputs(7 + 2 * apply_bn + with_stats)
    if direction == "forward":
        got, want, scales = _forward(*inputs[:7], apply_bn, passes)
    else:
        got, want, scales = _backward(*inputs, apply_bn, with_stats, passes)
    return [_within(g, w_, s) for g, w_, s in zip(got, want, scales)]


@pytest.mark.parametrize("direction,apply_bn,with_stats", CASES)
def test_three_tf32_passes_hold_the_float32_band(direction, apply_bn,
                                                  with_stats):
    """z, sum, sumsq (forward) and dx, dW, dgamma, dbeta (backward), with
    and without the BN + ReLU prologue and the stats fold."""
    assert all(_run(direction, apply_bn, with_stats, 3))


@pytest.mark.parametrize("direction,apply_bn,with_stats", CASES)
def test_one_tf32_pass_breaks_the_float32_band(direction, apply_bn,
                                               with_stats):
    """One TF32 pass keeps ~2^-11 of each operand: the products (z; dx and
    dW) leave the band, so the band can tell one pass from three."""
    held = _run(direction, apply_bn, with_stats, 1)
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
