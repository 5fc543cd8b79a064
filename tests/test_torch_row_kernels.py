"""Host-side logic of the row kernels #5 (softmax + cross-entropy forward,
``ops/cuda/softmax_xent.py``) and #3 (layer-norm forward,
``ops/cuda/layer_norm.py``): #5's launch planner, and the kernels' cut of
a row as their sources define it (modelled here: ``_slices``,
``_warp_rows``, ``_lane_columns``), cover every value of every row
exactly once, and the order of sums the kernels promise gives the plain
versions' and the JAX kernels' results.  The kernels themselves run only
on the card: the ``cuda``-marked test here (on the card: ``python3 -m
pytest -m cuda tests/test_torch_row_kernels.py -q``), which also checks
#3's plan (made in C, where the occupancy API is), and ``chip_smoke.py``.
The JAX package is imported only inside the tests that compare with it,
so that the card's run of this file needs none."""

import ctypes

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.ops import cuda
from paddle_tpu_torch.ops.cuda import build
from paddle_tpu_torch.ops.cuda import layer_norm as ln
from paddle_tpu_torch.ops.cuda import softmax_xent as sx


@pytest.fixture(autouse=True)
def fresh_port_defaults():
    """Fresh port default programs, scope and name counter, and zeroed
    kernel launch counters, for every test."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    cuda.reset_launch_counts()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


# a row width on kernel #5's streaming path (more than 64K values)
STREAM_C = 100003
XENT_C = [1, 3, 1000, 1001, 30000, 30001, 32000, STREAM_C]
ROWS = [1, 5, 8, 1920]
# the H100's SMs, for planning
SMS = 132


def _slices(c, itemsize, offset, cluster):
    """Each cluster rank's share of a row of c values starting ``offset``
    bytes past a 16-byte boundary, in rank order, as kernel #5's ``Row``
    cuts it: (scalar columns, vector chunks as (first column, columns)).
    Chunk q holds columns [q ve - h, (q + 1) ve - h) of the row, h =
    offset / itemsize; rank r takes chunks [r per, (r + 1) per), per =
    ceil(chunks / cluster); a chunk cut by the row's ends is read and
    written one value at a time."""
    ve = 16 // itemsize
    h = (offset % 16) // itemsize
    q_all = (c + h + ve - 1) // ve
    per = -(-q_all // cluster)
    out = []
    for rank in range(cluster):
        q0 = min(rank * per, q_all)
        scalar, vector = [], []
        for q in range(q0, min(q0 + per, q_all)):
            c0 = q * ve - h
            if c0 >= 0 and c0 + ve <= c:
                vector.append((c0, ve))
            else:
                scalar += [j for j in range(c0, c0 + ve) if 0 <= j < c]
        out.append((scalar, vector))
    return out


def _warp_rows(n, wpb, blocks):
    """The rows of each warp of kernel #3's grid, warps in grid order:
    warp w takes rows w, w + warps, ..."""
    warps = wpb * blocks
    return [list(range(w, n, warps)) for w in range(warps)]


def _lane_columns(d, itemsize, vec):
    """The columns each lane of a warp holds, [lane][chunk], in kernel
    #3's order of sums: on the register path lane l loads the 16-byte
    chunks l, l + 32, ... of the row; the generic loop strides the row by
    32 columns from column l, a column a chunk."""
    if not vec:
        return [[[c] for c in range(lane, d, 32)] for lane in range(32)]
    ve = 16 // itemsize
    return [[list(range((k * 32 + lane) * ve, (k * 32 + lane + 1) * ve))
             for k in range(d // (32 * ve))] for lane in range(32)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", XENT_C)
def test_xent_plan_covers_every_column_once(c, itemsize):
    """#5's plan and slices: at every row start a tensor's rows can have
    (``offset`` bytes past a 16-byte boundary), the cluster's ranks
    together hold each column exactly once; vector chunks start on 16
    bytes and hold 16 bytes; scalar columns are only a misaligned head and
    tail; a rank's chunks fit its threads' registers; and only rows wider
    than eight blocks of registers take the streaming path."""
    ve = 16 // itemsize
    qmax = (c + 2 * ve - 2) // ve
    for n in ROWS:
        cluster, chunks = sx._fwd_plan(n, c, itemsize, SMS)
        if cluster == 0:
            assert c == STREAM_C and chunks == 0
            assert qmax > sx._MAX_CLUSTER * sx._NT * (sx._VALUES // ve)
        else:
            assert 1 <= cluster <= sx._MAX_CLUSTER
            assert chunks in (1, 2, 4, 8) and chunks * ve <= sx._VALUES
            assert -(-qmax // cluster) <= sx._NT * chunks
            least = -(-qmax // (sx._NT * (sx._VALUES // ve)))
            # a row takes more blocks only while the grid stays in a wave
            assert cluster == least \
                or n * cluster <= sx._BLOCKS_PER_SM * SMS
        offsets = {r * c * itemsize % 16 for r in range(n)}
        for off in range(0, 16, itemsize):
            slices = _slices(c, itemsize, off, max(cluster, 1))
            assert len(slices) == max(cluster, 1)
            cols = []
            for scalar, vector in slices:
                cols += scalar
                for first, width in vector:
                    assert width == ve
                    assert (first * itemsize + off) % 16 == 0
                    cols += range(first, first + width)
                assert all(j < ve or j >= c - ve for j in scalar)
                if cluster:
                    assert len(vector) + bool(scalar) <= sx._NT * chunks + 1
            assert sorted(cols) == list(range(c))
            offsets.discard(off)
        assert not offsets


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", [7, 96, 97, 512, 4096])
def test_layer_norm_plan_covers_every_value_once(d, aligned, itemsize):
    """#3's cut of its rows: on any grid (warps a block, blocks) every row
    is taken by exactly one warp, and a warp's lanes hold each column of
    its row exactly once, on the register path (D = 512, 16-byte aligned:
    whole 16-byte chunks on 16-byte boundaries) as on the generic loop
    (any other width or alignment)."""
    for n in ROWS:
        for wpb, blocks in ((1, 1), (1, 7), (3, 5), (8, 396)):
            rows = _warp_rows(n, wpb, blocks)
            assert sorted(r for w in rows for r in w) == list(range(n))
    vec = d == 512 and aligned
    lanes = _lane_columns(d, itemsize, vec)
    cols = [c for lane in lanes for chunk in lane for c in chunk]
    assert sorted(cols) == list(range(d))
    if vec:
        ve = 16 // itemsize
        assert all(chunk[0] * itemsize % 16 == 0 and len(chunk) == ve
                   for lane in lanes for chunk in lane)
        assert all(len(lane) == d // (32 * ve) for lane in lanes)


def _xent_emulated(x, label, eps, itemsize, cluster):
    """Kernel #5's arithmetic in torch float32: each rank's slice (from
    ``_slices`` at the row's byte offset) gives its max m, sum of
    exp(x - m), sum of x and the label's logit (0 outside its slice); the
    partials combine in rank order (M = max m, S = sum s exp(m - M)), and
    each rank writes exp(x - m) exp(m - M) / S."""
    n, c = x.shape
    loss = torch.empty(n, 1)
    softmax = torch.empty(n, c)
    for r in range(n):
        slices = _slices(c, itemsize, r * c * itemsize % 16, cluster)
        parts = []
        for scalar, vector in slices:
            cols = sorted(scalar + [j for first, w in vector
                                    for j in range(first, first + w)])
            xs = x[r, cols]
            m = xs.max() if cols else torch.tensor(float("-inf"))
            e = torch.exp(xs - (m if cols else 0.0))
            picked = x[r, int(label[r])] if int(label[r]) in cols \
                else torch.tensor(0.0)
            parts.append((cols, m, e, e.sum(), xs.sum(), picked))
        big_m = max(p[1] for p in parts)
        big_s = torch.tensor(0.0)
        sum_x = torch.tensor(0.0)
        picked = torch.tensor(0.0)
        for _, m, _, s, sxr, p in parts:
            big_s = big_s + s * torch.exp(m - big_m)
            sum_x = sum_x + sxr
            picked = picked + p
        for cols, m, e, _, _, _ in parts:
            softmax[r, cols] = e * (torch.exp(m - big_m) / big_s)
        log_z = big_m + torch.log(big_s)
        lr = log_z - picked
        if eps:
            lr = (1.0 - eps) * lr + eps * (log_z - sum_x / c)
        loss[r, 0] = lr
    return loss, softmax


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("n,c,itemsize", [(5, 1001, 4), (5, 1001, 2),
                                          (3, 3, 4), (4, 30001, 4),
                                          (2, STREAM_C, 4)])
def test_xent_rank_order_combine_matches_plain_and_jax(n, c, itemsize, eps):
    """The combine of per-slice (max, sum of exp, sum of x, label logit)
    partials in rank order, at the kernel's plan and at the most ranks,
    gives the plain version's loss and softmax (float32 rtol 1e-5, atol
    1e-6), and the JAX kernel's (interpret mode); one label lies past C
    and one below 0: they pick 0."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import softmax_xent as jsx

    rng = np.random.RandomState(c + n)
    x = (rng.randn(n, c) * 2).astype("float32")
    if itemsize == 2:  # bfloat16 logits, computed in float32
        x = torch.from_numpy(x).bfloat16().float().numpy()
    label = rng.randint(0, c, n).astype("int64")
    label[n // 2] = c + 3
    label[-1] = -1 if n > 2 else label[-1]
    tx, tl = torch.from_numpy(x), torch.from_numpy(label)
    want_loss, want_sm = sx.softmax_xent_reference(tx, tl, eps)
    j_loss, j_sm = jsx.softmax_xent(jnp.asarray(x), jnp.asarray(label), True,
                                    eps)
    plan = max(sx._fwd_plan(n, c, itemsize, SMS)[0], 1)
    for cluster in sorted({plan, 8}):
        loss, sm = _xent_emulated(tx, tl, eps, itemsize, cluster)
        for got, want in ((loss, want_loss), (sm, want_sm),
                          (loss, np.asarray(j_loss)), (sm, np.asarray(j_sm))):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
    # the out-of-range labels picked 0: loss = (1 - eps) logZ + eps (logZ
    # - mean x)
    log_z = torch.logsumexp(tx[n // 2], 0)
    want = log_z - eps * tx[n // 2].mean()
    np.testing.assert_allclose(float(loss[n // 2, 0]), float(want),
                               rtol=1e-5, atol=1e-6)


def _warp_sum(lanes):
    """ptt::warp_sum in float32: the xor butterfly over 32 lane values
    (every lane ends with the same value)."""
    v = lanes.clone()
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[idx ^ off]
    return v[0]


def _layer_norm_emulated(x, gamma, beta, eps, itemsize, vec):
    """Kernel #3's statistics in float32, in its order: each lane sums
    its values (register path: its 16-byte chunks l, l + 32, ..., in
    order; generic loop: columns l, l + 32, ...), the warp adds the lanes
    by the xor butterfly; the variance is the two-pass mean((x -
    mean)^2) from the same values, each square added by one fused
    multiply-add."""
    n, d = x.shape
    order = [[c for chunk in lane for c in chunk]
             for lane in _lane_columns(d, itemsize, vec)]
    mean, var = torch.empty(n), torch.empty(n)
    for r in range(n):
        s = torch.zeros(32)
        for lane, cols in enumerate(order):
            for c in cols:
                s[lane] = s[lane] + x[r, c]
        mu = _warp_sum(s) / d
        sq = torch.zeros(32)
        for lane, cols in enumerate(order):
            for c in cols:
                dv = (x[r, c] - mu).double()
                sq[lane] = (sq[lane].double() + dv * dv).float()
        mean[r], var[r] = mu, _warp_sum(sq) / d
    rstd = 1.0 / torch.sqrt(var + eps)
    y = (x - mean[:, None]) * rstd[:, None] * gamma + beta
    return y, mean, var


@pytest.mark.parametrize("n,d,vec", [(3, 512, True), (3, 512, False),
                                     (4, 97, False), (2, 7, False)])
def test_layer_norm_warp_order_matches_plain_and_jax(n, d, vec):
    """Kernel #3's statistics, summed in its order, give the plain
    version's mean, variance and y (float32 rtol 1e-5, atol 1e-6), and the
    JAX kernel's mean, rstd and y (interpret mode)."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import layer_norm as jln

    rng = np.random.RandomState(d + n)
    x = (rng.randn(n, d) * 3 + 1).astype("float32")
    gamma, beta = (rng.randn(d).astype("float32") for _ in range(2))
    tx, tg, tb = (torch.from_numpy(a) for a in (x, gamma, beta))
    y, mean, var = _layer_norm_emulated(tx, tg, tb, 1e-5, 4, vec)
    for got, want in zip((y, mean, var),
                         ln.layer_norm_reference(tx, tg, tb, 1e-5)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
    jy, (_, _, jmu, jrstd) = jln._fwd(jnp.asarray(x), jnp.asarray(gamma),
                                      jnp.asarray(beta), 1e-5, True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmu)[:, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((1.0 / torch.sqrt(var + 1e-5)).numpy(),
                               np.asarray(jrstd)[:, 0], rtol=1e-5, atol=1e-6)


def test_row_kernel_wrappers_refuse_cpu_tensors():
    """On CPU tensors the wrappers raise before any build and count no
    launch; the ops' entries take the plain versions there."""
    x = torch.randn(4, 512)
    label = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        sx.softmax_xent_fwd(x, label, 0.1)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        ln.layer_norm_fwd(x, torch.ones(512), torch.zeros(512))
    loss, sm = sx.softmax_xent(x, label, 0.1)
    y, _, _ = ln.layer_norm(x, torch.ones(512), torch.zeros(512))
    assert loss.shape == (4, 1) and sm.shape == x.shape and y.shape == x.shape
    assert set(cuda.launch_counts().values()) == {0}


@pytest.fixture
def card():
    """The CUDA device; the test skips on a machine without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the row kernels run on a card")
    return torch.device("cuda", 0)


def _misaligned(shape, dtype, offset, device, gen, scale=1.0, shift=0.0):
    """A contiguous [rows, cols] view ``offset`` elements into its
    storage, so that its rows (and with an odd offset its start) sit off
    16-byte boundaries."""
    n = shape[0] * shape[1]
    flat = (torch.randn(n + offset, generator=gen, device=device) * scale
            + shift).to(dtype)
    return flat[offset:].view(shape)


@pytest.mark.cuda
def test_row_kernels_match_plain_at_misaligned_rows(card):
    """#5 and #3 on the card at rows that start off 16-byte boundaries
    (the scalar head and tail, and the generic loop), and #5 at row
    clusters of 2 to 8 blocks: within ``chip_smoke.py``'s TOL / TOL_P of
    the plain versions, the same bits on two launches, an out-of-range
    label picking 0, and two launches counted; #3's plan (made in C) takes
    the register path exactly at D = 512 on 16-byte addresses, a warp a
    block below a wave of rows, and at most one wave of blocks."""
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
    tol_p = {torch.float32: (1e-7, 1e-4), torch.bfloat16: (1e-5, 2e-2)}
    g = torch.Generator(device=card).manual_seed(0)

    def close(got, want, dtype, t=tol):
        atol, rtol = t[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)

    # misaligned rows and views, then a row cluster of every size 2-8
    # (plans (8, 4), (2, 8), (3, 8), (4, 8), (5, 8), (6, 8), (7, 8), (6, 4))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    clusters = set()
    for (n, c, eps, dtype), offset in ((((64, 30001, 0.1, torch.float32)), 0),
                                       ((64, 1001, 0.0, torch.bfloat16), 0),
                                       ((16, 32000, 0.1, torch.float32), 1),
                                       ((4, 70001, 0.0, torch.bfloat16), 3),
                                       ((256, 12000, 0.1, torch.float32), 0),
                                       ((256, 20000, 0.0, torch.float32), 0),
                                       ((256, 28000, 0.1, torch.float32), 0),
                                       ((256, 36000, 0.1, torch.float32), 0),
                                       ((256, 44000, 0.0, torch.float32), 0),
                                       ((256, 50000, 0.1, torch.float32), 0),
                                       ((64, 20001, 0.0, torch.float32), 1)):
        x = _misaligned((n, c), dtype, offset, card, g, 2.0)
        label = torch.randint(0, c, (n,), generator=g, device=card)
        label[n // 2] = c + 3
        cuda.reset_launch_counts()
        loss, sm = sx.softmax_xent_fwd(x, label, eps)
        again = sx.softmax_xent_fwd(x, label, eps)
        assert sx.softmax_xent_fwd.launches == 2
        want_loss, want_sm = sx.softmax_xent_reference(x, label, eps)
        close(loss, want_loss, dtype)
        close(sm, want_sm, dtype, tol_p)
        assert torch.equal(loss, again[0]) and torch.equal(sm, again[1])
        clusters.add(sx._fwd_plan(n, c, x.element_size(), sms)[0])
    assert set(range(2, 9)) <= clusters
    # the kernel refuses a plan whose registers do not hold the row
    x = torch.zeros(2, 30000, device=card)
    label = torch.zeros(2, dtype=torch.int64, device=card)
    loss, sm = torch.empty(2, 1, device=card), torch.empty_like(x)
    assert sx._lib("softmax_xent_fwd")(
        x.data_ptr(), label.data_ptr(), loss.data_ptr(), sm.data_ptr(), 2,
        30000, 0.0, sx._DTYPE_CODE[x.dtype], 1, 1, card.index,
        torch.cuda.current_stream(card).cuda_stream) != 0

    # the generic loop, then the register path at 1-3 warps a block
    for (n, d, dtype), offset in (((1000, 97, torch.float32), 0),
                                  ((5, 4096, torch.bfloat16), 0),
                                  ((300, 512, torch.float32), 1),
                                  ((8, 512, torch.bfloat16), 0),
                                  ((300, 512, torch.float32), 0),
                                  ((140, 512, torch.bfloat16), 0)):
        x = _misaligned((n, d), dtype, offset, card, g, 3.0, 1.0)
        gamma, beta = (torch.randn(d, generator=g, device=card).to(dtype)
                       for _ in range(2))
        cuda.reset_launch_counts()
        got = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
        again = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
        assert ln.layer_norm_fwd.launches == 2
        for a, w in zip(got, ln.layer_norm_reference(x, gamma, beta, 1e-5)):
            close(a, w, dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        plan = (ctypes.c_int * 5)()
        build.check(build.library("layer_norm_fwd").ptt_layer_norm_fwd_plan(
            n, d, ln._DTYPE_CODE[dtype], int(offset == 0), card.index, plan),
            "ptt_layer_norm_fwd_plan")
        vec_d, wpb, blocks, n_sms, per_sm = plan
        assert vec_d == (512 if d == 512 and offset == 0 else 0)
        assert wpb == min(8, -(-n // n_sms)) and n_sms == sms
        assert blocks == max(1, min(-(-n // wpb), per_sm * n_sms))
