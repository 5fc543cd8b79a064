"""``kv_cache_write`` and ``kv_cache_paged_write``: the serving engine's
cache updates (counterpart of ``paddle_tpu/ops/kv_cache.py``; the paged
one is described at its definition below).

``kv_cache_write(Cache, X, Pos, Slot?) -> Out``: ``Cache`` [S, H, Tmax, D]
is a persistable scope variable and ``Out`` names the same variable;
``X`` [B, H, t, D] holds the new keys/values, ``Pos`` [B] their time
offset, ``Slot`` [B] the cache slot of each row (omitted = identity,
B == S: the decode step).

The JAX package returns a new cache and relies on XLA buffer donation to
make the update in place; here the op writes into the cache tensor itself
and returns it, so the update is in place by construction.  Start indices
go as ``lax.dynamic_update_slice`` takes them: a negative one counts from
the end (``pos + Tmax``), then it clamps, so a write of t rows at ``pos``
lands at ``min(max(pos, 0), Tmax - t)`` (and a slot index at
``min(max(slot, 0), S - 1)``) — a plain slice assignment would instead
fail or write a shorter stripe.  Scattered rows are written in order, one
indexed write a row with the slot and positions as device tensors, so a
later row wins where two overlap, as in the JAX loop of updates, and no
index is read on the host (a CUDA graph of the prefill replays it with
each run's slots).
"""

import numpy as np
import torch

from ..registry import in_var, register_op, set_output


def _start(i, dim, size):
    """``lax.dynamic_update_slice``'s start index for a window of ``size``
    along ``dim``: negative counts from the end, then clamps."""
    return torch.where(i < 0, i + dim, i).clamp(0, dim - size)


def _kv_cache_write_infer(op, block):
    cache = in_var(op, block, "Cache")
    x = in_var(op, block, "X")
    if cache is None or x is None:
        raise ValueError("kv_cache_write needs Cache and X inputs")
    if len(cache.shape) != 4 or len(x.shape) != 4:
        raise ValueError(
            "kv_cache_write expects Cache [S, H, Tmax, D] and X "
            "[B, H, t, D], got %s / %s" % (cache.shape, x.shape))
    set_output(op, block, "Out", cache.shape, cache.dtype)


def _kv_cache_write_compute(ins, attrs, ctx, op_index):
    cache = ins["Cache"][0]
    x = ins["X"][0].to(cache.dtype)
    s, _, tmax, _ = cache.shape
    t = x.shape[2]
    pos = ins["Pos"][0].reshape(-1).to(device=cache.device, dtype=torch.long)
    slot = ins.get("Slot", [None])[0]
    if slot is None:
        # decode: row b writes slot b; rows are distinct slots, so one
        # vectorized stripe write covers the whole batch
        if x.shape[0] != s:
            raise ValueError(
                "kv_cache_write without Slot needs one row per cache slot: "
                "X %s vs Cache %s" % (tuple(x.shape), tuple(cache.shape)))
        idx = _start(pos, tmax, t)[:, None] \
            + torch.arange(t, device=cache.device)
        rows = torch.arange(s, device=cache.device)[:, None]
        cache[rows, :, idx, :] = x.permute(0, 2, 1, 3)
        return {"Out": cache}
    # scattered prefill: one stripe per request row, in row order; the
    # [S, Tmax, H, D] view takes row b's [t, H, D] at (slot, positions)
    b = x.shape[0]
    slots = _start(slot.reshape(-1).to(device=cache.device,
                                       dtype=torch.long), s, 1)
    slots = slots[:, None].expand(b, t)
    idx = _start(pos, tmax, t)[:, None] \
        + torch.arange(t, device=cache.device)
    view = cache.permute(0, 2, 1, 3)
    for i in range(b):
        view[slots[i], idx[i]] = x[i].transpose(0, 1)
    return {"Out": cache}


register_op("kv_cache_write", ["Cache", "X", "Pos", "Slot"], ["Out"],
            infer=_kv_cache_write_infer, compute=_kv_cache_write_compute,
            grad=None)


# ---------------------------------------------------------------------------
# the paged cache: block-indexed writes over a page table
# ---------------------------------------------------------------------------
#
# ``kv_cache_paged_write(Cache, X, Pos, PageTable, Slot?, Scale?) -> Out,
# OutScale?``: ``Cache`` [P, H, ps, D] is the page pool (int8 under
# quantized KV, with ``Scale`` [P, H, ps] its per-token-row scales), ``X``
# [B, H, t, D] the new keys/values, ``Pos`` [B] the position of X's first
# token, ``PageTable`` [S, max_pages] each slot's pages, ``Slot`` [B] the
# slot of each row (omitted = identity).  Three shapes, as in the JAX op:
# t == 1 (decode) writes one token a row at page ``table[row, pos // ps]``,
# offset ``pos % ps``; t a multiple of ps (prefill) writes whole pages;
# any other t (the speculative verify's k tokens) writes token by token,
# each looking up its own page.  The tokens go in one scatter, token j's
# after token j - 1's (the JAX op's order: on the CPU a later unit wins).
#
# The JAX op scatters with ``mode="drop"``: a table entry out of the pool
# (the engine's sentinel ``num_pages`` for an unheld page) writes nothing.
# A CUDA ``index_put_`` has no such mode and asserts on the device for an
# index out of range, so each scatter here points every dropped unit at
# the destination of the scatter's last kept unit and repeats that unit's
# value there (``ops/selected_rows.py``'s ``scatter_update_rows`` does the
# same), or, when the scatter keeps no unit, writes back what is already at
# its first (clamped) destination.  Every index stays in range, a dropped
# unit changes no bit, and nothing is read on the host.  Table and slot
# lookups (gathers) clamp as XLA's do.

def _clamp_index(i, n):
    """XLA's gather index: negative counts from the end, then clamps."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _drop_index(i, n):
    """(index wrapped as numpy wraps it, kept): XLA's ``mode="drop"``
    keeps an index inside [0, n) after one wrap and drops any other."""
    i = torch.where(i < 0, i + n, i)
    return i, (i >= 0) & (i < n)


def _drop_plan(index, kept, shape):
    """Where the units of a dropping scatter go: ``index`` is a tuple of
    [N] index tensors into the leading dims ``shape`` of the pool, ``kept``
    [N] the units that write.  Returns (indices, kept, anchor, any kept,
    the anchor's destination): each dropped unit points at the last kept
    unit's destination, or, with none kept, at the first unit's clamped
    one.  The anchor is a one-element index tensor: indexing by a 0-dim
    one would read it on the host.  One plan serves the values and the
    scales of a write, and every write of a run from the same table and
    positions (``_write_plan``)."""
    n = kept.shape[0]
    order = torch.arange(n, device=kept.device)
    last = torch.where(kept, order, -1).amax(dim=0, keepdim=True)   # [1]
    anchor = last.clamp(min=0)
    index = tuple(i.long() for i in index)
    dest = tuple(i[anchor].clamp(0, s - 1) for i, s in zip(index, shape))
    idx = tuple(torch.where(kept, i, d) for i, d in zip(index, dest))
    return idx, kept, anchor, last >= 0, dest


def _put(pool, plan, values):
    """``pool[index] = values`` for the plan's kept units [N, ...], the
    pool's bits unchanged where the dropped ones point."""
    idx, kept, anchor, any_kept, dest = plan
    # the anchor unit's value, or the pool's own where nothing is kept
    fill = torch.where(any_kept.reshape((1,) * values.dim()),
                       values[anchor], pool[dest])          # [1, ...]
    mask = kept.reshape((kept.shape[0],) + (1,) * (values.dim() - 1))
    pool.index_put_(idx, torch.where(mask, values, fill))


def _write_plan(table, pos, slot, b, t, ps, n_pages):
    """The drop plan of a paged write of ``b`` rows of ``t`` tokens: units
    [t * b] token-major (decode, verify) of (page, offset), or the [b *
    npg] whole pages of a page-aligned prefill."""
    dev = table.device
    s, mp = table.shape
    if slot is not None:
        rows = _clamp_index(slot.reshape(-1).to(dev), s)
    elif b <= s:
        rows = torch.arange(b, device=dev)
    else:
        rows = torch.arange(b, device=dev).clamp(max=s - 1)
    if t % ps or t == 1:
        p = pos if t == 1 else (
            pos[None, :] + torch.arange(t, device=dev,
                                        dtype=pos.dtype)[:, None])
        page, kept = _drop_index(
            table[rows, _clamp_index(p // ps, mp)].reshape(-1), n_pages)
        return _drop_plan((page, (p % ps).reshape(-1)), kept,
                          (n_pages, ps))
    page, kept = _drop_index(table[rows][:, :t // ps].reshape(-1), n_pages)
    return _drop_plan((page,), kept, (n_pages,))


# XLA compiles the JAX op's ``amax / 127.0`` as a product with the float32
# reciprocal of 127 (its programs run jitted), so the scales here are that
# product, which an IEEE multiply gives alike on the CPU and the card
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize_rows(x):
    """Per-token-row int8 grid: one abs-max scale a (token, head) row over
    the D channels; (int8 values, float32 scales [..., t]).  The scale is
    ``max(amax, 1e-12) * (1 / 127)`` (see ``_INV_127``), the values
    ``x / scale`` rounded half to even (``torch.round``, as ``jnp.round``)
    with an IEEE division by a tensor (a Python divisor would be a
    reciprocal product on the card)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-12) * torch.full(
        (), _INV_127, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _paged_write_infer(op, block):
    cache = in_var(op, block, "Cache")
    x = in_var(op, block, "X")
    table = in_var(op, block, "PageTable")
    if cache is None or x is None or table is None:
        raise ValueError(
            "kv_cache_paged_write needs Cache, X and PageTable inputs")
    if len(cache.shape) != 4 or len(x.shape) != 4 or len(table.shape) != 2:
        raise ValueError(
            "kv_cache_paged_write expects Cache [P, H, ps, D], X "
            "[B, H, t, D], PageTable [S, max_pages]; got %s / %s / %s"
            % (cache.shape, x.shape, table.shape))
    set_output(op, block, "Out", cache.shape, cache.dtype)
    scale = in_var(op, block, "Scale")
    if scale is not None:
        set_output(op, block, "OutScale", scale.shape, scale.dtype)


def _paged_write_compute(ins, attrs, ctx, op_index):
    cache = ins["Cache"][0]
    x = ins["X"][0]
    dev = cache.device
    pos = ins["Pos"][0].reshape(-1).to(dev)
    table = ins["PageTable"][0].to(dev)
    slot = ins.get("Slot", [None])[0]
    scales = ins.get("Scale", [None])[0]
    quantized = cache.dtype == torch.int8
    n_pages, _, ps, _ = cache.shape
    b, h, t, d = x.shape
    if quantized:
        qx, qs = _quantize_rows(x)        # [B,H,t,D] int8, [B,H,t] f32
    else:
        qx, qs = x.to(cache.dtype), None
    scaled = quantized and scales is not None
    args = (table, pos, slot, b, t, ps, n_pages)
    if ctx is None:
        plan = _write_plan(*args)
    else:
        # the K and V writes of every layer share one plan a run
        plan = ctx.shared_value(("kv_paged_write", b, t, ps, n_pages),
                                (table, pos, slot),
                                lambda: _write_plan(*args))
    out = {"Out": cache}
    if scaled:
        out["OutScale"] = scales
    if t % ps or t == 1:
        # a unit is one token's [H, D] in the [P, ps, H, D] view
        _put(cache.transpose(1, 2), plan,
             qx.permute(2, 0, 1, 3).reshape(t * b, h, d))
        if scaled:
            _put(scales.transpose(1, 2), plan,
                 qs.permute(2, 0, 1).reshape(t * b, h))
        return out
    npg = t // ps
    _put(cache, plan, qx.reshape(b, h, npg, ps, d).transpose(1, 2)
         .reshape(b * npg, h, ps, d))
    if scaled:
        _put(scales, plan, qs.reshape(b, h, npg, ps).transpose(1, 2)
             .reshape(b * npg, h, ps))
    return out


register_op("kv_cache_paged_write",
            ["Cache", "X", "Pos", "PageTable", "Slot", "Scale"],
            ["Out", "OutScale"],
            infer=_paged_write_infer, compute=_paged_write_compute,
            grad=None)
