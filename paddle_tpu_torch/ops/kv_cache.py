"""``kv_cache_write``: the serving engine's cache update (counterpart of
``paddle_tpu/ops/kv_cache.py``).

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
