"""uint32 hash arithmetic on int64 tensors: the murmur3 finalizer that the
attention-dropout keep-mask (``ops/cuda/flash_attention.keep_mask``) and
the per-op seeds of a run (``op_seeds``, read by
``registry.ComputeContext.seed32``) share.  Values are held as uint32 in
int64 tensors, so every product stays exact."""

import torch

__all__ = ["M32", "mul32", "mix32", "as_int32", "op_seeds"]

M32 = 0xFFFFFFFF


def mul32(a, c):
    """(a * c) mod 2**32 for an int64 tensor ``a`` in [0, 2**32) and a
    constant ``c`` < 2**32, without int64 overflow: split c in 16-bit
    halves so every partial product stays below 2**48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(h):
    """murmur3 finalizer on values held as uint32 in int64."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def as_int32(h):
    """uint32 values held in int64 as int32 tensors with the same bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def op_seeds(run_key, n):
    """The dropout seeds of ops 0..n-1 of one run: int32 [n] on the run
    key's device, element i a murmur3 mix of the run key (int64 [1]) and
    op index i alone, so the generic grad's recompute of op i (which
    passes the forward's index) draws the forward's mask."""
    i = torch.arange(n, device=run_key.device)
    h = mix32((run_key & M32) ^ mul32(i, 0x9E3779B1))
    return as_int32(mix32(h ^ ((run_key >> 32) & M32)))
