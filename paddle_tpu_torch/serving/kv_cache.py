"""Decode KV-cache state: per-layer K/V tensors [slots, heads, max_len,
head_dim] living in the engine's scope as persistable variables
(counterpart of the fixed-region ``KVCacheStore`` in
``paddle_tpu/serving/kv_cache.py``; the paged pool is not ported yet).

Slot recycling needs no device work: content past a slot's valid length
is masked by the attention op's ``k_len``, and a re-prefill overwrites
positions ``0..len-1``."""

import torch

from ..core import convert_dtype

__all__ = ["KVCacheStore"]


class KVCacheStore:
    """Names, declares, and initializes the cache variables shared by the
    prefill and decode programs of one decoder."""

    def __init__(self, n_layer, slots, n_head, max_len, head_dim,
                 dtype="float32", prefix="declm"):
        self.n_layer = int(n_layer)
        self.slots = int(slots)
        self.n_head = int(n_head)
        self.max_len = int(max_len)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.prefix = prefix

    @property
    def shape(self):
        return (self.slots, self.n_head, self.max_len, self.head_dim)

    def name(self, kind, layer):
        return "%s_cache_%s_%d" % (self.prefix, kind, layer)

    def names(self):
        return [self.name(kind, i) for i in range(self.n_layer)
                for kind in ("k", "v")]

    def declare(self, block, layer):
        """Create (or fetch) this layer's cache vars in ``block``."""
        out = []
        for kind in ("k", "v"):
            name = self.name(kind, layer)
            v = block._find_var_recursive(name)
            if v is None:
                v = block.create_var(name=name, shape=self.shape,
                                     dtype=self.dtype, persistable=True)
            out.append(v)
        return out

    def init_scope(self, scope, device):
        """Zero-fill every cache var on ``device``."""
        for name in self.names():
            scope.set_var(name, torch.zeros(
                self.shape, dtype=convert_dtype(self.dtype), device=device))

    def bytes(self):
        itemsize = torch.empty((), dtype=convert_dtype(self.dtype)) \
            .element_size()
        n = 1
        for s in self.shape:
            n *= s
        return 2 * self.n_layer * n * itemsize
