"""Decode KV-cache state living in the engine's scope as persistable
variables (counterpart of ``paddle_tpu/serving/kv_cache.py``):

* ``KVCacheStore`` — the fixed region, per-layer K/V tensors [slots,
  heads, max_len, head_dim];
* ``PagedKVCacheStore`` — one pool of pages [P, heads, page_size,
  head_dim] a layer and kind (int8 pools with float32 per-token-row
  scales [P, heads, page_size]), shared by every slot through a page
  table the engine feeds;
* ``PageAllocator`` — the host bookkeeping of one pool: free list,
  refcounts, chain-hashed prefix aliasing, copy-on-write split, leak
  check.  Pure host logic, the JAX package's copied.

Slot recycling needs no device work: content past a slot's valid length
is masked by the attention op's ``k_len``, and a re-prefill overwrites
positions ``0..len-1``."""

import hashlib

import torch

from ..core import convert_dtype

__all__ = ["KVCacheStore", "PageAllocator", "PagedKVCacheStore",
           "OutOfPagesError"]


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
        return 2 * self.n_layer * _numel(self.shape) * _itemsize(self.dtype)


def _itemsize(dtype):
    return torch.empty((), dtype=convert_dtype(dtype)).element_size()


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


class OutOfPagesError(RuntimeError):
    """The pool has no free page for the requested allocation; the
    admission layer queues the request instead of crashing the engine."""


class PageAllocator:
    """Host-side page bookkeeping for one paged cache pool: free list,
    per-page refcounts, per-slot page lists, copy-on-write split, and
    the content-hash prefix index.

    Pure control logic (no device, no clock): every decision is
    deterministic and unit-testable without a compiled program.  Device
    content is only ever APPENDED page-aligned by deterministic prefill/
    decode writes, so two slots aliasing a page always wrote (or would
    write) identical K/V into it — sharing is a table-aliasing decision
    here, never a device copy.

    The prefix index maps a chain hash of full page-sized token chunks
    to a physical page: requests admitted with a common system prompt
    alias those pages and the prefill skips nothing device-side (the
    duplicate write is content-identical), but the HBM cost is paid
    once.  Partial trailing pages are never shared — decode appends
    into them, and divergent continuations must not alias."""

    def __init__(self, num_pages, page_size):
        if num_pages < 1 or page_size < 1:
            raise ValueError("need at least one page and one token")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._ref = {}                  # page -> refcount
        self._slot_pages = {}           # slot -> [page, ...]
        self._prefix = {}               # chain hash -> page
        self._page_prefix = {}          # page -> chain hash (owner)
        self.prefix_hits = 0
        self.prefix_misses = 0

    # -- capacity ------------------------------------------------------
    def free_pages(self):
        return len(self._free)

    def pages_in_use(self):
        return self.num_pages - len(self._free)

    def pages_needed(self, prompt_len, max_new):
        """Pages a fresh (no-sharing) generation needs end to end; the
        admission gate's worst case."""
        total = int(prompt_len) + int(max_new)
        return -(-total // self.page_size)

    def can_admit(self, prompt_len, max_new, prompt_ids=None):
        """Whether alloc_for_prompt would succeed right now (sharing
        counted when ``prompt_ids`` is given)."""
        need = self.pages_needed(prompt_len, max_new)
        if prompt_ids is not None:
            for h in self._chunk_hashes(prompt_ids):
                if h in self._prefix:
                    need -= 1
                else:
                    break
        return need <= len(self._free)

    # -- allocation ----------------------------------------------------
    def _take(self):
        if not self._free:
            raise OutOfPagesError(
                "page pool exhausted (%d pages in use)" % self.num_pages)
        p = self._free.pop()
        self._ref[p] = 1
        return p

    def _chunk_hashes(self, prompt_ids):
        """Chain hashes of the FULL page-sized prefix chunks: chunk j's
        hash covers tokens 0..(j+1)*ps, so a page is shared only with a
        request whose entire preceding prefix matches (K/V at a position
        depend on every earlier token)."""
        ps = self.page_size
        out, h = [], hashlib.sha1(b"kv-prefix")
        for j in range(len(prompt_ids) // ps):
            for t in prompt_ids[j * ps:(j + 1) * ps]:
                h.update(b"%d," % int(t))
            out.append(h.hexdigest())
        return out

    def alloc_for_prompt(self, slot, prompt_ids, max_new):
        """Allocate slot's page list for a prompt + decode budget,
        aliasing shared full-prefix pages from the index.  Returns
        ``(pages, shared_count)``; raises :class:`OutOfPagesError`
        (allocating nothing) when the pool cannot cover it."""
        if slot in self._slot_pages:
            raise ValueError("slot %r already holds pages" % (slot,))
        hashes = self._chunk_hashes(prompt_ids)
        shared = []
        for h in hashes:
            p = self._prefix.get(h)
            if p is None:
                break
            shared.append((h, p))
        total = self.pages_needed(len(prompt_ids), max_new)
        fresh_needed = total - len(shared)
        if fresh_needed > len(self._free):
            self.prefix_misses += len(hashes) - len(shared)
            self.prefix_hits += 0
            raise OutOfPagesError(
                "need %d fresh pages, %d free" % (fresh_needed,
                                                  len(self._free)))
        pages = []
        for h, p in shared:
            self._ref[p] += 1
            pages.append(p)
        self.prefix_hits += len(shared)
        for j in range(len(shared), total):
            p = self._take()
            pages.append(p)
            # full prompt-covered pages enter the prefix index owned by
            # their chain hash; the trailing partial/decode pages never
            # do (divergent continuations must not alias)
            if j < len(hashes):
                self._prefix[hashes[j]] = p
                self._page_prefix[p] = hashes[j]
                self.prefix_misses += 1
        self._slot_pages[slot] = pages
        return pages, len(shared)

    def extend(self, slot, n=1):
        """Append n fresh pages to a live slot (a generation outgrowing
        its initial budget)."""
        pages = self._slot_pages[slot]
        for _ in range(n):
            pages.append(self._take())
        return pages

    def cow_split(self, slot, index):
        """Copy-on-write split: give ``slot`` a private copy of its
        ``index``-th page.  Returns ``(old_page, new_page)`` — the
        caller owns copying device content old -> new before the next
        write — or ``(page, page)`` when the page was already private
        (refcount 1), which needs no copy."""
        pages = self._slot_pages[slot]
        old = pages[index]
        if self._ref[old] <= 1:
            return old, old
        new = self._take()
        self._ref[old] -= 1
        pages[index] = new
        return old, new

    def release(self, slot):
        """Drop every page ref the slot holds (terminal request: done,
        failed, expired, quarantined).  Shared prefix pages stay alive
        while other slots (or the index, for re-use) reference them;
        pages whose refcount hits zero return to the free list and
        leave the prefix index."""
        pages = self._slot_pages.pop(slot, None)
        if pages is None:
            return 0
        freed = 0
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] <= 0:
                del self._ref[p]
                h = self._page_prefix.pop(p, None)
                if h is not None and self._prefix.get(h) == p:
                    del self._prefix[h]
                self._free.append(p)
                freed += 1
        return freed

    def slot_pages(self, slot):
        return list(self._slot_pages.get(slot, ()))

    def holds(self, slot):
        return slot in self._slot_pages

    def refcount(self, page):
        return self._ref.get(page, 0)

    def check_leaks(self):
        """Invariant: every non-free page is referenced by some slot.
        Returns the orphaned pages (must be empty — the leak
        regression contract)."""
        held = set()
        for pages in self._slot_pages.values():
            held.update(pages)
        return sorted(p for p in self._ref if p not in held)

    def stats(self):
        return {"pages_in_use": self.pages_in_use(),
                "pages_free": self.free_pages(),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses}


class PagedKVCacheStore:
    """Names, declares, and initializes the paged pool variables shared
    by the prefill, decode and verify programs of one decoder.

    Per layer and kind the pool is ``[P, H, page_size, D]`` plus, under
    ``kv_dtype='int8'``, a ``[P, H, page_size]`` float32 scale pool (one
    abs-max scale a token row).  ``bytes()`` is the whole pool,
    ``bytes_per_session(len)`` what one session pins."""

    def __init__(self, n_layer, slots, n_head, max_len, head_dim,
                 num_pages, page_size=16, dtype="float32",
                 kv_dtype=None, prefix="declm"):
        self.n_layer = int(n_layer)
        self.slots = int(slots)
        self.n_head = int(n_head)
        self.max_len = int(max_len)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        if self.max_len % self.page_size:
            raise ValueError(
                "max_len %d is not page-aligned (page_size %d)"
                % (self.max_len, self.page_size))
        self.dtype = dtype
        self.kv_dtype = kv_dtype or dtype
        self.quantized = str(self.kv_dtype) == "int8"
        self.prefix = prefix

    @property
    def max_pages_per_slot(self):
        return self.max_len // self.page_size

    @property
    def pool_shape(self):
        return (self.num_pages, self.n_head, self.page_size,
                self.head_dim)

    @property
    def scale_shape(self):
        return (self.num_pages, self.n_head, self.page_size)

    def name(self, kind, layer):
        return "%s_pool_%s_%d" % (self.prefix, kind, layer)

    def scale_name(self, kind, layer):
        return "%s_pool_%s_scale_%d" % (self.prefix, kind, layer)

    def names(self):
        out = [self.name(kind, i) for i in range(self.n_layer)
               for kind in ("k", "v")]
        if self.quantized:
            out += [self.scale_name(kind, i)
                    for i in range(self.n_layer) for kind in ("k", "v")]
        return out

    def declare(self, block, layer):
        """Create (or fetch) this layer's pool (and scale) vars in
        ``block``; returns ``(k_pool, v_pool, k_scale_or_None,
        v_scale_or_None)``."""
        out = []
        for kind in ("k", "v"):
            name = self.name(kind, layer)
            v = block._find_var_recursive(name)
            if v is None:
                v = block.create_var(name=name, shape=self.pool_shape,
                                     dtype=self.kv_dtype,
                                     persistable=True)
            out.append(v)
        for kind in ("k", "v"):
            if not self.quantized:
                out.append(None)
                continue
            name = self.scale_name(kind, layer)
            v = block._find_var_recursive(name)
            if v is None:
                v = block.create_var(name=name, shape=self.scale_shape,
                                     dtype="float32", persistable=True)
            out.append(v)
        return out

    def init_scope(self, scope, device):
        """Zero pools (and unit scales) on ``device``."""
        for i in range(self.n_layer):
            for kind in ("k", "v"):
                scope.set_var(self.name(kind, i), torch.zeros(
                    self.pool_shape, dtype=convert_dtype(self.kv_dtype),
                    device=device))
                if self.quantized:
                    scope.set_var(self.scale_name(kind, i), torch.ones(
                        self.scale_shape, dtype=torch.float32,
                        device=device))

    def make_allocator(self):
        return PageAllocator(self.num_pages, self.page_size)

    def bytes(self):
        """The whole pool (every layer, K and V, scales included)."""
        n = 2 * self.n_layer * _numel(self.pool_shape) \
            * _itemsize(self.kv_dtype)
        if self.quantized:
            n += 2 * self.n_layer * _numel(self.scale_shape) * 4
        return n

    def bytes_per_page(self):
        n = 2 * self.n_layer * self.n_head * self.page_size \
            * self.head_dim * _itemsize(self.kv_dtype)
        if self.quantized:
            n += 2 * self.n_layer * self.n_head * self.page_size * 4
        return n

    def bytes_per_session(self, seq_len):
        """What one session of ``seq_len`` tokens pins (against the fixed
        region's ``bytes() / slots``)."""
        return self.bytes_per_page() * -(-int(seq_len) // self.page_size)
