"""Decoder-LM programs for the serving engine's prefill/decode
split (counterpart of ``paddle_tpu/serving/decoder.py``).

Programs over one parameter set (every parameter name is explicit, so
they share weights through the engine's scope):

* ``score``   — full causal forward, logits [B, T, V]: the decode loop's
  parity oracle;
* ``prefill`` — score plus per-layer cache writes at the admitted slots
  (scattered write path);
* ``decode``  — one token over every cache slot, logits [S, 1, V]
  (identity write path), attending the cache with ``Tq = 1``;
* ``verify``  — with ``spec_k``: the decode step with a ``spec_k``-token
  suffix query, for speculative decoding.

The cache is the fixed region (``kv_cache_write``, attention over the
cache vars) or, with ``paged=True``, a pool of pages
(``kv_cache_paged_write`` and ``paged_attention`` through a ``page_table``
feed), float or int8 (``kv_dtype``).  The architecture is a post-norm
decoder-only Transformer (the ``models/transformer.py`` decoder without
cross-attention), dropout-free.  The programs are op for op, name for
name, those of the JAX package's ``build_decoder_lm``;
``DecoderSpec.quantize`` rewrites all of them to int8 weights.
"""

from .. import layers, unique_name
from ..framework import Parameter, Program, program_guard
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .kv_cache import KVCacheStore, PagedKVCacheStore

__all__ = ["DecoderSpec", "build_decoder_lm", "sync_draft_weights"]


def sync_draft_weights(scope, target, draft):
    """Copy the target spec's parameters onto the draft spec's names in
    ``scope`` (matched by the stripped prefix: both models share the
    architecture).  The self-draft setup: a draft carrying the target's
    weights proposes the target's own greedy tokens (the perfect-draft
    rig), so speculative acceptance stays high.  Returns the number of
    parameters copied."""
    tp = target.cache.prefix + "_"
    dp = draft.cache.prefix + "_"
    copied = 0
    for v in target.score_program.list_vars():
        if not isinstance(v, Parameter) or not v.name.startswith(tp):
            continue
        dst = dp + v.name[len(tp):]
        src = scope.find_var(v.name)
        if src is None or not draft.score_program.global_block() \
                .has_var(dst):
            continue
        scope.set_var(dst, src.clone())
        copied += 1
    if not copied:
        raise ValueError(
            "no parameters copied — do the specs share an architecture "
            "(prefixes %r -> %r)?" % (target.cache.prefix,
                                      draft.cache.prefix))
    return copied


def _fc(x, size, name, act=None, bias=True):
    return layers.fc(
        x, size=size, num_flatten_dims=2, act=act,
        param_attr=ParamAttr(name=name + ".w_0"),
        bias_attr=ParamAttr(name=name + ".b_0") if bias else False,
        name=name)


def _ln(x, name):
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=name + ".scale"),
        bias_attr=ParamAttr(name=name + ".bias"))


def _split_heads(x, n_head, d_head):
    r = layers.reshape(x, shape=[0, 0, n_head, d_head])
    return layers.transpose(r, perm=[0, 2, 1, 3])


def _merge_heads(x, d_model):
    r = layers.transpose(x, perm=[0, 2, 1, 3])
    return layers.reshape(r, shape=[0, 0, d_model])


class DecoderSpec:
    """The built program bundle the engine runs.  ``slots`` is the fixed
    decode batch (cache rows)."""

    def __init__(self, vocab_size, max_len, slots, n_layer, n_head,
                 d_model, d_inner, cache, programs, startup, spec_k=None):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.slots = slots
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_model = d_model
        self.d_inner = d_inner
        self.cache = cache
        self.score_program, self.score_logits = programs["score"]
        self.prefill_program, self.prefill_logits = programs["prefill"]
        self.decode_program, self.decode_logits = programs["decode"]
        # the speculative verify step (only when built with spec_k)
        self.verify_program, self.verify_logits = programs.get(
            "verify", (None, None))
        self.spec_k = spec_k
        self.startup_program = startup

    @property
    def paged(self):
        return isinstance(self.cache, PagedKVCacheStore)

    def init_scope(self, executor, scope):
        """Run the startup program (parameter init) and zero the cache
        into ``scope``, on the executor's device."""
        executor.run(self.startup_program, scope=scope)
        self.cache.init_scope(scope, executor.place.device)

    def quantize(self, scope, mode="weight_only", weight_bits=8):
        """Return a new spec whose programs run int8 weights
        (``transpiler.quantize_inference`` over the SHARED ``scope``: the
        programs name the same parameters, so each weight quantizes once
        and every program reads the same ``@INT8`` persistables).  Call
        after ``init_scope``: the pass reads the weights' values."""
        from ..transpiler.quantize_pass import quantize_inference

        triple = [("score", self.score_program, self.score_logits),
                  ("prefill", self.prefill_program, self.prefill_logits),
                  ("decode", self.decode_program, self.decode_logits)]
        if self.verify_program is not None:
            triple.append(("verify", self.verify_program,
                           self.verify_logits))
        programs = {}
        for i, (name, prog, logits) in enumerate(triple):
            # the first rewrite quantizes the shared weights; the later
            # programs reuse the scope values instead of re-quantizing
            q = quantize_inference(prog, scope=scope, mode=mode,
                                   weight_bits=weight_bits,
                                   reuse_existing=(i > 0))
            programs[name] = (q, q.global_block().var(logits.name))
        return DecoderSpec(self.vocab_size, self.max_len, self.slots,
                           self.n_layer, self.n_head, self.d_model,
                           self.d_inner, self.cache, programs,
                           self.startup_program, spec_k=self.spec_k)


def _layer_stack(x, klen_var, spec_dims, prefix, cache=None, slot_var=None,
                 wpos_var=None, decode=False, table_var=None):
    """The shared decoder trunk.  ``cache`` set => write each layer's K/V;
    ``decode`` => attend over the cache instead of the local K/V (``Tq``
    may exceed 1: the verify program's suffix query).  A paged cache
    writes through ``kv_cache_paged_write`` against ``table_var`` and
    attends through ``paged_attention`` (int8 pools with their scale
    vars)."""
    n_layer, n_head, d_model, d_inner = spec_dims
    d_head = d_model // n_head
    paged = isinstance(cache, PagedKVCacheStore)
    for i in range(n_layer):
        base = "%s_l%d" % (prefix, i)
        q = _split_heads(_fc(x, d_model, base + "_q", bias=False),
                         n_head, d_head)
        k = _split_heads(_fc(x, d_model, base + "_k", bias=False),
                         n_head, d_head)
        v = _split_heads(_fc(x, d_model, base + "_v", bias=False),
                         n_head, d_head)
        if cache is not None and paged:
            k_pool, v_pool, k_scale, v_scale = cache.declare(
                x.block.program.global_block(), i)
            helper = LayerHelper("kv_cache_paged_write")
            for c, sc, new in ((k_pool, k_scale, k), (v_pool, v_scale, v)):
                inputs = {"Cache": [c], "X": [new], "Pos": [wpos_var],
                          "PageTable": [table_var]}
                outputs = {"Out": [c]}
                if slot_var is not None:
                    inputs["Slot"] = [slot_var]
                if sc is not None:
                    inputs["Scale"] = [sc]
                    outputs["OutScale"] = [sc]
                helper.append_op(type="kv_cache_paged_write",
                                 inputs=inputs, outputs=outputs)
            if decode:
                ctx = layers.paged_attention(
                    q, k_pool, v_pool, table_var, k_len=klen_var,
                    k_scale=k_scale, v_scale=v_scale, causal=True,
                    scale=d_head ** -0.5)
            else:
                ctx = layers.fused_attention(
                    q, k, v, k_len=klen_var, causal=True, is_test=True,
                    scale=d_head ** -0.5)
        else:
            if cache is not None:
                cache_k, cache_v = cache.declare(
                    x.block.program.global_block(), i)
                helper = LayerHelper("kv_cache_write")
                for c, new in ((cache_k, k), (cache_v, v)):
                    inputs = {"Cache": [c], "X": [new], "Pos": [wpos_var]}
                    if slot_var is not None:
                        inputs["Slot"] = [slot_var]
                    helper.append_op(type="kv_cache_write", inputs=inputs,
                                     outputs={"Out": [c]})
                if decode:
                    k, v = cache_k, cache_v
            ctx = layers.fused_attention(
                q, k, v, k_len=klen_var, causal=True, is_test=True,
                scale=d_head ** -0.5)
        o = _fc(_merge_heads(ctx, d_model), d_model, base + "_o",
                bias=False)
        x = _ln(layers.elementwise_add(x, o), base + "_ln1")
        h = _fc(x, d_inner, base + "_fc1", act="relu")
        h = _fc(h, d_model, base + "_fc2")
        x = _ln(layers.elementwise_add(x, h), base + "_ln2")
    return x


def _embed(tok, pos, vocab_size, max_len, d_model, prefix):
    emb = layers.embedding(
        tok, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=prefix + "_tok_emb"))
    pos_e = layers.embedding(
        pos, size=[max_len, d_model],
        param_attr=ParamAttr(name=prefix + "_pos_emb"))
    return layers.elementwise_add(emb, pos_e)


def build_decoder_lm(vocab_size, max_len, slots, n_layer=2, n_head=2,
                     d_model=32, d_inner=64, dtype="float32",
                     prefix="declm", seed=7, paged=False, page_size=16,
                     num_pages=None, kv_dtype=None, spec_k=None):
    """Build the score/prefill/decode programs plus one startup program;
    returns a :class:`DecoderSpec`.

    ``paged=True`` swaps the fixed region for a
    :class:`~.kv_cache.PagedKVCacheStore` pool of ``num_pages`` pages of
    ``page_size`` tokens (default: the fixed region's footprint; a smaller
    pool makes admission gate on free pages).  ``kv_dtype='int8'``
    quantizes the pool a token row at a time (float32 scale pools beside
    it; paged only).  ``spec_k`` also builds the ``verify`` program, the
    ``spec_k``-token decode step of speculative decoding."""
    if paged:
        if num_pages is None:
            num_pages = slots * (max_len // page_size)
        cache = PagedKVCacheStore(
            n_layer, slots, n_head, max_len, d_model // n_head,
            num_pages=num_pages, page_size=page_size, dtype=dtype,
            kv_dtype=kv_dtype, prefix=prefix)
    else:
        if kv_dtype not in (None, dtype):
            raise ValueError(
                "kv_dtype %r needs paged=True (the fixed-region cache "
                "has no scale storage)" % (kv_dtype,))
        cache = KVCacheStore(n_layer, slots, n_head, max_len,
                             d_model // n_head, dtype=dtype,
                             prefix=prefix)
    dims = (n_layer, n_head, d_model, d_inner)
    startup = Program()
    startup.random_seed = seed
    programs = {}

    def _table_feed():
        # the page table is data the host allocator owns, fed whole every
        # dispatch: [slots, max_pages] int32, one shape, one signature
        return layers.data(
            "page_table", shape=[slots, cache.max_pages_per_slot],
            append_batch_size=False, dtype="int32")

    # -- score: full causal forward -----------------------------------
    score = Program()
    score.random_seed = seed
    with program_guard(score, startup), unique_name.guard(prefix + "_s_"):
        tok = layers.data("tok", shape=[1], dtype="int64", lod_level=1)
        pos = layers.data("pos", shape=[-1, -1, 1],
                          append_batch_size=False, dtype="int64")
        klen = tok.block._find_var_recursive(tok._seq_len_name)
        x = _embed(tok, pos, vocab_size, max_len, d_model, prefix)
        x = _layer_stack(x, klen, dims, prefix)
        logits = _fc(x, vocab_size, prefix + "_logits")
        programs["score"] = (score, logits)

    # -- prefill: score + scattered cache writes ----------------------
    # (its own startup: the parameters already exist in `startup`)
    prefill = Program()
    prefill.random_seed = seed
    with program_guard(prefill, Program()), \
            unique_name.guard(prefix + "_p_"):
        tok = layers.data("tok", shape=[1], dtype="int64", lod_level=1)
        pos = layers.data("pos", shape=[-1, -1, 1],
                          append_batch_size=False, dtype="int64")
        slot = layers.data("slot", shape=[-1], append_batch_size=False,
                           dtype="int32")
        wpos = layers.data("wpos", shape=[-1], append_batch_size=False,
                           dtype="int32")
        table = _table_feed() if paged else None
        klen = tok.block._find_var_recursive(tok._seq_len_name)
        x = _embed(tok, pos, vocab_size, max_len, d_model, prefix)
        x = _layer_stack(x, klen, dims, prefix, cache=cache,
                         slot_var=slot, wpos_var=wpos, table_var=table)
        logits = _fc(x, vocab_size, prefix + "_logits")
        programs["prefill"] = (prefill, logits)

    # -- decode: one token over every slot, cache-attending ------------
    decode = Program()
    decode.random_seed = seed
    with program_guard(decode, Program()), \
            unique_name.guard(prefix + "_d_"):
        tok = layers.data("tok", shape=[-1, 1, 1],
                          append_batch_size=False, dtype="int64")
        pos = layers.data("pos", shape=[-1, 1, 1],
                          append_batch_size=False, dtype="int64")
        wpos = layers.data("wpos", shape=[-1], append_batch_size=False,
                           dtype="int32")
        cache_len = layers.data("cache_len", shape=[-1],
                                append_batch_size=False, dtype="int32")
        table = _table_feed() if paged else None
        x = _embed(tok, pos, vocab_size, max_len, d_model, prefix)
        x = _layer_stack(x, cache_len, dims, prefix, cache=cache,
                         wpos_var=wpos, decode=True, table_var=table)
        logits = _fc(x, vocab_size, prefix + "_logits")
        programs["decode"] = (decode, logits)

    # -- verify: the spec_k-token decode step (speculative decoding) ---
    # Feeds [last accepted, d_1..d_{k-1}] a slot at positions
    # pos..pos+k-1; query i sits bottom-aligned at cache_len - k + i, so
    # the argmax of logits[:, i] is the target's next token after draft
    # token i.  Acceptance is a host-side prefix match; rejected
    # positions stay past the slot's cache_len, masked, and the next
    # write overwrites them.
    if spec_k is not None:
        if spec_k < 2:
            raise ValueError("spec_k must be >= 2 (k-1 draft tokens + "
                             "the accepted anchor), got %r" % (spec_k,))
        verify = Program()
        verify.random_seed = seed
        with program_guard(verify, Program()), \
                unique_name.guard(prefix + "_v_"):
            tok = layers.data("tok", shape=[-1, spec_k, 1],
                              append_batch_size=False, dtype="int64")
            pos = layers.data("pos", shape=[-1, spec_k, 1],
                              append_batch_size=False, dtype="int64")
            wpos = layers.data("wpos", shape=[-1],
                               append_batch_size=False, dtype="int32")
            cache_len = layers.data("cache_len", shape=[-1],
                                    append_batch_size=False,
                                    dtype="int32")
            table = _table_feed() if paged else None
            x = _embed(tok, pos, vocab_size, max_len, d_model, prefix)
            x = _layer_stack(x, cache_len, dims, prefix, cache=cache,
                             wpos_var=wpos, decode=True, table_var=table)
            logits = _fc(x, vocab_size, prefix + "_logits")
            programs["verify"] = (verify, logits)

    return DecoderSpec(vocab_size, max_len, slots, n_layer, n_head,
                       d_model, d_inner, cache, programs, startup,
                       spec_k=spec_k)
