"""Decoder-LM programs for the serving engine's prefill/decode
split (counterpart of ``paddle_tpu/serving/decoder.py``, fixed-region
cache only).

Three programs over one parameter set (every parameter name is explicit,
so they share weights through the engine's scope):

* ``score``   — full causal forward, logits [B, T, V]: the decode loop's
  parity oracle;
* ``prefill`` — score plus per-layer ``kv_cache_write`` at the admitted
  slots (scattered write path);
* ``decode``  — one token over every cache slot, logits [S, 1, V]
  (identity write path), attending the cache with ``Tq = 1``.

The architecture is a post-norm decoder-only Transformer (the
``models/transformer.py`` decoder without cross-attention), dropout-free.
The programs are op for op, name for name, those of the JAX package's
``build_decoder_lm``; ``DecoderSpec.quantize`` rewrites all three to int8
weights.
"""

from .. import layers, unique_name
from ..framework import Program, program_guard
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .kv_cache import KVCacheStore

__all__ = ["DecoderSpec", "build_decoder_lm"]


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
                 d_model, d_inner, cache, programs, startup):
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
        self.startup_program = startup

    def init_scope(self, executor, scope):
        """Run the startup program (parameter init) and zero the cache
        into ``scope``, on the executor's device."""
        executor.run(self.startup_program, scope=scope)
        self.cache.init_scope(scope, executor.place.device)

    def quantize(self, scope, mode="weight_only", weight_bits=8):
        """Return a new spec whose score/prefill/decode programs run int8
        weights (``transpiler.quantize_inference`` over the SHARED
        ``scope``: the three programs name the same parameters, so each
        weight quantizes once and every program reads the same ``@INT8``
        persistables).  Call after ``init_scope``: the pass reads the
        weights' values."""
        from ..transpiler.quantize_pass import quantize_inference

        triple = [("score", self.score_program, self.score_logits),
                  ("prefill", self.prefill_program, self.prefill_logits),
                  ("decode", self.decode_program, self.decode_logits)]
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
                           self.startup_program)


def _layer_stack(x, klen_var, spec_dims, prefix, cache=None, slot_var=None,
                 wpos_var=None, decode=False):
    """The shared decoder trunk.  ``cache`` set => write each layer's K/V;
    ``decode`` => attend over the cache vars instead of the local K/V."""
    n_layer, n_head, d_model, d_inner = spec_dims
    d_head = d_model // n_head
    for i in range(n_layer):
        base = "%s_l%d" % (prefix, i)
        q = _split_heads(_fc(x, d_model, base + "_q", bias=False),
                         n_head, d_head)
        k = _split_heads(_fc(x, d_model, base + "_k", bias=False),
                         n_head, d_head)
        v = _split_heads(_fc(x, d_model, base + "_v", bias=False),
                         n_head, d_head)
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
    """Build the score/prefill/decode program triple plus one startup
    program; returns a :class:`DecoderSpec`.  The paged cache
    (``paged``, ``page_size``, ``num_pages``), quantized KV (``kv_dtype``)
    and speculative verify (``spec_k``) are not ported yet."""
    if paged or kv_dtype not in (None, dtype) or spec_k is not None:
        raise NotImplementedError(
            "paged KV, kv_dtype and spec_k are not ported yet: "
            "paddle_tpu_torch serves with the fixed-region cache only")
    cache = KVCacheStore(n_layer, slots, n_head, max_len, d_model // n_head,
                         dtype=dtype, prefix=prefix)
    dims = (n_layer, n_head, d_model, d_inner)
    startup = Program()
    startup.random_seed = seed
    programs = {}

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
        klen = tok.block._find_var_recursive(tok._seq_len_name)
        x = _embed(tok, pos, vocab_size, max_len, d_model, prefix)
        x = _layer_stack(x, klen, dims, prefix, cache=cache,
                         slot_var=slot, wpos_var=wpos)
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
        x = _embed(tok, pos, vocab_size, max_len, d_model, prefix)
        x = _layer_stack(x, cache_len, dims, prefix, cache=cache,
                         wpos_var=wpos, decode=True)
        logits = _fc(x, vocab_size, prefix + "_logits")
        programs["decode"] = (decode, logits)

    return DecoderSpec(vocab_size, max_len, slots, n_layer, n_head,
                       d_model, d_inner, cache, programs, startup)
