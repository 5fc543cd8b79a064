"""The port's paged KV cache held against the JAX package on the CPU.

* ``PageAllocator``: the same operation sequences through the JAX
  allocator and the port's give the same pages, refcounts, prefix hits,
  copy-on-write splits and exhaustion behaviour;
* the scheduler's admission gate keeps a refused request queued;
* ``PagedKVCacheStore``: names, shapes and byte counts equal the JAX
  store's;
* ``kv_cache_paged_write`` against the JAX op bit for bit, float32 and
  int8 (values and scales): scattered prefill, identity decode and the
  verify's k-token write, sentinel table entries dropped, pages outside
  the write unchanged;
* ``paged_attention`` against the JAX op (its Pallas kernel in interpret
  mode and its XLA reference) within ``TOL``;
* the decode and prefill programs with a paged cache, float32 and int8,
  serialize like the JAX builder's;
* the paged engine: greedy tokens equal the fixed-region engine's and the
  JAX paged engine's (weights carried across), int8 KV within the int8
  band, pool exhaustion queues and completes, and every terminal path
  (timeout mid-decode, a failed dispatch, non-finite logits, close) frees
  the request's pages; no paged op reads a value on the host.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.ops import kv_cache as jax_kv
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu.serving import build_decoder_lm as jax_build_decoder_lm
from paddle_tpu.serving import kv_cache as jax_kv_cache

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.ops import attention as pt_attention
from paddle_tpu_torch.ops import kv_cache as pt_kv
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      GenerationEngine, OutOfPagesError,
                                      PageAllocator, PagedKVCacheStore,
                                      build_decoder_lm)
from paddle_tpu_torch.serving.scheduler import RequestTimeoutError

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_serving import params_from_jax_scope

# bench.py's small decode_paged rung: 2 layers, d_model 32, vocab 61
DIMS = dict(n_layer=2, n_head=2, d_model=32, d_inner=64)
LM = dict(vocab_size=61, max_len=32, slots=4, **DIMS)
PS = 8
# float32 attention: both sides sum a few dozen terms in other orders
TOL = dict(rtol=1e-5, atol=1e-5)
INT8_BAND = 0.02          # relative L1, the int8 accuracy budget


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """Fresh port default programs, scope and name counter a test."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def rel_l1(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).sum() / (np.abs(ref).sum() + 1e-12))


# ---------------------------------------------------------------------------
# the allocator, driven alike through both packages
# ---------------------------------------------------------------------------

SYSTEM = [7, 7, 3, 9]

ALLOC_SEQUENCES = {
    "refcount_release": (8, 4, [
        ("alloc", 0, [1, 2, 3, 4, 5], 3), ("release", 0),
        ("release", 0)]),
    "extend": (4, 4, [("alloc", 0, [1, 2], 0), ("extend", 0, 2),
                      ("extend", 0, 2)]),
    "prefix_sharing": (8, 4, [
        ("alloc", 0, SYSTEM + [1], 0), ("alloc", 1, SYSTEM + [2], 0),
        ("release", 0), ("release", 1)]),
    "chain_hash": (16, 4, [
        ("alloc", 0, [1, 1, 1, 1, 5, 6, 7, 8], 0),
        ("alloc", 1, [2, 2, 2, 2, 5, 6, 7, 8], 0),
        ("alloc", 2, [1, 1, 1, 1, 5, 6, 7, 8, 9], 2)]),
    "cow_split": (8, 4, [
        ("alloc", 0, SYSTEM, 4), ("alloc", 1, SYSTEM, 4),
        ("cow", 1, 0), ("cow", 0, 0), ("release", 0), ("release", 1)]),
    "exhaustion": (3, 4, [
        ("alloc", 0, [1, 2, 3, 4, 5], 0), ("alloc", 1, [9] * 6, 4),
        ("alloc", 1, [9] * 3, 1), ("extend", 1, 1)]),
    "index_dies_with_page": (4, 4, [
        ("alloc", 0, SYSTEM, 0), ("release", 0), ("alloc", 1, SYSTEM, 0),
        ("release", 1)]),
    "slot_held_twice": (4, 4, [("alloc", 0, [1], 0),
                               ("alloc", 0, [2], 0)]),
}


def _random_sequence(seed, n_ops=60):
    """A seeded mix of every operation over a small pool (4 slots, prompts
    over a 3-token alphabet so that prefixes collide)."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["alloc", "alloc", "release", "extend", "cow",
                           "admit"])
        slot = int(rng.randint(0, 4))
        if kind in ("alloc", "admit"):
            prompt = list(rng.randint(0, 3, rng.randint(1, 14)))
            ops.append((kind, slot, prompt, int(rng.randint(0, 6))))
        elif kind == "extend":
            ops.append((kind, slot, 1))
        elif kind == "cow":
            ops.append((kind, slot, int(rng.randint(0, 3))))
        else:
            ops.append((kind, slot))
    return 12, 4, ops


def _drive(alloc_cls, error_cls, num_pages, page_size, ops):
    """The transcript of ``ops`` on a fresh allocator: each result (or the
    error's kind) and the whole state after it."""
    a = alloc_cls(num_pages, page_size)
    out = [("needed", [a.pages_needed(n, m) for n in (1, 8, 9)
                       for m in (0, 1, 7, 8)])]
    for op in ops:
        kind, slot = op[0], op[1]
        try:
            if kind == "alloc":
                res = a.alloc_for_prompt(slot, op[2], op[3])
            elif kind == "admit":
                res = a.can_admit(len(op[2]), op[3], op[2])
            elif kind == "release":
                res = a.release(slot)
            elif kind == "extend":
                res = list(a.extend(slot, op[2]))
            else:
                res = a.cow_split(slot, op[2])
        except error_cls as e:
            res = ("OutOfPages", str(e))
        except (KeyError, IndexError) as e:
            res = (type(e).__name__,)
        except ValueError as e:
            res = ("ValueError", str(e))
        state = (a.stats(), a.check_leaks(),
                 {s: a.slot_pages(s) for s in range(4)},
                 {p: a.refcount(p) for p in range(num_pages)},
                 a.free_pages(), a.pages_in_use())
        out.append((kind, res, state))
    return out


@pytest.mark.parametrize("name", sorted(ALLOC_SEQUENCES) + ["random0",
                                                           "random1",
                                                           "random2"])
def test_allocator_transcript_equals_jax(name):
    if name.startswith("random"):
        num_pages, page_size, ops = _random_sequence(int(name[-1]))
    else:
        num_pages, page_size, ops = ALLOC_SEQUENCES[name]
    want = _drive(jax_kv_cache.PageAllocator,
                  jax_kv_cache.OutOfPagesError, num_pages, page_size, ops)
    got = _drive(PageAllocator, OutOfPagesError, num_pages, page_size, ops)
    assert got == want


def test_allocator_contracts():
    """The JAX tests' own assertions, on the port's allocator."""
    a = PageAllocator(num_pages=8, page_size=4)
    p0, s0 = a.alloc_for_prompt(0, SYSTEM + [1], max_new=0)
    p1, s1 = a.alloc_for_prompt(1, SYSTEM + [2], max_new=0)
    assert (s0, s1) == (0, 1) and p1[0] == p0[0] and p1[1] != p0[1]
    assert a.refcount(p0[0]) == 2 and a.prefix_hits == 1
    a.release(0)
    assert a.refcount(p1[0]) == 1 and a.holds(1) and not a.holds(0)
    a.release(1)
    assert a.pages_in_use() == 0 and a.check_leaks() == []
    b = PageAllocator(num_pages=3, page_size=4)
    b.alloc_for_prompt(0, [1, 2, 3, 4, 5], max_new=0)
    with pytest.raises(OutOfPagesError):
        b.alloc_for_prompt(1, [9] * 6, max_new=4)
    assert b.free_pages() == 1 and b.slot_pages(1) == []
    with pytest.raises(ValueError):
        PageAllocator(0, 4)


def test_admission_gate_keeps_refused_requests_queued():
    clock = [0.0]
    capacity = {"free": 2}

    def gate(req, picked):
        return len(picked) + 1 <= capacity["free"]

    s = ContinuousBatchingScheduler(4, clock=lambda: clock[0],
                                    admission_gate=gate)
    reqs = [s.submit(i) for i in range(4)]
    plan, _ = s.admit()
    assert [r.id for r in plan.requests] == [reqs[0].id, reqs[1].id]
    assert s.queue_depth() == 2
    assert reqs[2].status == "queued" and reqs[3].status == "queued"
    for r in plan.requests:
        s.complete(r, None)
    plan2, _ = s.admit()
    assert [r.id for r in plan2.requests] == [reqs[2].id, reqs[3].id]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_store_matches_jax(kv_dtype):
    args = (2, 4, 2, 32, 8)
    kw = dict(num_pages=16, page_size=8, kv_dtype=kv_dtype)
    a = jax_kv_cache.PagedKVCacheStore(*args, **kw)
    b = PagedKVCacheStore(*args, **kw)
    for attr in ("pool_shape", "scale_shape", "max_pages_per_slot",
                 "quantized"):
        assert getattr(b, attr) == getattr(a, attr)
    assert b.names() == a.names()
    assert b.bytes() == a.bytes()
    assert b.bytes_per_page() == a.bytes_per_page()
    assert [b.bytes_per_session(n) for n in (1, 8, 9, 32)] == \
        [a.bytes_per_session(n) for n in (1, 8, 9, 32)]
    scope = pt.Scope()
    b.init_scope(scope, torch.device("cpu"))
    for n in b.names():
        v = scope.find_var(n)
        assert v.dtype == (torch.int8 if kv_dtype and "scale" not in n
                           else torch.float32)
    with pytest.raises(ValueError, match="page"):
        PagedKVCacheStore(2, 4, 2, 30, 8, num_pages=16, page_size=8)


# ---------------------------------------------------------------------------
# kv_cache_paged_write against the JAX op, bit for bit
# ---------------------------------------------------------------------------

P, H, D = 6, 2, 8              # pool pages, heads, head dim (ps = 4)
WPS = 4
SENT = P                       # the engine's sentinel: num_pages

# (name, table [S, max_pages], X's (B, t), pos, slot or None)
WRITE_CASES = [
    ("prefill_scattered", [[0, 1, SENT, SENT], [2, 3, SENT, 5],
                           [4, SENT, SENT, SENT]], (2, 8), [0, 0], [1, 2]),
    ("prefill_identity", [[0, 1, 2, 3], [4, SENT, SENT, SENT],
                          [5, SENT, 1, 2]], (3, 8), [0, 0, 0], None),
    # the engine's padding rows repeat row 0, slot and content alike
    ("prefill_duplicate_rows", [[0, 1, 2, SENT], [3, 4, SENT, SENT],
                                [5, SENT, SENT, SENT]], (3, 8), [0, 0, 0],
     [1, 1, 1]),
    ("decode_identity", [[0, 1, 2, 3], [SENT] * 4, [4, 5, SENT, SENT]],
     (3, 1), [13, 0, 6], None),
    ("decode_all_dropped", [[SENT] * 4] * 3, (3, 1), [2, 0, 9], None),
    ("verify_k3_straddles_pages", [[0, 1, 2, 3], [4, 5, SENT, SENT],
                                   [SENT] * 4], (3, 3), [3, 6, 0], None),
    ("verify_k3_into_sentinel", [[0, 1, SENT, SENT], [2, 3, 4, 5],
                                 [SENT] * 4], (3, 3), [7, 14, 1], None),
    # a negative page id counts from the end once, as numpy indexing does
    # before XLA's drop; -P-1 stays out of range and drops
    ("decode_negative_entries", [[-1, 0, 1, 2], [-P - 1, 3, 4, 5],
                                 [4, 5, 0, 1]], (3, 1), [1, 0, 3], None),
]


def _write_inputs(case, quantized, seed=0):
    name, table, (b, t), pos, slot = case
    rng = np.random.RandomState(seed)
    if quantized:
        cache = rng.randint(-127, 128, (P, H, WPS, D)).astype("int8")
        scale = rng.rand(P, H, WPS).astype("float32")
    else:
        cache = rng.randn(P, H, WPS, D).astype("float32")
        scale = None
    x = rng.randn(b, H, t, D).astype("float32")
    if name == "prefill_duplicate_rows":
        x[1:] = x[0]
    ins = {"Cache": cache, "X": x, "Pos": np.asarray(pos, "int32"),
           "PageTable": np.asarray(table, "int32")}
    if slot is not None:
        ins["Slot"] = np.asarray(slot, "int32")
    if scale is not None:
        ins["Scale"] = scale
    return ins


def _jax_write(ins):
    """The JAX op as its programs run it: jitted."""
    names = sorted(ins)

    def write(*vals):
        return jax_kv._paged_write_compute(
            {k: [v] for k, v in zip(names, vals)}, {}, None, 0)

    out = jax.jit(write)(*[jnp.asarray(ins[k]) for k in names])
    return {k: np.asarray(v) for k, v in out.items()}


def _port_write(ins):
    out = pt_kv._paged_write_compute(
        {k: [torch.from_numpy(v.copy())] for k, v in ins.items()}, {},
        None, 0)
    return {k: v.numpy() for k, v in out.items()}


def _kept_pages(ins):
    """The pool pages a write may touch: the table entries it reads that
    name a page (after one wrap)."""
    table = ins["PageTable"].astype(np.int64)
    table = np.where(table < 0, table + P, table)
    return {int(p) for p in table.reshape(-1) if 0 <= p < P}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", WRITE_CASES, ids=[c[0] for c in WRITE_CASES])
def test_paged_write_bitwise_jax(case, quantized):
    ins = _write_inputs(case, quantized)
    want = _jax_write(ins)
    got = _port_write(ins)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the pages no table entry names keep their bits
    untouched = sorted(set(range(P)) - _kept_pages(ins))
    np.testing.assert_array_equal(got["Out"][untouched],
                                  ins["Cache"][untouched])
    if case[0] == "decode_all_dropped":
        np.testing.assert_array_equal(got["Out"], ins["Cache"])


def test_quantize_rows_bitwise_jax():
    """Half to even at exact ties (x / scale = k + 0.5 with scale 1), a
    zero row (the 1e-12 floor) and random rows: int8 values and scales
    equal the JAX grid's as its programs compute it (jitted: the scale a
    product with 1 / 127, not a quotient)."""
    rows = [[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
            [0.0] * 8,
            [-127.0, 126.5, 125.5, 0.49999997, -3.5, 4.5, 5.5, -6.5]]
    x = np.concatenate([np.asarray(rows, "float32"),
                        np.random.RandomState(3).randn(29, 8)
                        .astype("float32") * 3]).reshape(2, 2, 8, 8)
    jq, js = jax.jit(jax_kv._quantize_rows)(jnp.asarray(x))
    tq, ts = pt_kv._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tq.numpy()[0, 0, 0]) == [127, 0, 2, 2, 0, -2, -2, 4]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_write_program_bitwise_jax(quantized):
    """A one-op ``kv_cache_paged_write`` program through both executors:
    the serialized programs and the pool (and scales) after the run."""
    case = WRITE_CASES[0]
    ins = _write_inputs(case, quantized, seed=5)
    results = []
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()), \
                pkg.unique_name.guard("t_"):
            block = main.global_block()
            cache = block.create_var(name="pool", shape=list(ins["Cache"]
                                                             .shape),
                                     dtype=str(ins["Cache"].dtype),
                                     persistable=True)
            inputs = {"Cache": [cache]}
            outputs = {"Out": [cache]}
            for n, slot in (("x", "X"), ("pos", "Pos"),
                            ("page_table", "PageTable"), ("slot", "Slot")):
                inputs[slot] = [pkg.layers.data(
                    n, shape=list(ins[slot].shape), append_batch_size=False,
                    dtype=str(ins[slot].dtype))]
            if quantized:
                sc = block.create_var(name="pool_scale",
                                      shape=list(ins["Scale"].shape),
                                      dtype="float32", persistable=True)
                inputs["Scale"] = [sc]
                outputs["OutScale"] = [sc]
            block.append_op(type="kv_cache_paged_write", inputs=inputs,
                            outputs=outputs)
        state = {"pool": ins["Cache"]}
        if quantized:
            state["pool_scale"] = ins["Scale"]
        feed = {"x": ins["X"], "pos": ins["Pos"],
                "page_table": ins["PageTable"], "slot": ins["Slot"]}
        scope = pkg.Scope()
        if pkg is fluid:
            for n, v in state.items():
                scope.set_var(n, jnp.asarray(v))
        else:
            load_numpy_params(scope, state, "cpu")
        out = pkg.Executor(pkg.CPUPlace()).run(
            main, feed=feed, fetch_list=sorted(state), scope=scope)
        results.append(([np.asarray(o) for o in out], main.to_dict()))
    (want, want_dict), (got, got_dict) = results
    assert got_dict == want_dict
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# paged_attention against the JAX op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("tq", [1, 3], ids=["decode", "verify"])
def test_paged_attention_matches_jax(tq, quantized):
    s, h, d, ps, mp, pages = 3, 2, 16, 4, 4, 10
    rng = np.random.RandomState(tq)
    if quantized:
        kp, vp = (rng.randint(-127, 128, (pages, h, ps, d)).astype("int8")
                  for _ in range(2))
        ks, vs = (rng.rand(pages, h, ps).astype("float32") * 0.05
                  for _ in range(2))
    else:
        kp, vp = (rng.randn(pages, h, ps, d).astype("float32")
                  for _ in range(2))
        ks = vs = None
    # slot 1 holds two pages, the rest of its row the sentinel; slot 2
    # aliases slot 0's first page
    table = np.asarray([[0, 1, 2, 3], [4, 5, pages, pages],
                        [0, 6, 7, pages]], "int32")
    klen = np.asarray([16, 7, 10], "int32")
    q = rng.randn(s, h, tq, d).astype("float32")
    scale = d ** -0.5
    want = {}
    for pallas in (False, True):
        want[pallas] = np.asarray(jfa.paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(klen),
            None if ks is None else jnp.asarray(ks),
            None if vs is None else jnp.asarray(vs),
            causal=True, scale=scale, use_pallas=pallas, interpret=True))
    ins = {"Q": [torch.from_numpy(q)], "KCache": [torch.from_numpy(kp)],
           "VCache": [torch.from_numpy(vp)],
           "PageTable": [torch.from_numpy(table)],
           "KLen": [torch.from_numpy(klen)]}
    if quantized:
        ins["KScale"] = [torch.from_numpy(ks)]
        ins["VScale"] = [torch.from_numpy(vs)]
    got = pt_attention._paged_attention_compute(
        ins, {"causal": True, "scale": scale}, None, 0)["Out"].numpy()
    for pallas in (False, True):
        np.testing.assert_allclose(got, want[pallas], **TOL)
    # the gather itself: each slot's pages, dequantized, bit for bit
    for pool, sc in ((kp, ks), (vp, vs)):
        jg = np.asarray(jfa.gather_pages(
            jnp.asarray(pool), jnp.asarray(table),
            None if sc is None else jnp.asarray(sc)))
        tg = pt_attention.gather_pages(
            torch.from_numpy(pool), torch.from_numpy(table),
            None if sc is None else torch.from_numpy(sc)).numpy()
        np.testing.assert_array_equal(tg, jg)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

PROGRAM_CONFIGS = {
    "paged_f32": dict(paged=True, page_size=PS),
    "paged_int8": dict(paged=True, page_size=PS, kv_dtype="int8"),
    "paged_small_pool": dict(paged=True, page_size=4, num_pages=5),
}


@pytest.mark.parametrize("program", ["score", "prefill", "decode",
                                     "startup"])
@pytest.mark.parametrize("config", sorted(PROGRAM_CONFIGS))
def test_paged_programs_serialize_like_jax(config, program):
    kw = dict(LM, **PROGRAM_CONFIGS[config])
    a = getattr(jax_build_decoder_lm(**kw), program + "_program")
    b = getattr(build_decoder_lm(**kw), program + "_program")
    assert b.to_dict() == a.to_dict()
    assert b.to_json() == a.to_json()


def test_kv_dtype_needs_paged():
    with pytest.raises(ValueError, match="paged=True"):
        build_decoder_lm(**LM, kv_dtype="int8")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SYS_PROMPT = list(range(2, 2 + PS))              # one full page
PROMPTS = [[3, 5, 7], [2, 9, 4, 6, 8], [1, 2], SYS_PROMPT + [11],
           SYS_PROMPT + [12, 13], SYS_PROMPT + [14]]


def _jax_weights(**kw):
    spec = jax_build_decoder_lm(**kw)
    scope = fluid.Scope()
    spec.init_scope(fluid.Executor(fluid.CPUPlace()), scope)
    return spec, scope, params_from_jax_scope(spec.score_program, scope)


def _serve(spec, params=None, prompts=PROMPTS, max_new=5, **kw):
    eng = GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=max_new,
                           record_logits=True, timeout_s=300.0, start=False,
                           **kw)
    if params is not None:
        load_numpy_params(eng._scope, params, "cpu")
    try:
        eng.start()
        outs = [r.result(300) for r in [eng.submit(p) for p in prompts]]
        return outs, eng
    finally:
        eng.close()


def _entries(exe, program):
    return [k for k in exe._analysis if k[0] == id(program)]


def test_paged_engine_matches_fixed_and_jax_paged():
    """Greedy tokens of the port's paged engine equal the port's
    fixed-region engine's and the JAX paged engine's on the same weights;
    the recorded logits agree with the fixed region's at 2e-4; the prompts
    sharing a system page alias it; one decode entry; nothing leaks."""
    kw = dict(LM, paged=True, page_size=PS)
    jspec, _, params = _jax_weights(**kw)
    jeng = JaxGenerationEngine(jspec, place=fluid.CPUPlace(),
                               max_new_tokens=5, timeout_s=300.0)
    try:
        want = [r.result(600)["tokens"] for r in
                [jeng.submit(p) for p in PROMPTS]]
    finally:
        jeng.close()
    fixed, _ = _serve(build_decoder_lm(**LM), params)
    paged, eng = _serve(build_decoder_lm(**kw), params)
    assert [o["tokens"] for o in paged] == want
    assert [o["tokens"] for o in fixed] == want
    for a, b in zip(paged, fixed):
        for x, y in zip(a["logits"], b["logits"]):
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-4)
    snap = eng.metrics.paged_snapshot()
    assert snap["prefix_hits"] > 0 and snap["prefix_hit_rate"] > 0
    assert eng.metrics.summary()["counts"]["prefix_hits"] == \
        snap["prefix_hits"]
    assert len(_entries(eng._exe, eng.spec.decode_program)) == 1
    assert eng._alloc.check_leaks() == [] and eng._alloc.pages_in_use() == 0
    assert (eng._table == eng.spec.cache.num_pages).all()


def test_int8_kv_engine_within_the_int8_band():
    """int8 KV pages decode end to end on the JAX weights: logits within
    relative L1 0.02 of float32 paged decode, prefix hits logged, nothing
    leaks, the pool a quarter of the float32 bytes plus its scales."""
    kw = dict(LM, paged=True, page_size=PS)
    _, _, params = _jax_weights(**kw)
    f32, _ = _serve(build_decoder_lm(**kw), params)
    q8, eng = _serve(build_decoder_lm(**kw, kv_dtype="int8"), params)
    for a, b in zip(f32, q8):
        assert rel_l1(np.stack(a["logits"]), np.stack(b["logits"])) \
            < INT8_BAND
    assert eng.metrics.paged_snapshot()["prefix_hits"] > 0
    assert eng._alloc.check_leaks() == []
    store = eng.spec.cache
    assert store.quantized
    assert store.bytes() * 4 > build_decoder_lm(**kw).cache.bytes()
    assert store.bytes_per_page() * 2 < \
        build_decoder_lm(**kw).cache.bytes_per_page()


def test_page_exhaustion_queues_and_completes():
    """A pool of two pages: one request at a time passes the gate, the
    others wait queued, and all complete."""
    spec = build_decoder_lm(**dict(LM, slots=2), paged=True, page_size=PS,
                            num_pages=2)
    eng = GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=8,
                           timeout_s=300.0)
    try:
        reqs = [eng.submit([1 + i, 2, 3, 4]) for i in range(3)]
        outs = [r.result(300) for r in reqs]
        assert all(len(o["tokens"]) == 8 for o in outs)
        assert eng._alloc.pages_in_use() == 0
        assert eng._alloc.check_leaks() == []
    finally:
        eng.close()


def _wait_free(eng, deadline_s=30):
    end = time.monotonic() + deadline_s
    while eng._alloc.pages_in_use() and time.monotonic() < end:
        time.sleep(0.02)
    assert eng._alloc.pages_in_use() == 0
    assert eng._alloc.check_leaks() == []
    assert (eng._table == eng.spec.cache.num_pages).all()


def test_timeout_mid_decode_frees_pages():
    """A request evicted mid-decode on its timeout budget frees its pages
    at once (each decode step is slowed down so the budget runs out while
    the request is running)."""
    spec = build_decoder_lm(**dict(LM, max_len=64), paged=True,
                            page_size=PS)
    eng = GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=48,
                           timeout_s=300.0)
    real = eng._decode_step

    def slow_step():
        time.sleep(0.05)
        return real()

    eng._decode_step = slow_step
    try:
        req = eng.submit([1, 2, 3], timeout_s=0.5)
        with pytest.raises(RequestTimeoutError):
            req.result(60)
        assert req.status == "expired"
        _wait_free(eng)
    finally:
        eng.close()


@pytest.mark.parametrize("fault", ["dispatch_error", "non_finite"])
def test_failed_decode_frees_pages(fault):
    """A decode dispatch that raises fails its batch, and non-finite
    logits quarantine the request: both free the pages; the engine keeps
    serving."""
    spec = build_decoder_lm(**LM, paged=True, page_size=PS)
    eng = GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=4,
                           timeout_s=300.0)
    real = eng._run
    armed = [True]

    def faulty(program, feed, logits_var, rows):
        out = real(program, feed, logits_var, rows)
        if program is eng.spec.decode_program and armed[0]:
            armed[0] = False
            if fault == "dispatch_error":
                raise RuntimeError("planted decode failure")
            out = out.copy()
            out[...] = np.nan
        return out

    eng._run = faulty
    try:
        req = eng.submit([1, 2, 3])
        with pytest.raises(Exception):
            req.result(60)
        assert req.status == ("failed" if fault == "dispatch_error"
                              else "quarantined")
        _wait_free(eng)
        assert len(eng.generate([4, 5], timeout=60)["tokens"]) == 4
        _wait_free(eng)
    finally:
        eng.close()


def test_close_frees_in_flight_pages():
    spec = build_decoder_lm(**LM, paged=True, page_size=PS)
    eng = GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=24,
                           timeout_s=300.0)
    real = eng._decode_step

    def slow_step():
        time.sleep(0.05)
        return real()

    eng._decode_step = slow_step
    req = eng.submit([1, 2, 3])
    end = time.monotonic() + 30
    while not eng._alloc.pages_in_use() and time.monotonic() < end:
        time.sleep(0.01)
    eng.close()
    with pytest.raises(Exception):
        req.result(10)
    assert eng._alloc.pages_in_use() == 0
    assert eng._alloc.check_leaks() == []


def test_unaligned_bucket_is_refused():
    spec = build_decoder_lm(**LM, paged=True, page_size=PS)
    with pytest.raises(ValueError, match="page-aligned"):
        GenerationEngine(spec, place=pt.CPUPlace(), bucket_bounds=[12, 32],
                         start=False)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_programs_read_nothing_on_the_host(host_read_guard,  # noqa: F811
                                                 kv_dtype):
    """Paged prefill and decode (float32 and int8 pools) read no value
    on the host: a captured graph replays them with each run's table."""
    spec = build_decoder_lm(**LM, paged=True, page_size=PS,
                            kv_dtype=kv_dtype)
    with GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=4) \
            as eng:
        out = [eng.submit(p) for p in PROMPTS[:4]]
        assert all(len(r.result(120)["tokens"]) == 4 for r in out)
    assert host_read_guard == []
