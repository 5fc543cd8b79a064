"""The port's compiled step: what the CUDA graph of ``Executor.run`` relies
on, held on the CPU at small sizes, and the captured step against the
eager one on the card.

On the CPU (no card needed):

* an entry's key carries the feeds' shapes and dtypes, so two serving
  buckets are two entries (two graphs on the card);
* randomness is keyed from device memory: the attention-dropout seed of
  an op is a pure function of (run key, op index), so the generic grad's
  recompute draws the forward's mask; two executors with one
  ``random_seed`` draw alike and successive runs draw anew; the keep-mask
  with a tensor seed is the JAX ``_keep_mask`` bit for bit;
* ``kv_cache_write``'s scattered prefill, now a device-side write, is the
  JAX op's, clamps and row order included;
* no compute on the decode, prefill, score, Transformer-training or
  ResNet programs reads a tensor's value on the host or copies host data
  in (a value read there would be frozen into a captured graph).

Marked ``cuda`` (skipped without a card; on the card:
``python -m pytest -m cuda tests/test_torch_capture.py``): captured and
eager steps give the same bits, launch counts hold under replay, a state
swap is seen by the next replay, fetches are not rewritten by a later
replay, and a capture that fails names the op.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp
from paddle_tpu.ops.pallas import flash_attention as jfa

import paddle_tpu_torch as pt
from paddle_tpu_torch import backward as pt_backward
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import hash32
from paddle_tpu_torch import optimizer as pt_optimizer
from paddle_tpu_torch import registry
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.ops import attention as pt_attention
from paddle_tpu_torch.ops import cuda as pt_cuda
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.registry import ComputeContext
from paddle_tpu_torch.serving import GenerationEngine, build_decoder_lm

from test_torch_ops import _kv_build, _rand, run_both
from test_torch_resnet import resnet18_net
from test_torch_resnet import build as build_resnet

TINY = dict(n_layer=2, n_head=2, d_model=32, d_inner=64)
VOCAB, MAX_LEN = 20, 8
SMALL_LM = dict(vocab_size=23, max_len=32, slots=4, n_layer=2, n_head=2,
                d_model=16, d_inner=32)
# on the card: the attention kernels take head dim 64
CARD_TINY = dict(TINY, d_model=128, d_inner=128)
CARD_LM = dict(SMALL_LM, d_model=128, d_inner=128)


@pytest.fixture(autouse=True)
def fresh_port_defaults():
    """Fresh port default programs, scope and name counter, and zeroed
    kernel launch counters, for every test."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    pt_cuda.reset_launch_counts()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)
    pt_cuda.reset_launch_counts()


@pytest.fixture
def card():
    """The CUDA place; the test skips on a machine without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured step runs on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return pt.CUDAPlace(0)


def build_train(dropout, seed=5, dims=TINY):
    """(main, startup, cost) of the tiny Transformer train program (label
    smoothing 0.1, noam, Adam), both programs seeded with ``seed``."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup), pt.unique_name.guard():
        words = [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = pt_transformer.transformer(
            *words, MAX_LEN, MAX_LEN, VOCAB, VOCAB, dropout_rate=dropout,
            label_smooth_eps=0.1, **dims)
        lr = pt.layers.noam_decay(dims["d_model"], 4000)
        pt_optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                          epsilon=1e-9).minimize(cost)
    return main, startup, cost


def train_feed(rng, batch=4):
    lens = rng.randint(3, MAX_LEN + 1, batch).astype("int32")
    feed = {n: rng.randint(0, VOCAB, (batch, MAX_LEN, 1)).astype("int64")
            for n in ("src_word", "tgt_word", "lbl_word")}
    feed.update({n + "@LEN": lens for n in ("src_word", "tgt_word",
                                            "lbl_word")})
    return feed


def train_losses(place, dropout, steps, capture=True, seed=5, dims=TINY):
    """Losses of ``steps`` Adam steps from the startup state, and the
    executor and scope."""
    main, startup, cost = build_train(dropout, seed, dims)
    exe, scope = pt.Executor(place, capture=capture), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    losses = [exe.run(main, feed=train_feed(rng), fetch_list=[cost],
                      scope=scope)[0] for _ in range(steps)]
    return losses, exe, scope, main


# ---------------------------------------------------------------------------
# the entry key
# ---------------------------------------------------------------------------

def _entries(exe, program):
    return [k for k in exe._analysis if k[0] == id(program)]


def test_entry_key_separates_feed_shapes_and_dtypes():
    """An entry per feed signature, as the JAX executor keys its jit cache
    by ``feed_sig``: another batch is another entry, a feed coerced to the
    declared dtype is the same one, an undeclared feed's own dtype counts."""
    x = pt.layers.data("x", shape=[4])
    y = pt.layers.scale(x, scale=2.0)
    main = pt.default_main_program()
    exe = pt.Executor(pt.CPUPlace())
    for batch in (2, 3, 2):
        (out,) = exe.run(feed={"x": np.ones((batch, 4), "float32")},
                         fetch_list=[y])
        assert out.shape == (batch, 4)
    assert len(_entries(exe, main)) == 2
    # float64 fed to the float32 var enters as float32: the batch-2 entry
    exe.run(feed={"x": np.ones((2, 4), "float64")}, fetch_list=[y])
    assert len(_entries(exe, main)) == 2
    for dtype in ("int32", "int64"):
        exe.run(feed={"x": np.ones((2, 4), "float32"),
                      "aux": np.zeros(3, dtype)}, fetch_list=[y])
    assert len(_entries(exe, main)) == 4
    sigs = {k[2] for k in _entries(exe, main)}
    assert (("x", (3, 4), torch.float32),) in sigs


def test_an_entry_is_not_found_through_a_reused_id(monkeypatch):
    """Entries key by ``id(program)`` and ``id(scope)``; a scope (or
    program) made after another died may get its id, and must not find
    the dead one's entry (on the card: its graph)."""
    from paddle_tpu_torch import executor as pt_executor

    x = pt.layers.data("x", shape=[4])
    y = pt.layers.scale(x, scale=2.0)
    monkeypatch.setattr(pt_executor, "id", lambda obj: 7, raising=False)
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.ones((2, 4), "float32")}
    exe.run(feed=feed, fetch_list=[y], scope=pt.Scope())
    (key,) = exe._analysis
    first = exe._analysis[key]
    scope = pt.Scope()
    (out,) = exe.run(feed=feed, fetch_list=[y], scope=scope)
    assert list(exe._analysis) == [key]
    assert exe._analysis[key] is not first
    assert exe._dead == []
    np.testing.assert_array_equal(out, np.full((2, 4), 2.0))


def test_an_entry_is_dropped_when_its_scope_or_program_dies():
    """An entry (on the card: its graph, its feed buffers and the state
    tensors it holds) lives as long as its program and its scope; the
    executor drops it at its next run after either died."""
    import gc

    x = pt.layers.data("x", shape=[4])
    y = pt.layers.scale(x, scale=2.0)
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.ones((2, 4), "float32")}
    keep = pt.Scope()
    exe.run(feed=feed, fetch_list=[y], scope=keep)
    scope = pt.Scope()
    exe.run(feed=feed, fetch_list=[y], scope=scope)
    other = pt.Program()
    with pt.program_guard(other, pt.Program()):
        z = pt.layers.scale(pt.layers.data("x", shape=[4]), scale=3.0)
    exe.run(other, feed=feed, fetch_list=[z], scope=keep)
    assert len(exe._analysis) == 3
    del scope, other, z
    gc.collect()
    exe.run(feed=feed, fetch_list=[y], scope=keep)
    assert [k[-1] for k in exe._analysis] == [id(keep)]
    assert [k[0] for k in exe._analysis] == [id(pt.default_main_program())]
    assert exe._dead == []


def test_two_serving_buckets_are_two_entries():
    """Prompts of 5 and 20 tokens prefill in the 8 and 32 buckets: two
    prefill entries (one graph each on the card), one decode entry."""
    spec = build_decoder_lm(**SMALL_LM)
    with GenerationEngine(spec, place=pt.CPUPlace(),
                          max_new_tokens=3) as eng:
        for n in (5, 20, 6):
            eng.generate(list(range(1, n + 1)), timeout=120)
        prefill = _entries(eng._exe, spec.prefill_program)
        decode = _entries(eng._exe, spec.decode_program)
    assert sorted({n: shape for n, shape, _ in k[2]}["tok"]
                  for k in prefill) == [(4, 8, 1), (4, 32, 1)]
    assert len(decode) == 1


def test_device_trace_names_count_each_wrapper_call_once():
    """A replayed graph runs its kernels without their wrappers, so its
    launches are counted from the device trace's kernel names: each
    wrapper's one kernel a call counts, its helpers (the weight split, the
    partial-sum reductions, the dynamic row grid) and PyTorch's kernels do
    not, and the two conv+BN layouts' same-named kernels stay apart."""
    anon = "void (anonymous namespace)::"
    names = [anon + n for n in (
        "flash_fwd_kernel<float>(float const*, float const*, int)",
        "flash_decode_kernel<float>(float const*, float const*, int)",
        "flash_bwd_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)",
        "dq_sum<float>(float const*, float*, int, int, float, long)",
        "layer_norm_fwd_kernel<float>(float const*, float const*)",
        "layer_norm_bwd_rows<float, 4, 1>(float const*, float const*)",
        "layer_norm_bwd_columns<float>(float const*, float*)",
        "softmax_xent_fwd_kernel<float>(float const*, long const*)",
        "softmax_xent_bwd_kernel<float>(float const*, long const*)",
        "gemv_kernel<1, float, 1>(float const*, signed char const*)",
        "gemm_kernel<1, float>(void const*, signed char const*)",
        "quantize_rows_kernel<float>(float const*, float const*)",
        "split_w<float>(float const*, long, long, int, int, int, long)",
        "fwd_kernel<float>((anonymous namespace)::Act, unsigned char "
        "const*, int)",
        "dx_kernel<float>((anonymous namespace)::Act, unsigned char const*)",
        "dw_kernel<float>((anonymous namespace)::Act, (anonymous "
        "namespace)::Act, float*)",
        "fwd_kernel<float>((anonymous namespace)::Src, (anonymous "
        "namespace)::Src, float const*)",
        "dx_kernel<__nv_bfloat16>((anonymous namespace)::Src, (anonymous "
        "namespace)::Src)",
        "sum_rows(float const*, int, long, float*)")]
    names += ["void at::native::(anonymous namespace)::fwd_kernel<float>("
              "(anonymous namespace)::Act)", "Memcpy HtoD (Pageable -> "
              "Device)", "void at::native::vectorized_elementwise_kernel<4>"]
    counts = pt_cuda.device_launch_counts(names)
    assert counts == {"flash_attention_fwd": 2, "flash_attention_bwd": 1,
                      "layer_norm_fwd": 1, "layer_norm_bwd": 1,
                      "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                      "dequant_matmul": 2, "conv_bn_fwd": 1,
                      "conv_bn_bwd": 1, "conv_bn_fwd_nhwc": 1,
                      "conv_bn_bwd_nhwc": 1}


# ---------------------------------------------------------------------------
# randomness keyed from device memory
# ---------------------------------------------------------------------------

def test_op_seeds_are_a_pure_function_of_run_key_and_op_index():
    key = torch.tensor([0x0123456789ABCDEF & ((1 << 62) - 1)])
    short, long = hash32.op_seeds(key, 5), hash32.op_seeds(key, 9)
    assert short.dtype == torch.int32 and short.shape == (5,)
    assert torch.equal(short, long[:5])
    assert len(set(long.tolist())) == 9
    assert not torch.equal(hash32.op_seeds(key + 1, 5), short)
    # two contexts whose generators start alike give equal seeds, from
    # any op at any point of the run
    a = ComputeContext("cpu", torch.Generator().manual_seed(3), 6)
    b = ComputeContext("cpu", torch.Generator().manual_seed(3), 2)
    assert torch.equal(a.seed32(4), b.seed32(4))
    assert torch.equal(a.seed32(1), b.seed32(1))
    assert torch.equal(a.seed32(4), hash32.op_seeds(a.run_key, 5)[4:])


@pytest.mark.parametrize("seed", [1234, 0xDEADBEEF, 0x80000000])
def test_keep_mask_with_a_tensor_seed_is_bitwise_jax(seed):
    """The seed as the kernels read it (one int32 element holding the
    uint32) gives the JAX ``_keep_mask`` bit for bit."""
    bh = np.arange(6, dtype="int32").reshape(6, 1, 1)
    gq = np.arange(16, dtype="int32").reshape(1, 16, 1)
    gk = np.arange(40, dtype="int32").reshape(1, 1, 40)
    want = np.asarray(jfa._keep_mask(jnp.asarray(seed, jnp.uint32),
                                     jnp.asarray(bh), jnp.asarray(gq),
                                     jnp.asarray(gk), 0.1))
    st = fa.seed_tensor(seed, "cpu")
    assert st.dtype == torch.int32 and st.shape == (1,)
    got = fa.keep_mask(st, torch.from_numpy(bh), torch.from_numpy(gq),
                       torch.from_numpy(gk), 0.1).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, fa.keep_mask(seed, torch.from_numpy(bh),
                                            torch.from_numpy(gq),
                                            torch.from_numpy(gk), 0.1))


def _attention_program(rate):
    b, h, t, d = 2, 2, 8, 16
    qkv = [pt.layers.data(n, shape=[h, t, d], stop_gradient=False)
           for n in ("q", "k", "v")]
    klen = pt.layers.data("klen", shape=[], dtype="int32")
    w = pt.layers.data("w", shape=[h, t, d])
    out = pt.layers.fused_attention(*qkv, k_len=klen, causal=True,
                                    dropout_rate=rate)
    loss = pt.layers.reduce_sum(pt.layers.elementwise_mul(out, w))
    pt_backward.append_backward(loss)
    rng = np.random.RandomState(0)
    f = {n: rng.randn(b, h, t, d).astype("float32")
         for n in ("q", "k", "v", "w")}
    f["klen"] = np.asarray([8, 5], "int32")
    return pt.default_main_program(), f


def test_grad_recompute_draws_the_forward_attention_mask(monkeypatch):
    """The generic grad reruns ``fused_attention`` under the forward's op
    index: its seed is the forward's (the same device value), and the
    gradients equal autograd through ``reference_attention_lse`` with it."""
    main, f = _attention_program(0.1)
    seeds = []
    real = fa.flash_attention

    def spy(q, k, v, k_len, seed, *args):
        seeds.append(seed)
        return real(q, k, v, k_len, seed, *args)

    monkeypatch.setattr(pt_attention.fa, "flash_attention", spy)
    grads = pt.Executor(pt.CPUPlace()).run(
        main, feed=f, fetch_list=[n + "@GRAD" for n in ("q", "k", "v")])
    assert len(seeds) == 2 and seeds[0] is not seeds[1]
    assert seeds[0].dtype == torch.int32 and torch.equal(seeds[0], seeds[1])
    leaves = [torch.from_numpy(f[n]).requires_grad_() for n in "qkv"]
    o, _ = fa.reference_attention_lse(*leaves, torch.from_numpy(f["klen"]),
                                      seeds[0], True, 0.1)
    want = torch.autograd.grad(o, leaves, torch.from_numpy(f["w"]))
    for g, wv in zip(grads, want):
        np.testing.assert_allclose(g, wv.numpy(), rtol=1e-5, atol=1e-6)
    # and the mask drops weights: another seed gives other gradients
    o2, _ = fa.reference_attention_lse(*leaves, torch.from_numpy(f["klen"]),
                                       seeds[0] + 1, True, 0.1)
    other = torch.autograd.grad(o2, leaves, torch.from_numpy(f["w"]))
    assert not np.allclose(grads[0], other[0].numpy(), atol=1e-4)


def test_two_executors_with_one_seed_draw_alike():
    """Three dropout-on Transformer steps from the startup: two executors
    with one ``random_seed`` give equal losses; another main seed gives
    other losses (dropout draws from the seed's generator)."""
    a = train_losses(pt.CPUPlace(), 0.1, 3)[0]
    b = train_losses(pt.CPUPlace(), 0.1, 3)[0]
    assert [float(x[0]) for x in a] == [float(x[0]) for x in b]
    assert len({float(x[0]) for x in a}) == 3
    main, startup, cost = build_train(0.1)
    main.random_seed = 6
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    (c,) = exe.run(main, feed=train_feed(np.random.RandomState(3)),
                   fetch_list=[cost], scope=scope)
    assert float(c[0]) != float(a[0][0])


def test_successive_runs_draw_new_masks(monkeypatch):
    """Two runs of one entry: ``dropout``'s mask and the attention seed
    both change from run to run."""
    main, f = _attention_program(0.1)
    x = pt.layers.data("x", shape=[64])
    drop = pt.layers.dropout(x, dropout_prob=0.5)
    mask = main.global_block().ops[-1].outputs["Mask"][0]
    seeds = []
    real = fa.flash_attention

    def spy(q, k, v, k_len, seed, *args):
        seeds.append(seed.clone())
        return real(q, k, v, k_len, seed, *args)

    monkeypatch.setattr(pt_attention.fa, "flash_attention", spy)
    f["x"] = np.ones((4, 64), "float32")
    exe = pt.Executor(pt.CPUPlace())
    m1, _, _ = exe.run(main, feed=f, fetch_list=[mask, drop, "q@GRAD"])
    m2, _, _ = exe.run(main, feed=f, fetch_list=[mask, drop, "q@GRAD"])
    assert not np.array_equal(m1, m2)
    assert 0.3 < m1.mean() < 0.7
    fwd = seeds[0::2]   # the forward's call, then the grad's recompute
    assert len(fwd) == 2 and not torch.equal(fwd[0], fwd[1])


# ---------------------------------------------------------------------------
# kv_cache_write: the device-side scattered write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["out_of_range", "overlapping_rows",
                                  "padding_duplicates"])
def test_kv_cache_scatter_matches_jax(case):
    """The scattered prefill (with ``Slot``) against the JAX op, bit for
    bit: slots and positions out of range go as
    ``lax.dynamic_update_slice`` takes them (negative from the end, then
    clamped), and rows apply in row order (a later row wins where two
    stripes overlap)."""
    s, h, tmax, d, t = 3, 2, 8, 4, 3
    if case == "out_of_range":
        pos, slot = [-3, 100, 6, 5], [-2, 7, 1, 3]
    elif case == "overlapping_rows":
        pos, slot = [0, 2, 1, 4], [1, 1, 1, 0]
    else:
        pos, slot = [1, 4, 1, 1], [2, 0, 2, 2]
    x = _rand(len(pos), h, t, d, seed=9)
    if case == "padding_duplicates":
        x[2:] = x[0]     # the engine's padding rows repeat row 0
    cache0 = _rand(s, h, tmax, d, seed=10)
    feed = {"x": x, "p": np.asarray(pos, "int32"),
            "sl": np.asarray(slot, "int32")}
    (out,), (_, tscope) = run_both(_kv_build(True, s, h, tmax, d, len(pos),
                                             t), feed,
                                   state={"cache": cache0}, rtol=0, atol=0)
    np.testing.assert_array_equal(tscope.find_var("cache").numpy(), out)
    if case == "overlapping_rows":
        # slot 1 takes row 0 at 0..2, row 1 at 2..4, then row 2 at 1..3
        np.testing.assert_array_equal(out[1, :, 0], x[0][:, 0])
        np.testing.assert_array_equal(out[1, :, 1:4], x[2])
        np.testing.assert_array_equal(out[1, :, 4], x[1][:, 2])


# ---------------------------------------------------------------------------
# no host reads on the main paths
# ---------------------------------------------------------------------------

class _HostReads(TorchDispatchMode):
    """Records ``aten._local_scalar_dense`` (``.item()``, ``bool()``,
    ``int()``, ``float()`` of a tensor) under the op being computed."""

    def __init__(self, hits, op_type):
        super().__init__()
        self.hits, self.op_type = hits, op_type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.hits.append((self.op_type, str(func)))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def host_read_guard(monkeypatch):
    """Runs every op compute under ``_HostReads`` and flags the Tensor
    methods that read values on the host (``tolist``, ``numpy``, ``cpu``,
    ``item``) and host data copied in (``torch.from_numpy``, and
    ``torch.tensor`` of anything but a Python scalar); returns the list of
    (op type, what) hits."""
    hits, current = [], [None]
    real_compute = registry.compute_op

    def compute(op, env, ctx, op_index=0):
        current[0] = op.type
        try:
            with _HostReads(hits, op.type):
                return real_compute(op, env, ctx, op_index)
        finally:
            current[0] = None

    def flag(what, real):
        def wrapper(*args, **kwargs):
            if current[0] is not None:
                hits.append((current[0], what))
            return real(*args, **kwargs)
        return wrapper

    for name in ("tolist", "numpy", "cpu", "item"):
        monkeypatch.setattr(torch.Tensor, name,
                            flag("Tensor." + name, getattr(torch.Tensor,
                                                           name)))
    monkeypatch.setattr(torch, "from_numpy",
                        flag("torch.from_numpy", torch.from_numpy))
    real_tensor = torch.tensor

    def tensor(data, *args, **kwargs):
        if current[0] is not None and not isinstance(data, (int, float,
                                                            bool)):
            hits.append((current[0], "torch.tensor of %s"
                         % type(data).__name__))
        return real_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "tensor", tensor)
    monkeypatch.setattr(registry, "compute_op", compute)
    return hits


def test_guard_catches_host_reads(host_read_guard):
    """The guard itself: an op that reads a value is caught."""
    x = pt.layers.data("x", shape=[3])
    y = pt.layers.scale(x, scale=2.0)
    prog = pt.default_main_program()
    real = registry.get_op_def("scale").compute

    def reads(ins, attrs, ctx, op_index):
        float(ins["X"][0].sum())
        ins["X"][0].tolist()
        return real(ins, attrs, ctx, op_index)

    d = registry.get_op_def("scale")
    try:
        d.compute = reads
        pt.Executor(pt.CPUPlace()).run(prog, feed={"x": np.ones((2, 3),
                                                                "float32")},
                                       fetch_list=[y])
    finally:
        d.compute = real
    assert ("scale", "aten._local_scalar_dense.default") in host_read_guard
    assert ("scale", "Tensor.tolist") in host_read_guard


@pytest.mark.parametrize("quantize", [None, "weight_only", "dynamic"])
def test_serving_programs_read_nothing_on_the_host(host_read_guard,
                                                   quantize):
    """Prefill and decode through ``GenerationEngine`` (fp and both int8
    modes), and the score program, on the CPU."""
    spec = build_decoder_lm(**SMALL_LM)
    with GenerationEngine(spec, place=pt.CPUPlace(), max_new_tokens=4,
                          quantize=quantize) as eng:
        out = [eng.submit(list(range(1, n + 1))) for n in (5, 12, 3)]
        assert all(len(r.result(120)["tokens"]) == 4 for r in out)
        t = 6
        (logits,) = eng._exe.run(
            eng.spec.score_program,
            feed={"tok": np.arange(t, dtype="int64").reshape(1, t, 1),
                  "tok@LEN": np.asarray([t], "int32"),
                  "pos": np.arange(t, dtype="int64").reshape(1, t, 1)},
            fetch_list=[eng.spec.score_logits], scope=eng._scope)
    assert np.isfinite(logits).all()
    assert host_read_guard == []


def test_transformer_training_reads_nothing_on_the_host(host_read_guard):
    """Two dropout-on steps of the tiny Transformer (the startup program
    is not a main path and runs unguarded)."""
    main, startup, cost = build_train(0.1)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    del host_read_guard[:]
    rng = np.random.RandomState(0)
    for _ in range(2):
        (loss,) = exe.run(main, feed=train_feed(rng), fetch_list=[cost],
                          scope=scope)
    assert np.isfinite(loss).all()
    assert host_read_guard == []


@pytest.mark.parametrize("mode", ["plain", "fuse", "nhwc_fuse"])
def test_resnet_programs_read_nothing_on_the_host(host_read_guard, mode):
    """One Momentum step of the depth-18 ResNet (3x32x32) in each of the
    three programs."""
    main, startup, loss, _ = build_resnet(pt, resnet18_net, mode)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    del host_read_guard[:]
    rng = np.random.RandomState(0)
    (out,) = exe.run(main, feed={
        "img": rng.rand(2, 3, 32, 32).astype("float32"),
        "label": rng.randint(0, 10, (2, 1)).astype("int64")},
        fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()
    assert host_read_guard == []


# ---------------------------------------------------------------------------
# on the card: captured against eager
# ---------------------------------------------------------------------------

def _state(scope, names):
    return {n: scope.find_var(n).detach().clone() for n in names}


@pytest.mark.cuda
def test_captured_training_matches_eager_bits(card):
    """Five dropout-on steps captured (the first eager, the second captured
    and replayed, the rest replayed) against five eager ones from the same
    startup state and seeds: equal losses and parameters, bit for bit.
    The captured executor's wrappers launch the kernels of two steps (the
    eager one and the capture) and no more; a sixth step, replayed, runs
    one step's kernels as the device trace counts them."""
    from torch.profiler import ProfilerActivity, profile

    runs = {}
    for capture in (False, True):
        pt_cuda.reset_launch_counts()
        losses, exe, scope, main = train_losses(card, 0.1, 5, capture,
                                                dims=CARD_TINY)
        params = [p.name for p in main.all_parameters()]
        runs[capture] = ([float(x[0]) for x in losses], _state(scope, params),
                         pt_cuda.launch_counts(), exe, scope, main)
    eager, captured = runs[False], runs[True]
    assert captured[0] == eager[0]
    assert all(torch.equal(captured[1][n], eager[1][n]) for n in eager[1])
    assert eager[2]["flash_attention_fwd"] > 0
    assert captured[2] == {k: n // 5 * 2 for k, n in eager[2].items()}
    assert sum(s.graph is not None
               for s in captured[3]._steps.values()) == 1
    exe, scope, main = captured[3:]
    (key,) = _entries(exe, main)
    pt_cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        exe.run(main, feed=train_feed(np.random.RandomState(4)),
                fetch_list=list(key[3]), scope=scope)
        torch.cuda.synchronize()
    assert _entries(exe, main) == [key]
    assert all(n == 0 for n in pt_cuda.launch_counts().values())
    traced = pt_cuda.device_launch_counts(e.name for e in prof.events())
    assert traced == {k: n // 5 for k, n in eager[2].items()}


@pytest.mark.cuda
def test_replay_sees_a_state_swap_and_keeps_fetches(card):
    """``scope.set_var`` between replays is seen by the next replay and the
    scope points back at the captured tensor; a ``return_numpy=False``
    fetch is not rewritten by a later replay."""
    x = pt.layers.data("x", shape=[4])
    y = pt.layers.fc(x, 4, bias_attr=False, param_attr=pt.ParamAttr(name="w"))
    exe = pt.Executor(card)
    exe.run(pt.default_startup_program())
    scope = pt.global_scope()
    feed = {"x": np.eye(4, dtype="float32")}
    outs = [exe.run(feed=feed, fetch_list=[y], return_numpy=False)[0]
            for _ in range(3)]
    captured = scope.find_var("w")
    first = outs[1].clone()
    scope.set_var("w", np.full((4, 4), 2.0, "float32"))
    (swapped,) = exe.run(feed=feed, fetch_list=[y])
    np.testing.assert_array_equal(swapped, np.full((4, 4), 2.0))
    assert scope.find_var("w") is captured
    assert torch.equal(outs[1], first)


@pytest.mark.cuda
def test_serving_captured_matches_eager_bits(card):
    """Generated tokens and recorded logits, capture on and off."""
    spec = build_decoder_lm(**CARD_LM)
    got = {}
    for capture in (False, True):
        with GenerationEngine(spec, place=card, max_new_tokens=5,
                              record_logits=True, capture=capture) as eng:
            got[capture] = [eng.generate(list(range(1, n + 1)), timeout=300)
                            for n in (5, 12, 5)]
    for a, b in zip(got[False], got[True]):
        assert a["tokens"] == b["tokens"]
        assert all(np.array_equal(x, y) for x, y in zip(a["logits"],
                                                         b["logits"]))


_HOST_READ_OP = "capture_test_host_read"


@pytest.mark.cuda
def test_capture_failure_names_the_op(card):
    """An op that reads a value on the host cannot be captured: the second
    run raises, naming the op's index and type."""
    if _HOST_READ_OP not in registry.OPS:
        registry.register_op(
            _HOST_READ_OP, ["X"], ["Out"],
            infer=registry.same_shape_infer("X", "Out"),
            compute=lambda ins, attrs, ctx, i: {
                "Out": ins["X"][0] * float(ins["X"][0].sum())},
            grad=None)
    x = pt.layers.data("x", shape=[3])
    block = pt.default_main_program().global_block()
    out = block.create_var(name="out", shape=[-1, 3], dtype="float32")
    block.append_op(type=_HOST_READ_OP, inputs={"X": [x]},
                    outputs={"Out": [out]})
    exe = pt.Executor(card)
    feed = {"x": np.ones((2, 3), "float32")}
    exe.run(feed=feed, fetch_list=[out])
    with pytest.raises(RuntimeError, match="op 0 \\(%s\\)" % _HOST_READ_OP):
        exe.run(feed=feed, fetch_list=[out])
