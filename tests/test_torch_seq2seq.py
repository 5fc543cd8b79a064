"""bench.py's RNN models in the port, held against the JAX package on the
CPU: the stacked dynamic LSTM classifier and the attention seq2seq
translation model (``models/stacked_dynamic_lstm.py``,
``models/machine_translation.py``), SimNet-BOW, and the sequence-layer
scenarios that use the recurrent ops.

At a small width (dict 50, 32 wide, T 7, batch 4, ragged lengths): the
programs' ``to_dict()`` equal the JAX builders' (block 1 included); five
Adam steps from the JAX startup state follow the JAX losses (rtol 1e-4)
and end at its parameters (rtol 1e-4, atol 2e-5); under ``decorate`` one step matches at
``tests/test_torch_amp.py``'s bands (equal dtypes var for var, loss
rtol 1e-2, parameter gradients relative L2 2e-2 at the median; four
more steps' losses rtol 1e-2) with the JAX side compiled with
``xla_allow_excess_precision`` off.  The other
cases are ``tests/test_machine_translation.py``'s,
``tests/test_simnet_bow.py``'s and two of ``tests/test_sequence_ops.py``'s,
run on the port."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as jax_amp
from paddle_tpu.models import machine_translation as jax_mt
from paddle_tpu.models import simnet_bow as jax_simnet
from paddle_tpu.models import stacked_dynamic_lstm as jax_lstm

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import mixed_precision as amp
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.models import machine_translation as pt_mt
from paddle_tpu_torch.models import simnet_bow as pt_simnet
from paddle_tpu_torch.models import stacked_dynamic_lstm as pt_lstm

from test_torch_amp import assert_dtypes_equal, jax_step, step_distances
from test_torch_serving import fresh_torch_programs  # noqa: F401

MODELS = {fluid: (jax_lstm, jax_mt, jax_simnet),
          pt: (pt_lstm, pt_mt, pt_simnet)}
DICT, WIDTH, T, BATCH = 50, 32, 7, 4


def build(pkg, name, use_amp=False, lr=1e-2, seed=3):
    """(main, startup, loss) of a model at the small width, Adam(lr)."""
    lstm, mt, simnet = MODELS[pkg]
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if name == "stacked_lstm":
            word = pkg.layers.data("word", shape=[1], dtype="int64",
                                   lod_level=1)
            label = pkg.layers.data("label", shape=[1], dtype="int64")
            pred = lstm.stacked_lstm_net(word, DICT, emb_dim=WIDTH,
                                         hid_dim=WIDTH)
            loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        elif name == "machine_translation":
            src, tgt, lbl = (pkg.layers.data(n, shape=[1], dtype="int64",
                                             lod_level=1)
                             for n in ("src", "tgt", "lbl"))
            loss, _ = mt.seq_to_seq_net(src, tgt, lbl, DICT, DICT, WIDTH,
                                        WIDTH, WIDTH)
        else:
            q, p, n = (pkg.layers.data(v, shape=[1], dtype="int64",
                                       lod_level=1) for v in "qpn")
            loss, _, _ = simnet.simnet_bow(q, p, n, dict_size=DICT,
                                           emb_dim=WIDTH, hid_dim=WIDTH)
        opt = pkg.optimizer.Adam(learning_rate=lr)
        if use_amp:
            opt = (jax_amp if pkg is fluid else amp).decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def feeds(name, n, seed=0):
    """Seeded batches at the small width, ragged lengths in [2, T]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(2, T + 1, BATCH).astype("int32")
        if name == "stacked_lstm":
            out.append({"word": rng.randint(0, DICT, (BATCH, T, 1))
                        .astype("int64"), "word@LEN": lens,
                        "label": rng.randint(0, 2, (BATCH, 1))
                        .astype("int64")})
            continue
        names = ("src", "tgt", "lbl") if name == "machine_translation" \
            else ("q", "p", "n")
        f = {}
        for v in names:
            f[v] = rng.randint(1, DICT, (BATCH, T, 1)).astype("int64")
            f[v + "@LEN"] = lens
        out.append(f)
    return out


NAMES = ("stacked_lstm", "machine_translation", "simnet_bow")


@pytest.mark.parametrize("name", NAMES)
def test_program_serializes_like_jax(name):
    """Main and startup ``to_dict()`` equal the JAX builder's, op for op
    and attr for attr (MT: block 1, the decoder's step block, included)."""
    jm, js, _ = build(fluid, name)
    tm, ts, _ = build(pt, name)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    types = [op.type for op in tm.global_block().ops]
    if name == "machine_translation":
        assert len(tm.blocks) == 2 and "recurrent_grad" in types
        assert types.count("lstm_grad") == 2
    elif name == "stacked_lstm":
        assert types.count("lstm") == 3 and len(tm.blocks) == 1


def start_both(name, use_amp=False):
    """Both programs, the port started from the JAX startup state."""
    progs = {pkg: build(pkg, name, use_amp) for pkg in (fluid, pt)}
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(progs[fluid][1], scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in progs[fluid][1].list_vars() if v.persistable}
    tscope = pt.Scope()
    load_numpy_state(tscope, progs[pt][1], state, "cpu")
    return progs, {fluid: jscope, pt: tscope}


@pytest.mark.parametrize("name", NAMES)
def test_five_adam_steps_follow_jax(name):
    """Five Adam(1e-2) steps on ragged batches: each loss within rtol
    1e-4 of the JAX package's, and every parameter after them within rtol
    1e-4 and atol 2e-5.  The atol is 4e-4 of the 5e-2 that five steps can
    move a weight: Adam's m / sqrt(v) carries the float32 rounding of a
    near-zero gradient up to the full step (measured on the CPU: 9e-6 at
    most, in the stacked LSTM's fcs)."""
    progs, scopes = start_both(name)
    batches = feeds(name, 5)
    losses = {}
    for pkg in (fluid, pt):
        exe = pkg.Executor(pkg.CPUPlace())
        main, _, loss = progs[pkg]
        losses[pkg] = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scopes[pkg])[0])
            .ravel()[0]) for f in batches]
    np.testing.assert_allclose(losses[pt], losses[fluid], rtol=1e-4)
    for p in progs[pt][0].all_parameters():
        np.testing.assert_allclose(
            np.asarray(scopes[pt].find_var(p.name)),
            np.asarray(scopes[fluid].find_var(p.name)),
            rtol=1e-4, atol=2e-5, err_msg=p.name)


def amp_step_both(name):
    """``test_torch_amp.run_both`` for a model here: one step of each
    package under ``decorate`` from the JAX startup state, fetching every
    non-persistable output of a block-0 op that the op computes (a
    ``sequence_pool`` gives ``MaxIndex`` for MAX only).  Returns (names,
    JAX fetches, port fetches, both programs, both scopes)."""
    progs, scopes = start_both(name, use_amp=True)
    main, _, loss = progs[pt]
    block = main.global_block()
    names = []
    for op in block.ops:
        for slot, outs in op.outputs.items():
            if op.type == "sequence_pool" and slot == "MaxIndex" \
                    and op.attrs["pooltype"] != "MAX":
                continue
            names += [n for n in outs if n and n not in names
                      and not block.var(n).persistable]
    feed = feeds(name, 1)[0]
    want = jax_step(progs[fluid][0], feed, scopes[fluid], names)
    got = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=names,
                                         scope=scopes[pt],
                                         return_numpy=False)
    return names, want, got, progs, scopes


@pytest.mark.parametrize("name", ["stacked_lstm", "machine_translation"])
def test_amp_step_follows_jax(name):
    """One step under ``decorate``: every fetched var in the JAX package's
    dtype (the ``lstm`` and ``recurrent`` ops grey, the fcs' products
    bfloat16, ``sum`` / ``reduce_sum`` / the losses float32, each memory's
    carry in its memory's dtype), the loss within rtol 1e-2, the
    parameter gradients within relative L2 2e-2 at the median; then four
    more Adam steps, each loss within rtol 1e-2."""
    names, want, got, progs, scopes = amp_step_both(name)
    main, _, loss = progs[pt]
    assert assert_dtypes_equal(names, want, got) > 5
    loss_err, grads = step_distances(names, want, got, main, loss.name)
    assert loss_err < 1e-2
    assert np.median(grads) <= 2e-2, sorted(grads)[-5:]
    exe = pt.Executor(pt.CPUPlace())
    for f in feeds(name, 5)[1:]:
        (w,) = jax_step(progs[fluid][0], f, scopes[fluid], [loss.name])
        (g,) = exe.run(main, feed=f, fetch_list=[loss], scope=scopes[pt])
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=1e-2)


# ---------------------------------------------------------------------------
# tests/test_machine_translation.py on the port
# ---------------------------------------------------------------------------

V = 16


def copy_task_feed(rng, b, t, lens=None):
    feed = {}
    lens = np.asarray(lens if lens is not None else [t] * b, "int32")
    for name in ("src", "tgt", "lbl"):
        feed[name] = rng.randint(1, V, (b, t, 1)).astype("int64")
        feed[name + "@LEN"] = lens
    feed["tgt"] = feed["src"].copy()
    feed["lbl"] = feed["src"].copy()
    return feed


def mt_words():
    return [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
            for n in ("src", "tgt", "lbl")]


def test_seq2seq_attention_trains():
    rng = np.random.RandomState(0)
    cost, _ = pt_mt.seq_to_seq_net(*mt_words(), V, V, embedding_dim=16,
                                   encoder_size=16, decoder_size=16)
    pt.optimizer.Adam(learning_rate=0.02).minimize(cost)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    feed = copy_task_feed(rng, 8, 6)
    losses = [float(np.asarray(exe.run(feed=feed, fetch_list=[cost])[0])
                    .ravel()[0]) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_seq2seq_attention_masks_padding():
    """Garbage in the source padding does not move the loss."""
    rng = np.random.RandomState(1)
    cost, _ = pt_mt.seq_to_seq_net(*mt_words(), V, V, embedding_dim=8,
                                   encoder_size=8, decoder_size=8)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    feed = copy_task_feed(rng, 4, 6, lens=[3, 4, 2, 6])
    (a,) = exe.run(feed=feed, fetch_list=[cost])
    for i, ln in enumerate(feed["src@LEN"]):
        feed["src"][i, ln:] = (feed["src"][i, ln:] + 7) % V
    (b,) = exe.run(feed=feed, fetch_list=[cost])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_nets_attention_numerics():
    """``dot_product_attention`` against a numpy masked softmax, and
    ``simple_attention`` takes an SGD step with a finite loss."""
    b, t, d = 2, 4, 3
    enc = pt.layers.data("enc", shape=[d], lod_level=1)
    query = pt.layers.data("q", shape=[d])
    ctx = pt.nets.dot_product_attention(
        enc, enc, query, length=pt.layers.sequence_length(enc))
    exe = pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(0)
    ev = rng.randn(b, t, d).astype("float32")
    qv = rng.randn(b, d).astype("float32")
    lens = np.array([2, 4], "int64")
    (out,) = exe.run(feed={"enc": ev, "enc@LEN": lens, "q": qv},
                     fetch_list=[ctx])
    for i in range(b):
        s = ev[i] @ qv[i]
        s[lens[i]:] = -np.inf
        w = np.exp(s - s.max())
        w /= w.sum()
        np.testing.assert_allclose(out[i], w @ ev[i], rtol=1e-4, atol=1e-5)

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        enc = pt.layers.data("enc", shape=[d], lod_level=1)
        proj = pt.layers.fc(enc, size=d, num_flatten_dims=2,
                            bias_attr=False)
        state = pt.layers.data("st", shape=[d])
        ctx = pt.nets.simple_attention(
            enc, proj, state, d, length=pt.layers.sequence_length(enc))
        loss = pt.layers.mean(ctx)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    (lv,) = exe.run(main, feed={"enc": np.ones((b, t, d), "float32"),
                                "enc@LEN": np.array([2, 4], "int64"),
                                "st": np.ones((b, d), "float32")},
                    fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all()


# ---------------------------------------------------------------------------
# tests/test_simnet_bow.py on the port
# ---------------------------------------------------------------------------

def simnet_batches(steps, seed=0, v=500, t=6, b=32):
    """Positive titles share half the query's words; negatives random."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        q = rng.randint(0, v, (b, t, 1)).astype("int64")
        pos = q.copy()
        mask = rng.rand(b, t, 1) < 0.5
        pos[mask] = rng.randint(0, v, int(mask.sum()))
        neg = rng.randint(0, v, (b, t, 1)).astype("int64")
        lens = np.full(b, t, "int64")
        out.append({"q": q, "q@LEN": lens, "p": pos, "p@LEN": lens,
                    "n": neg, "n@LEN": lens})
    return out


def test_simnet_bow_learns_to_rank():
    pt.default_main_program().random_seed = 11
    pt.default_startup_program().random_seed = 11
    q, p, n = (pt.layers.data(v, shape=[1], dtype="int64", lod_level=1)
               for v in "qpn")
    cost, ps, ns = pt_simnet.simnet_bow(q, p, n, dict_size=500, margin=0.3)
    pt.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    losses = [float(np.asarray(exe.run(feed=f, fetch_list=[cost])[0])
                    .ravel()[0]) for f in simnet_batches(80)]
    correct = total = 0
    for f in simnet_batches(5, seed=99):
        _, pv, nv = exe.run(feed=f, fetch_list=[cost, ps, ns])
        correct += int((pv > nv).sum())
        total += len(pv)
    assert np.mean(losses[-10:]) < 0.08, np.mean(losses[-10:])
    assert correct / total > 0.93, correct / total


# ---------------------------------------------------------------------------
# tests/test_sequence_ops.py's recurrent cases on the port
# ---------------------------------------------------------------------------

def test_lstm_classifier_trains():
    dict_size, emb_dim, hid = 50, 16, 16
    word = pt.layers.data("word", shape=[1], dtype="int64", lod_level=1)
    label = pt.layers.data("label", shape=[1], dtype="int64")
    emb = pt.layers.embedding(word, size=[dict_size, emb_dim])
    proj = pt.layers.fc(emb, size=hid * 4, num_flatten_dims=2)
    h, _ = pt.layers.dynamic_lstm(proj, size=hid * 4)
    pooled = pt.layers.sequence_pool(h, "max")
    pred = pt.layers.fc(pooled, size=2, act="softmax")
    loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
    pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    feeder = pt.DataFeeder(feed_list=[word, label], pad_to=8)
    rng = np.random.RandomState(0)

    def batch():
        rows = []
        for _ in range(8):
            seq = rng.randint(0, dict_size, (rng.randint(1, 9),)) \
                .astype("int64")
            rows.append((seq, [np.int64(seq.max() > dict_size // 2)]))
        return feeder.feed(rows)

    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    losses = [float(np.asarray(exe.run(feed=batch(), fetch_list=[loss])[0])
                    .ravel()[0]) for _ in range(30)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_gru_pool_expand_pipeline():
    word = pt.layers.data("w", shape=[4], dtype="float32", lod_level=1)
    proj = pt.layers.fc(word, size=6 * 3, num_flatten_dims=2)
    h = pt.layers.dynamic_gru(proj, size=6)
    pooled = pt.layers.sequence_pool(h, "average")
    back = pt.layers.sequence_expand(pooled, h)
    assert back.shape[1] == h.shape[1]
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    feeder = pt.DataFeeder(feed_list=[word], pad_to=5)
    rng = np.random.RandomState(0)
    rows = [(rng.rand(3, 4).astype("float32"),),
            (rng.rand(5, 4).astype("float32"),)]
    (out,) = exe.run(feed=feeder.feed(rows), fetch_list=[back])
    assert out.shape == (2, 5, 6)
    assert np.all(out[0, 3:] == 0)
