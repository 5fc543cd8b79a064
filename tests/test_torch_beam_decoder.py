"""Beam-search decoding through the port held against the JAX package on
the CPU: the While-loop decoder of ``tests/test_rnn_encoder_decoder.py``
and the ``contrib.decoder`` API of ``tests/test_contrib_decoder.py``.

From carried weights (the JAX startup state, never re-drawn) both
programs build the JAX builders' programs (``to_dict``) and give the JAX
package's sentence ids exactly and its scores within rtol 1e-5, at random
weights (every trip runs) and with the score bias at ``end_id`` raised
(every beam finishes early and the loop stops after a few trips).  The
attention decoder is ``chip_smoke.build_beam_decoder``, the program the
card runs at machine translation's width, here at a small one.  Then the
port trains each copy-task seq2seq itself and its top beam reproduces the
source, and the API's checks refuse what the JAX package refuses.  The
beam program's ops read nothing on the host."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import chip_smoke as cs
import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib.decoder import (BeamSearchDecoder, InitState,
                                              StateCell, TrainingDecoder)

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_rnn import started_scopes
from test_torch_serving import fresh_torch_programs  # noqa: F401

SMALL = dict(dict_dim=20, word_dim=16, hidden=16, src_len=5, beam=3,
             max_len=6, end_id=0)
V, D, H, TMAX = 8, 16, 64, 4
BOS, EOS = 1, 0


def _both(build):
    """{pkg: (main, startup, fetch)} of ``build(pkg)``, the programs
    serialized alike."""
    progs = {pkg: build(pkg) for pkg in (fluid, pt)}
    assert progs[pt][0].to_dict() == progs[fluid][0].to_dict()
    assert progs[pt][1].to_dict() == progs[fluid][1].to_dict()
    return progs


def _raise_end_bias(scopes, name, end_id):
    for pkg, scope in scopes.items():
        b = np.array(scope.find_var(name), copy=True)
        b[end_id] += cs.BEAM_END_BIAS
        scope.set_var(name, b if pkg is fluid else torch.from_numpy(b))


def _decode_both(progs, scopes, feed):
    out, exe_pt = {}, pt.Executor(pt.CPUPlace())
    for pkg, exe in ((fluid, fluid.Executor(fluid.CPUPlace())),
                     (pt, exe_pt)):
        main, _, fetch = progs[pkg]
        out[pkg] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scopes[pkg])]
    ids, scores = out[pt]
    assert ids.dtype == np.int64
    np.testing.assert_array_equal(ids, out[fluid][0])
    np.testing.assert_allclose(scores, out[fluid][1], rtol=1e-5)
    return ids, scores, [n for _, n in exe_pt.loop_trips]


def test_attention_decoder_follows_jax_at_both_settings():
    """``chip_smoke.build_beam_decoder`` at a small width: random weights
    run all ``max_len`` trips, the raised end bias stops the loop after a
    few, and both give the JAX package's ids and scores."""
    progs = _both(lambda pkg: cs.build_beam_decoder(pkg, **SMALL))
    types = [op.type for op in progs[pt][0].global_block().ops]
    assert types.count("while") == 1
    body = [op.type for op in progs[pt][0].block(2).ops]
    assert "beam_search" in body and "one_hot" in body
    scopes = started_scopes(progs)
    feed = cs.beam_feed(4, SMALL["src_len"], SMALL["dict_dim"])
    ids, scores, trips = _decode_both(progs, scopes, feed)
    assert trips == [SMALL["max_len"]]
    assert ids.shape == (4, SMALL["beam"], SMALL["max_len"])
    assert (np.diff(scores, axis=1) <= 1e-5).all()
    _raise_end_bias(scopes, "score_b", SMALL["end_id"])
    ids, _, trips = _decode_both(progs, scopes, feed)
    assert trips[0] < SMALL["max_len"]
    # every beam ends, and past its end the frozen tail repeats end_id
    assert (ids[:, :, trips[0]:] == SMALL["end_id"]).all()


def rnn_decode(pkg, beam_size=3):
    """``tests/test_rnn_encoder_decoder.py``'s While-loop decoder: the
    previous ids embedded, the shared cell, ``beam_search``, the hidden
    state gathered by the parents, ids and parents written at the
    counter, ``beam_search_decode`` after the loop."""
    L, P, k = pkg.layers, pkg.ParamAttr, beam_size
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 42
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        src = L.data("src", shape=[1], dtype="int64", lod_level=1)
        emb = L.embedding(src, size=[V, D], param_attr=P(name="src_emb_w"))
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(emb)
            h_pre = drnn.memory(shape=[H], value=0.0)
            h = L.fc(L.concat([x_t, h_pre], axis=1), size=H, act="tanh",
                     param_attr=P(name="enc_fc_w"),
                     bias_attr=P(name="enc_fc_b"))
            drnn.update_memory(h_pre, h)
            drnn.output(h)
        enc_last = L.sequence_pool(drnn(), "last")

        def bsl(shape, value, dtype, out_dim=0):
            return L.fill_constant_batch_size_like(
                input=enc_last, shape=shape, dtype=dtype, value=value,
                input_dim_idx=0, output_dim_idx=out_dim)

        cur_ids = bsl([-1, k], BOS, "int64")
        init_scores = np.zeros((1, k), "float32")
        init_scores[0, 1:] = -1e9
        cur_scores = L.elementwise_add(bsl([-1, k], 0.0, "float32"),
                                       L.assign(init_scores))
        h = L.reshape(L.expand(L.unsqueeze(enc_last, axes=[1]),
                               expand_times=[1, k, 1]), shape=[0, k * H])
        ids_arr = bsl([TMAX, -1, k], 0, "int64", out_dim=1)
        par_arr = bsl([TMAX, -1, k], 0, "int64", out_dim=1)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=TMAX)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            e = L.embedding(L.reshape(cur_ids, shape=[-1, 1]), size=[V, D],
                            param_attr=P(name="tgt_emb_w"))
            h_new = L.fc(L.concat([e, L.reshape(h, shape=[-1, H])], axis=1),
                         size=H, act="tanh", param_attr=P(name="dec_fc_w"),
                         bias_attr=P(name="dec_fc_b"))
            logits = L.fc(h_new, size=V, act=None,
                          param_attr=P(name="out_fc_w"),
                          bias_attr=P(name="out_fc_b"))
            logp = L.log(L.softmax(logits))
            sel_ids, sel_scores, parent = L.beam_search(
                cur_ids, cur_scores, L.reshape(logp, shape=[-1, k, V]),
                beam_size=k, end_id=EOS)
            onehot = L.one_hot(L.unsqueeze(parent, axes=[2]), depth=k)
            h_sel = L.matmul(onehot, L.reshape(h_new, shape=[-1, k, H]))
            L.assign(L.reshape(h_sel, shape=[0, k * H]), output=h)
            L.assign(sel_ids, output=cur_ids)
            L.assign(sel_scores, output=cur_scores)
            L.assign(L.array_write(sel_ids, i, array=ids_arr),
                     output=ids_arr)
            L.assign(L.array_write(parent, i, array=par_arr),
                     output=par_arr)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond)
        sent, final = L.beam_search_decode(ids_arr, par_arr, cur_scores,
                                           beam_size=k, end_id=EOS)
    return main, startup, [sent, final]


def _copy_feed(rng, b):
    src = np.zeros((b, TMAX, 1), "int64")
    lens = rng.randint(2, TMAX + 1, b).astype("int32")
    for i, ln in enumerate(lens):
        src[i, :ln, 0] = rng.randint(2, V, ln)
    return {"src": src, "src@LEN": lens}


def test_rnn_decode_program_follows_jax():
    progs = _both(rnn_decode)
    scopes = started_scopes(progs)
    ids, _, trips = _decode_both(progs, scopes,
                                 _copy_feed(np.random.RandomState(3), 8))
    assert ids.shape == (8, 3, TMAX) and trips == [TMAX]


def _copy_batch(rng, b):
    rows = []
    for _ in range(b):
        ln = rng.randint(2, TMAX + 1)
        seq = rng.randint(2, V, (ln,)).astype("int64")
        rows.append((seq, np.concatenate([[BOS], seq[:-1]]).astype("int64"),
                     seq))
    return rows


def _cell(L, P, x, h_pre):
    return L.fc(L.concat([x, h_pre], axis=1), size=H, act="tanh",
                param_attr=P(name="dec_fc_w"), bias_attr=P(name="dec_fc_b"))


def _train_copy_task(build_decoder_cell, seed):
    """Adam(1e-2) for 600 steps of the copy task through the port, the
    decoder built by ``build_decoder_cell(temb, enc_last) -> logits``;
    returns (executor, scope, first and last loss)."""
    L, P = pt.layers, pt.ParamAttr
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup), pt.unique_name.guard():
        src, tgt, lbl = (L.data(n, shape=[1], dtype="int64", lod_level=1)
                         for n in ("src", "tgt", "lbl"))
        emb = L.embedding(src, size=[V, D], param_attr=P(name="src_emb_w"))
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(emb)
            h_pre = drnn.memory(shape=[H], value=0.0)
            h = L.fc(L.concat([x_t, h_pre], axis=1), size=H, act="tanh",
                     param_attr=P(name="enc_fc_w"),
                     bias_attr=P(name="enc_fc_b"))
            drnn.update_memory(h_pre, h)
            drnn.output(h)
        enc_last = L.sequence_pool(drnn(), "last")
        temb = L.embedding(tgt, size=[V, D], param_attr=P(name="tgt_emb_w"))
        logits = build_decoder_cell(temb, enc_last)
        cost = L.softmax_with_cross_entropy(logits, lbl)
        mask = L.padding_mask(tgt.block._find_var_recursive(
            tgt._seq_len_name), logits)
        loss = L.elementwise_div(
            L.reduce_sum(L.elementwise_mul(cost, L.unsqueeze(mask, [2]))),
            L.reduce_sum(mask))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        feeder = pt.DataFeeder(feed_list=[src, tgt, lbl], pad_to=TMAX)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = [float(np.asarray(exe.run(
        main, feed=feeder.feed(_copy_batch(rng, 16)), fetch_list=[loss],
        scope=scope)[0]).ravel()[0]) for _ in range(600)]
    return exe, scope, losses[0], losses[-1]


def _copied(exe, scope, program, fetch, rng):
    batch = _copy_batch(rng, 8)
    src = np.zeros((8, TMAX, 1), "int64")
    lens = np.zeros(8, "int32")
    for i, (s, _, _) in enumerate(batch):
        src[i, :len(s), 0] = s
        lens[i] = len(s)
    sv = exe.run(program, feed={"src": src, "src@LEN": lens},
                 fetch_list=fetch, scope=scope)[0]
    correct = sum(int((sv[i, 0, :len(s)] == s).sum())
                  for i, (s, _, _) in enumerate(batch))
    return correct / float(lens.sum())


def test_port_trains_then_decodes_the_source():
    """The port's own 600 copy-task steps, then its While-loop decoder
    with the trained weights: the top beam reproduces the source."""
    L, P = pt.layers, pt.ParamAttr

    def decoder(temb, enc_last):
        drnn = L.DynamicRNN()
        with drnn.block():
            e_t = drnn.step_input(temb)
            h_pre = drnn.memory(init=enc_last)
            h = _cell(L, P, e_t, h_pre)
            drnn.update_memory(h_pre, h)
            drnn.output(L.fc(h, size=V, param_attr=P(name="out_fc_w"),
                             bias_attr=P(name="out_fc_b")))
        return drnn()

    exe, scope, first, last = _train_copy_task(decoder, seed=42)
    assert last < first * 0.4, (first, last)
    main, _, fetch = rnn_decode(pt)
    assert _copied(exe, scope, main, fetch, np.random.RandomState(7)) > 0.7


def _contrib_decode(pkg, beam_size=3):
    """``tests/test_contrib_decoder.py``'s decode program through
    ``pkg``: the shared cell in a StateCell, BeamSearchDecoder scoring
    with softmax(out_fc)."""
    L, P = pkg.layers, pkg.ParamAttr
    import importlib
    dec = importlib.import_module(pkg.__name__ + ".contrib.decoder")
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        src = L.data("src", shape=[1], dtype="int64", lod_level=1)
        emb = L.embedding(src, size=[V, D], param_attr=P(name="src_emb_w"))
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(emb)
            h_pre = drnn.memory(shape=[H], value=0.0)
            h = L.fc(L.concat([x_t, h_pre], axis=1), size=H, act="tanh",
                     param_attr=P(name="enc_fc_w"),
                     bias_attr=P(name="enc_fc_b"))
            drnn.update_memory(h_pre, h)
            drnn.output(h)
        enc_last = L.sequence_pool(drnn(), "last")
        cell = dec.StateCell(inputs={"x": None},
                             states={"h": dec.InitState(init=enc_last)},
                             out_state="h")

        @cell.state_updater
        def _(c):
            c.set_state("h", _cell(L, P, c.get_input("x"), c.get_state("h")))

        ids0 = L.fill_constant_batch_size_like(enc_last, shape=[-1, 1],
                                               dtype="int64", value=BOS)
        sc0 = L.fill_constant_batch_size_like(enc_last, shape=[-1, 1],
                                              dtype="float32", value=0.0)
        d = dec.BeamSearchDecoder(
            state_cell=cell, init_ids=ids0, init_scores=sc0,
            target_dict_dim=V, word_dim=D, input_var_dict={}, topk_size=50,
            sparse_emb=False, max_len=TMAX, beam_size=beam_size, end_id=EOS,
            emb_param_attr=P(name="tgt_emb_w"),
            score_param_attr=P(name="out_fc_w"),
            score_bias_attr=P(name="out_fc_b"))
        d.decode()
        fetch = list(d())
    return main, startup, fetch


def test_contrib_decode_program_follows_jax():
    progs = _both(_contrib_decode)
    scopes = started_scopes(progs)
    feed = _copy_feed(np.random.RandomState(4), 8)
    ids, scores, trips = _decode_both(progs, scopes, feed)
    assert ids.shape == (8, 3, TMAX) and trips == [TMAX]
    _raise_end_bias(scopes, "out_fc_b", EOS)
    ids, _, trips = _decode_both(progs, scopes, feed)
    assert trips[0] < TMAX and (ids[:, :, trips[0]:] == EOS).all()


def test_contrib_decoder_trains_then_decodes_the_source():
    """TrainingDecoder drives the StateCell for 600 steps through the
    port; BeamSearchDecoder with the same cell and weights reproduces the
    source, best beam first."""
    L = pt.layers

    def decoder(temb, enc_last):
        cell = StateCell(inputs={"x": None},
                         states={"h": InitState(init=enc_last)},
                         out_state="h")
        cell.state_updater(lambda c: c.set_state("h", _cell(
            L, pt.ParamAttr, c.get_input("x"), c.get_state("h"))))
        tdec = TrainingDecoder(cell)
        with tdec.block():
            e_t = tdec.step_input(temb)
            tdec.state_cell.compute_state(inputs={"x": e_t})
            h = tdec.state_cell.get_state("h")
            tdec.state_cell.update_states()
            tdec.output(L.fc(h, size=V, param_attr=pt.ParamAttr(
                name="out_fc_w"), bias_attr=pt.ParamAttr(name="out_fc_b")))
        return tdec()

    exe, scope, first, last = _train_copy_task(decoder, seed=7)
    assert last < first * 0.4, (first, last)
    main, _, fetch = _contrib_decode(pt)
    assert _copied(exe, scope, main, fetch, np.random.RandomState(3)) > 0.7


def test_state_cell_validation():
    boot = pt.layers.data("b", shape=[4], dtype="float32")
    st = InitState(init_boot=boot, shape=[-1, 4], value=0.0)
    with pytest.raises(ValueError):
        StateCell(inputs={}, states={"h": st}, out_state="nope")
    with pytest.raises(ValueError):
        StateCell(inputs={}, states={"h": 3}, out_state="h")
    cell = StateCell(inputs={"x": None}, states={"h": st}, out_state="h")
    with pytest.raises(ValueError):
        cell.get_input("x")
    with pytest.raises(ValueError):
        cell.compute_state(inputs={"bogus": boot})


def test_state_cell_serves_two_decoders():
    """One StateCell drives a TrainingDecoder and then a
    BeamSearchDecoder."""
    L = pt.layers
    boot = L.data("b", shape=[H], dtype="float32")
    cell = StateCell(inputs={"x": None}, states={"h": InitState(init=boot)},
                     out_state="h")
    cell.state_updater(lambda c: c.set_state("h", _cell(
        L, pt.ParamAttr, c.get_input("x"), c.get_state("h"))))
    seq = L.data("seq", shape=[D], dtype="float32", lod_level=1)
    tdec = TrainingDecoder(cell)
    with tdec.block():
        tdec.state_cell.compute_state(inputs={"x": tdec.step_input(seq)})
        h = tdec.state_cell.get_state("h")
        tdec.state_cell.update_states()
        tdec.output(h)
    tdec()
    ii = L.fill_constant_batch_size_like(boot, shape=[-1, 1], dtype="int64",
                                         value=BOS)
    sc = L.fill_constant_batch_size_like(boot, shape=[-1, 1],
                                         dtype="float32", value=0.0)
    bdec = BeamSearchDecoder(cell, ii, sc, target_dict_dim=V, word_dim=D,
                             max_len=2, beam_size=2, end_id=EOS)
    bdec.decode()
    sent, _ = bdec()
    assert tuple(sent.shape) == (-1, 2, 2)


def test_training_decoder_block_discipline():
    boot = pt.layers.data("b", shape=[4], dtype="float32")
    cell = StateCell(inputs={"x": None}, states={"h": InitState(init=boot)},
                     out_state="h")
    dec = TrainingDecoder(cell)
    with pytest.raises(ValueError):
        dec.step_input(boot)
    with pytest.raises(ValueError):
        dec()


def test_beam_program_reads_nothing_on_the_host(host_read_guard):
    """Every op of the attention decoder, the loop body's included; the
    executor reads the loop's condition once a trip, outside every op."""
    main, startup, fetch = cs.build_beam_decoder(pt, **SMALL)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=cs.beam_feed(4, SMALL["src_len"], SMALL["dict_dim"]),
            fetch_list=fetch, scope=scope)
    # the lane penalty and the identity parents (``layers.assign`` of
    # numpy): device constants made once, as ``shape`` and ``fill`` are
    assert set(host_read_guard) <= {("assign_value", "torch.from_numpy")}
    assert exe.flag_reads == SMALL["max_len"]


def test_assign_value_is_a_device_constant(monkeypatch):
    """``assign_value`` (``layers.assign`` of numpy, which the decoder's
    lane penalty uses) makes its tensor through ``device_constant``: a
    copy from the host cannot go into a CUDA graph, so the card keeps one
    device copy and a capture clones it."""
    from paddle_tpu_torch.ops import creation

    made = []
    real = creation.device_constant

    def spy(array, device):
        made.append(np.array(array))
        return real(array, device)

    monkeypatch.setattr(creation, "device_constant", spy)
    penalty = np.asarray([[0.0, -1e9, -1e9]], "float32")
    out = pt.layers.assign(penalty)
    (got,) = pt.Executor(pt.CPUPlace()).run(fetch_list=[out])
    np.testing.assert_array_equal(got, penalty)
    assert len(made) == 1 and np.array_equal(made[0], penalty)
