"""The port's input pipeline held against the JAX package on the CPU:
the reader decorators (``tests/test_reader.py``'s cases), the
``bucket_by_length`` batches of a seeded stream, ``DataFeeder`` arrays
bit for bit (dtype included), and the ``DevicePrefetcher`` / ``PyReader``
lifecycle of ``tests/test_async_pipeline.py`` on ``CPUPlace()``.

The ``cuda``-marked test skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_reader.py``."""

import gc
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.reader import decorator as jax_dec

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import reader as rd
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.reader import DevicePrefetcher
from paddle_tpu_torch.reader import decorator as dec


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """Fresh port default programs, scope and name counter per test."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def _count_reader(n=10):
    def reader():
        yield from range(n)
    return reader


# ---------------------------------------------------------------------------
# decorators (tests/test_reader.py on the port)
# ---------------------------------------------------------------------------

def test_batch():
    b = rd.batch(_count_reader(10), 3)
    assert list(b()) == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    b = rd.batch(_count_reader(10), 3, drop_last=True)
    assert len(list(b())) == 3
    assert pt.batch is rd.batch


def test_shuffle_preserves_multiset():
    out = list(rd.shuffle(_count_reader(20), 5)())
    assert sorted(out) == list(range(20))


def test_chain_compose_firstn_map():
    c = rd.chain(_count_reader(3), _count_reader(2))
    assert list(c()) == [0, 1, 2, 0, 1]
    comp = rd.compose(_count_reader(3), _count_reader(3))
    assert list(comp()) == [(0, 0), (1, 1), (2, 2)]
    with pytest.raises(rd.decorator.ComposeNotAligned):
        list(rd.compose(_count_reader(3), _count_reader(2))())
    assert list(rd.compose(_count_reader(3), _count_reader(2),
                           check_alignment=False)()) == [(0, 0), (1, 1)]
    f = rd.firstn(_count_reader(100), 4)
    assert list(f()) == [0, 1, 2, 3]
    m = rd.map_readers(lambda a, b: a + b, _count_reader(3),
                       _count_reader(3))
    assert list(m()) == [0, 2, 4]


def test_buffered_and_xmap():
    out = list(rd.buffered(_count_reader(10), 2)())
    assert out == list(range(10))
    x = rd.xmap_readers(lambda v: v * 2, _count_reader(10), 3, 4)
    assert sorted(x()) == [2 * i for i in range(10)]
    xo = rd.xmap_readers(lambda v: v * 2, _count_reader(10), 3, 4,
                         order=True)
    assert list(xo()) == [2 * i for i in range(10)]


def test_cache():
    calls = []

    def creator():
        def reader():
            calls.append(1)
            yield from range(5)
        return reader

    cached = rd.cache(creator())
    assert list(cached()) == list(range(5))
    assert list(cached()) == list(range(5))
    assert len(calls) == 1


def test_checkpointable_reader_resumes_at_its_offset():
    r = rd.checkpointable(_count_reader(6))
    it = r()
    assert [next(it), next(it)] == [0, 1]
    state = r.state_dict()
    assert state == {"epoch": 0, "offset": 2}
    r2 = rd.CheckpointableReader(_count_reader(6))
    r2.load_state_dict(state)
    assert list(r2()) == [2, 3, 4, 5]
    assert r2.state_dict() == {"epoch": 1, "offset": 0}


def test_multiprocess_reader_worker_crash_raises():
    def good():
        yield from range(3)

    def bad():
        yield 100
        raise IOError("shard corrupt")

    assert sorted(dec.multiprocess_reader([good, good])()) \
        == [0, 0, 1, 1, 2, 2]
    with pytest.raises(RuntimeError, match="worker failed"):
        list(dec.multiprocess_reader([good, bad])())


def test_fake_reader_replays_first_epoch():
    calls = []

    def source():
        calls.append(1)
        for i in range(3):
            yield i

    fake = dec.Fake()
    r = fake(source, 7)
    assert list(r()) == [0, 1, 2, 0, 1, 2, 0]
    assert list(r()) == [0, 1, 2, 0, 1, 2, 0]
    assert len(calls) == 1
    with pytest.raises(ValueError, match="no samples"):
        list(dec.Fake()(lambda: iter(()), 5)())


def test_pipe_reader_lines(tmp_path):
    pr = dec.PipeReader("printf 'a\\nbb\\nccc'", bufsize=4)
    assert list(pr.get_line()) == ["a", "bb", "ccc"]
    with pytest.raises(TypeError):
        dec.PipeReader(["not", "a", "string"])
    with pytest.raises(TypeError):
        dec.PipeReader("cat x", file_type="zip")
    # a multi-byte character straddling the read buffer survives
    p = tmp_path / "my data.txt"
    p.write_text("abécd\n中文\n", encoding="utf-8")
    pr = dec.PipeReader('cat "%s"' % p, bufsize=3)
    assert list(pr.get_line()) == ["abécd", "中文"]


def test_creators(tmp_path):
    arr = np.arange(12).reshape(4, 3)
    rows = list(rd.creator.np_array(arr)())
    assert len(rows) == 4 and (rows[2] == arr[2]).all()
    p = tmp_path / "t.txt"
    p.write_text("x\ny\n")
    assert list(rd.creator.text_file(str(p))()) == ["x", "y"]
    with pytest.raises(NotImplementedError, match="A8"):
        rd.creator.recordio(["f"])
    with pytest.raises(NotImplementedError, match="A8"):
        rd.creator.open_recordio_files(["f"])


def _length_stream(seed, n=300, max_len=64):
    """bench.py's wmt16-like lengths: clip(lognormal(3.2, 0.55), 4, 64)."""
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            m = int(np.clip(rng.lognormal(3.2, 0.55), 4, max_len))
            yield (rng.randint(2, 100, (m, 1)).astype("int64"),)
    return reader


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("bounds,sizes", [
    ([16, 32, 48, 64], [32, 16, 11, 8]),       # bench.py's shape, scaled
    ([64, 16, 48, 32], [8, 32, 11, 16]),       # sizes sort with the bounds
    ([16, 32, 64], 5),
])
def test_bucket_by_length_matches_jax(bounds, sizes, drop_last):
    """The same (bound, samples) batches as the JAX package's, in the same
    order, the trailing partial batches flushed (or dropped)."""
    src = _length_stream(0)
    args = (lambda s: len(s[0]), bounds, sizes)
    want = list(jax_dec.bucket_by_length(src, *args, drop_last=drop_last)())
    got = list(dec.bucket_by_length(src, *args, drop_last=drop_last)())
    assert [(b, len(s)) for b, s in got] == [(b, len(s)) for b, s in want]
    for (_, gs), (_, ws) in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g[0], w[0])
    # every sample in the smallest bucket that holds it
    for bound, samples in got:
        lower = max([0] + [b for b in bounds if b < bound])
        assert all(lower < len(s[0]) <= bound for s in samples)
    if not drop_last:
        assert sum(len(s) for _, s in got) == 300


def test_bucket_by_length_refusals():
    r = _length_stream(1)
    with pytest.raises(ValueError, match="exceeds"):
        list(dec.bucket_by_length(r, lambda s: len(s[0]), [8], 2)())
    with pytest.raises(ValueError, match="must match"):
        dec.bucket_by_length(r, lambda s: len(s[0]), [8, 16], [2])
    with pytest.raises(ValueError, match="non-empty"):
        dec.bucket_by_length(r, lambda s: len(s[0]), [], 2)


# ---------------------------------------------------------------------------
# DataFeeder: bit for bit the JAX feeder's arrays
# ---------------------------------------------------------------------------

def _feeders(pad_to=None):
    """The same feed list declared in both packages: a dense float image,
    an int64 label, an int64 ragged sequence and a float32 ragged
    sequence of 3-vectors."""
    out = []
    for pkg in (fluid, pt):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            vs = [pkg.layers.data("img", shape=[2, 3]),
                  pkg.layers.data("label", shape=[1], dtype="int64"),
                  pkg.layers.data("w", shape=[1], dtype="int64",
                                  lod_level=1),
                  pkg.layers.data("v", shape=[3], lod_level=1)]
            out.append(pkg.DataFeeder(feed_list=vs, place=pkg.CPUPlace(),
                                      pad_to=pad_to))
    return out


def _rows(n=5, seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        t = rng.randint(1, 7)
        rows.append((rng.rand(6).tolist(), [int(rng.randint(0, 9))],
                     rng.randint(0, 50, t), rng.rand(t, 3)))
    return rows


@pytest.mark.parametrize("ctor_pad,call_pad", [(None, None), (None, 8),
                                               (7, None), (7, 9)])
def test_data_feeder_arrays_bit_identical(ctor_pad, call_pad):
    jf, tf = _feeders(ctor_pad)
    rows = _rows()
    want = jf.feed(rows, pad_to=call_pad)
    got = tf.feed(rows, pad_to=call_pad)
    assert sorted(got) == sorted(want) == ["img", "label", "v", "v@LEN",
                                           "w", "w@LEN"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    pad = call_pad or ctor_pad or max(len(r[2]) for r in rows)
    assert got["w"].shape == (5, pad, 1) and got["w@LEN"].dtype == np.int32
    assert got["img"].shape == (5, 2, 3)


def test_data_feeder_refusals_and_feed_parallel():
    jf, tf = _feeders(pad_to=3)
    with pytest.raises(ValueError, match="longer than pad_to"):
        tf.feed(_rows())
    with pytest.raises(ValueError, match="fields"):
        tf.feed([(1, 2)])
    jf, tf = _feeders()
    rows = _rows(6, seed=2)
    want = jf.feed_parallel(rows, num_places=3)
    got = tf.feed_parallel(rows, num_places=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            assert g[k].tobytes() == w[k].tobytes() and g[k].shape \
                == w[k].shape, k
    assert tf.pad_to is None


def test_feeder_and_prefetcher_default_to_the_card():
    """Without a place the prefetcher stages on ``CUDAPlace(0)``, never
    the CPU; ``shardings`` lands each feed as a rank's block of it (rank 1
    of a 2-rank dp mesh: the batch's second half).  No card is touched
    until the first batch is drawn."""
    x = pt.layers.data("x", shape=[2])
    feeder = pt.DataFeeder(feed_list=[x])
    assert feeder.prefetch(lambda: iter(()))._place == pt.CUDAPlace(0)
    assert DevicePrefetcher(lambda: iter(()))._place == pt.CUDAPlace(0)
    cpu = pt.DataFeeder(feed_list=[x], place=pt.CPUPlace())
    assert cpu.prefetch(lambda: iter(()))._place == pt.CPUPlace()
    from paddle_tpu_torch.parallel.mesh import PartitionSpec
    from paddle_tpu_torch.parallel.parallel_executor import Sharding

    half = Sharding(pt.make_mesh((2,)), PartitionSpec("dp"), 1)
    rows = [(np.full(2, i, "float32"),) for i in range(4)]
    with cpu.prefetch(lambda: iter([rows]), shardings={"x": half}) as pf:
        (got,) = list(pf)
    assert got["x"].tolist() == [[2.0, 2.0], [3.0, 3.0]]
    with DevicePrefetcher(lambda: iter([{"x": np.arange(4.0)}]),
                          place=pt.CPUPlace(), shardings=half) as pf:
        assert [b["x"].tolist() for b in pf] == [[2.0, 3.0]]


# ---------------------------------------------------------------------------
# DevicePrefetcher / PyReader lifecycle (tests/test_async_pipeline.py)
# ---------------------------------------------------------------------------

CPU = pt.CPUPlace()


def _feeds(n, batch=4):
    rng = np.random.RandomState(0)
    return [{"img": rng.rand(batch, 8).astype("float32"),
             "label": rng.randint(0, 4, (batch, 1)).astype("int64")}
            for _ in range(n)]


def test_prefetcher_converts_rows_with_its_feeder():
    img = pt.layers.data("img", shape=[8])
    label = pt.layers.data("label", shape=[1], dtype="int64")
    feeder = pt.DataFeeder(feed_list=[img, label], place=CPU)
    rng = np.random.RandomState(1)
    batches = [[(rng.rand(8).astype("float32"), [i]) for i in range(3)]
               for _ in range(4)]
    got = list(feeder.prefetch(lambda: iter(batches)))
    assert len(got) == 4
    for g, b in zip(got, batches):
        want = feeder.feed(b)
        assert all(g[k].tobytes() == want[k].tobytes() for k in want)


def test_prefetcher_exception_after_good_batches():
    def source():
        yield {"x": np.zeros(2, "float32")}
        yield {"x": np.ones(2, "float32")}
        raise RuntimeError("decode failed")

    pf = DevicePrefetcher(source, place=CPU, capacity=4)
    it = iter(pf)
    got = [next(it), next(it)]
    assert [g["x"][0] for g in got] == [0.0, 1.0]
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetcher_close_midstream_joins_producer():
    def source():
        for i in range(1000):
            yield {"x": np.full(2, i, "float32")}

    pf = DevicePrefetcher(source, place=CPU, capacity=1)
    it = iter(pf)
    assert next(it)["x"][0] == 0.0
    time.sleep(0.05)           # the producer blocks on the full queue
    pf.close()
    assert not pf._thread.is_alive()
    pf.close()                 # idempotent


def test_prefetcher_context_manager_abandoned_iteration():
    consumed = []
    with DevicePrefetcher(iter(_feeds(50)), place=CPU, capacity=2) as pf:
        for f in pf:
            consumed.append(f)
            if len(consumed) == 3:
                break
    assert len(consumed) == 3
    assert not pf._thread.is_alive()


def test_prefetcher_abandoned_iterator_stops_producer():
    pf = DevicePrefetcher(iter(_feeds(1000)), place=CPU, capacity=1)
    it = iter(pf)
    next(it)
    it.close()
    assert not pf._thread.is_alive()


def test_prefetcher_reiterable_with_callable_source():
    with DevicePrefetcher(lambda: iter(_feeds(4)), place=CPU,
                          capacity=2) as pf:
        epochs = [len(list(pf)), len(list(pf))]
    assert epochs == [4, 4]
    assert not pf._thread.is_alive()


def test_prefetcher_fresh_iter_supersedes_live_stream():
    pf = DevicePrefetcher(lambda: iter(_feeds(5)), place=CPU, capacity=2)
    it1 = iter(pf)
    first = next(it1)
    epoch2 = [f for f in pf]            # a fresh iter() mid-stream
    assert len(epoch2) == 5
    assert np.array_equal(epoch2[0]["img"], first["img"])
    del it1
    gc.collect()                         # the stale iterator: no effect
    assert len(list(pf)) == 5
    pf.close()


def test_prefetcher_enter_is_lazy_no_batch_loss():
    stream = iter(_feeds(5))
    with DevicePrefetcher(lambda: stream, place=CPU, capacity=2) as pf:
        got = list(pf)
    assert len(got) == 5


def test_prefetcher_second_live_iter_over_plain_iterator_raises():
    pf = DevicePrefetcher(iter(_feeds(5)), place=CPU, capacity=2)
    it1 = iter(pf)
    next(it1)
    with pytest.raises(RuntimeError, match="active iterator"):
        iter(pf)
    pf.close()


def test_prefetcher_exhausted_iterator_raises():
    pf = DevicePrefetcher(iter(_feeds(2)), place=CPU, capacity=2)
    assert len(list(pf)) == 2
    with pytest.raises(RuntimeError, match="exhausted"):
        iter(pf)


def test_prefetcher_reiterable_with_list_source():
    pf = DevicePrefetcher(_feeds(3), place=CPU, capacity=2)
    assert [len(list(pf)) for _ in range(3)] == [3, 3, 3]
    pf.close()


def test_prefetcher_two_unadvanced_iters_do_not_share_epoch():
    pf = DevicePrefetcher(lambda: iter(_feeds(6)), place=CPU, capacity=2)
    it1 = iter(pf)
    it2 = iter(pf)                   # supersedes it1 before its advance
    assert len(list(it2)) == 6
    assert list(it1) == []
    pf.close()

    pf2 = DevicePrefetcher(iter(_feeds(3)), place=CPU, capacity=2)
    it1 = iter(pf2)
    with pytest.raises(RuntimeError, match="active iterator"):
        iter(pf2)
    del it1
    gc.collect()
    assert len(list(pf2)) == 3


def test_prefetcher_unadvanced_iterator_leaks_no_thread():
    pf = DevicePrefetcher(iter(_feeds(50)), place=CPU, capacity=1)
    it = iter(pf)
    assert pf._thread is None        # the producer starts at next()
    del it
    gc.collect()
    assert pf._thread is None
    assert len(list(pf)) == 50


def test_prefetcher_threads_do_not_leak():
    before = threading.active_count()
    for _ in range(5):
        with DevicePrefetcher(iter(_feeds(10)), place=CPU, capacity=2) as pf:
            next(iter(pf))
    assert threading.active_count() <= before + 1


def _mlp(seed=7):
    prog, sprog = pt.Program(), pt.Program()
    with pt.program_guard(prog, sprog), pt.unique_name.guard():
        img = pt.layers.data("img", shape=[8])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        h = pt.layers.fc(img, size=8, act="relu")
        pred = pt.layers.fc(h, size=4, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    prog.random_seed = sprog.random_seed = seed
    return prog, sprog, loss, [img, label]


def test_pyreader_trains_and_matches_the_synchronous_feed():
    """``PyReader`` over a batched reader and a feeder: re-iterable one
    epoch at a time, and the same loss bits as feeding the feeder's
    arrays directly."""
    prog, sprog, loss, feed_vars = _mlp()
    feeder = pt.DataFeeder(feed_list=feed_vars, place=CPU)
    rng = np.random.RandomState(0)
    rows = [(rng.rand(8).astype("float32"), [int(rng.randint(0, 4))])
            for _ in range(48)]
    reader = rd.batch(lambda: iter(rows), 12)
    py_reader = rd.PyReader(capacity=2).decorate_batch_reader(
        reader, feeder, CPU)
    losses = {}
    for arm in ("sync", "prefetch"):
        scope, exe = pt.Scope(), pt.Executor(CPU)
        exe.run(sprog, scope=scope)
        losses[arm] = []
        for _ in range(3):
            feeds = (py_reader if arm == "prefetch"
                     else (feeder.feed(b) for b in reader()))
            for f in feeds:
                (lv,) = exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
                losses[arm].append(lv.tobytes())
    assert len(losses["sync"]) == 12
    assert losses["sync"] == losses["prefetch"]
    with pytest.raises(RuntimeError, match="decorate_batch_reader"):
        iter(rd.PyReader())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_capture_while_the_prefetcher_stages():
    """A captured executor fed through ``DevicePrefetcher`` (its producer
    staging batches on its side stream while the main thread captures
    the entry at its second run) gives the bits of a synchronous numpy
    feed: every loss and every parameter after 8 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the prefetcher stages on a card")
    card = pt.CUDAPlace(0)
    prog, sprog, loss, _ = _mlp()
    feeds = _feeds(8, batch=64)
    start = pt.Scope()
    pt.Executor(card).run(sprog, scope=start)
    out = {}
    for arm in ("sync", "prefetch"):
        scope = pt.Scope()
        for n in start.local_var_names():
            scope.set_var(n, start.var(n).clone())
        exe = pt.Executor(card)
        stream = (DevicePrefetcher(feeds, place=card, capacity=2)
                  if arm == "prefetch" else feeds)
        got = []
        for f in stream:
            if arm == "prefetch":
                assert f["img"].is_cuda
            (lv,) = exe.run(prog, feed=f, fetch_list=[loss], scope=scope,
                            return_numpy=False)
            got.append(lv)
        torch.cuda.synchronize()
        out[arm] = ([t.cpu() for t in got],
                    {n: scope.var(n).cpu() for n in scope.local_var_names()})
        assert len(exe._steps) == 1 and next(iter(
            exe._steps.values())).graph is not None
    (ls, ss), (lp, sp) = out["sync"], out["prefetch"]
    assert all(torch.equal(a, b) for a, b in zip(ls, lp))
    assert all(torch.equal(ss[n], sp[n]) for n in ss)
    assert len(ls) == 8
