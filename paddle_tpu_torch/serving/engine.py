"""Serving engines (counterpart of ``paddle_tpu/serving/engine.py``).

Two engines share the scheduler, the metrics and the loop thread
(``_EngineBase``):

* :class:`InferenceEngine` — one-shot forward serving of a saved inference
  model (an ``io.save_inference_model`` artifact) or of a live program and
  scope.  Requests are single examples or client micro-batches; the loop
  admits them into fixed slot batches, pads sequence feeds to bucket
  bounds, runs one ``Executor.run`` per batch and fans the fetches back
  out, trimmed to each request's own length.
* :class:`GenerationEngine` — prefill/decode serving of a
  :class:`~.decoder.DecoderSpec` with the fixed-region cache and greedy
  decoding: admitted prompts prefill into recycled cache slots (scattered
  ``kv_cache_write``), then one decode step advances every active slot by
  one token, with the cache updated in place; a finished slot is refilled
  between decode steps without draining the batch.

``quantize="weight_only"`` or ``"dynamic"`` rewrites the served programs to
int8 weights (``transpiler.quantize_inference``; kernel #7 on the card).
The int8 weights and their scales live in the engine's scope on the
engine's device.  An artifact saved after quantization loads cold and runs
int8 with no pass.

Per-request timeouts expire queued work and evict wedged decodes, and a
request whose outputs come out non-finite fails with
:class:`~.scheduler.PoisonedRequestError` (status ``quarantined``) while
the engine keeps serving.

The engines run on ``CUDAPlace(0)`` unless the caller passes a place; with
no place and no card they raise instead of falling back to the CPU.  On
the card each dispatch signature (a bucket of the one-shot program, the
prefill in each bucket, the decode step) replays a CUDA graph from its
second dispatch on (``Executor``); ``capture=False`` keeps every dispatch
eager, for comparison.  The loop runs on its own thread, so
``torch.inference_mode()`` is entered there: grad mode is thread-local in
PyTorch.

Not ported yet: the paged cache, speculative decoding with a draft model,
the TunedConfig artifact (``tuned_config=`` raises), quarantine dumps and
request tracing.
"""

import sys
import threading
import time

import numpy as np
import torch

from .. import io as pt_io
from ..executor import CUDAPlace, Executor
from ..scope import Scope, scope_guard
from .metrics import ServingMetrics
from .scheduler import (ContinuousBatchingScheduler, PoisonedRequestError,
                        RequestTimeoutError)

__all__ = ["InferenceEngine", "GenerationEngine"]


def _default_place(place, engine):
    if place is not None:
        return place
    if not torch.cuda.is_available():
        raise RuntimeError(
            "%s: no CUDA device is available; pass place=CPUPlace() to "
            "serve on the host" % engine)
    return CUDAPlace(0)


def _resolve_quantize(quantize, tuned_config):
    """The engine's quantization mode from the ``quantize`` kwarg: falsy =
    off, True = ``weight_only``, else the mode's name.  The JAX package
    can also take it from a TunedConfig ruling, which is not ported."""
    if tuned_config is not None:
        raise NotImplementedError(
            "the TunedConfig artifact (tuned_config=) is not ported yet; "
            "pass quantize= instead")
    if not quantize:
        return None
    return "weight_only" if quantize is True else str(quantize)


def _default_buckets(max_len):
    bounds, b = [], 8
    while b < max_len:
        bounds.append(b)
        b *= 2
    bounds.append(max_len)
    return bounds


def _finite_row(arrays, i, slots):
    """Whether request row ``i`` of every float fetch is finite."""
    for a in arrays:
        row = a[i] if a.ndim >= 1 and a.shape[0] == slots else a
        if np.issubdtype(row.dtype, np.floating) and \
                not np.isfinite(row).all():
            return False
    return True


class _EngineBase:
    """Loop-thread plumbing shared by both engines."""

    def __init__(self):
        self._thread = None
        self._stop = threading.Event()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="serving-loop", daemon=True)
            self._thread.start()
        return self

    def close(self):
        """Stop the loop and fail everything still in flight."""
        self._stop.set()
        self._sched.close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _fail(self, req, error, status="failed"):
        self._sched.fail(req, error, status=status)
        self.metrics.note_failure(req, error, status=status)

    def _poisoned(self, req, reason):
        self._fail(req, PoisonedRequestError(
            "request %s: %s" % (req.id, reason)), status="quarantined")

    def _loop(self):
        """Run iterations until close(); a failed iteration is logged and
        the loop keeps serving, so no queued caller is stranded."""
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    self._loop_once()
                except Exception as e:  # noqa: BLE001 — the loop must live
                    print("[serving] loop iteration failed: %r" % e,
                          file=sys.stderr, flush=True)
                    time.sleep(0.05)


class InferenceEngine(_EngineBase):
    """Continuous-batching server over one inference program.

    ``model_dir`` loads a ``save_inference_model`` artifact into a private
    scope on the engine's device; alternatively pass a live ``(program,
    feed_names, fetch_vars, scope)``.  ``slots`` is the fixed admission
    batch (default 8); ``bucket_bounds`` pads the time dim of sequence
    feeds (default: powers of two 8..1024 when the program has any)."""

    def __init__(self, model_dir=None, program=None, feed_names=None,
                 fetch_vars=None, scope=None, place=None, slots=None,
                 bucket_bounds=None, timeout_s=30.0, start=True,
                 quantize=None, tuned_config=None, capture=True):
        super().__init__()
        self.place = _default_place(place, "InferenceEngine")
        self._exe = Executor(self.place, capture=capture)
        if model_dir is not None:
            scope = Scope()
            with scope_guard(scope):
                program, feed_names, fetch_vars = \
                    pt_io.load_inference_model(model_dir, self._exe)
        if program is None or scope is None:
            raise ValueError(
                "InferenceEngine needs model_dir or a live "
                "(program, feed_names, fetch_vars, scope)")
        self._scope = scope
        self._feed_names = list(feed_names)
        self.quantize_mode = _resolve_quantize(quantize, tuned_config)
        if self.quantize_mode:
            from ..transpiler.quantize_pass import quantize_inference

            program = quantize_inference(program, scope=scope,
                                         mode=self.quantize_mode)
        self._program = program
        block = program.global_block()
        self._fetch_vars = [block.var(v.name if hasattr(v, "name") else v)
                            for v in fetch_vars]
        self.slots = int(slots or 8)
        # feed classification from the program's own var shapes: two
        # leading dynamic dims = a padded sequence (bucket the time dim)
        self._seq_feeds = set()
        self._len_feeds = {n for n in self._feed_names
                           if n.endswith("@LEN")}
        for n in self._feed_names:
            if n in self._len_feeds:
                continue
            v = block._find_var_recursive(n)
            shape = tuple(v.shape or ()) if v is not None else ()
            if len(shape) >= 2 and shape[0] in (-1, None) \
                    and shape[1] in (-1, None):
                self._seq_feeds.add(n)
        # fetches whose rows carry the padded time dim: trimmed back to
        # each request's length, so outputs match a direct dispatch
        self._seq_fetches = set()
        for j, v in enumerate(self._fetch_vars):
            shape = tuple(v.shape or ())
            if len(shape) >= 2 and shape[0] in (-1, None) \
                    and shape[1] in (-1, None):
                self._seq_fetches.add(j)
        if self._seq_feeds and not bucket_bounds:
            bucket_bounds = [2 ** i for i in range(3, 11)]
        self._sched = ContinuousBatchingScheduler(
            self.slots, bucket_bounds, default_timeout_s=timeout_s)
        self.metrics = ServingMetrics()
        if start:
            self.start()

    # -- client side -------------------------------------------------------
    def submit(self, feed, timeout_s=None, rows=1):
        """Enqueue one request: a single example (arrays without the batch
        dim; sequence feeds are [T, ...]) or, with ``rows`` > 1, a client
        micro-batch whose arrays carry a leading [rows, ...] dim.  Returns
        the request future."""
        for n in feed:
            if n not in self._feed_names and not n.endswith("@LEN"):
                raise ValueError("input %r is not a feed target (expected "
                                 "%s)" % (n, self._feed_names))
        missing = [n for n in self._feed_names
                   if n not in feed and not n.endswith("@LEN")]
        if missing:
            raise ValueError("missing inputs: %s" % missing)
        if rows > 1 and (self._seq_feeds or self._len_feeds):
            raise ValueError(
                "multi-row requests are fixed-shape only; submit "
                "variable-length sequences (or models with @LEN "
                "companions) one example per request")
        length = 0
        for n in self._seq_feeds:
            length = max(length, int(np.shape(feed[n])[0]))
        req = self._sched.submit(dict(feed), length=length,
                                 timeout_s=timeout_s, rows=rows)
        self.metrics.note_submit(req, self._sched.queue_depth())
        return req

    def run(self, feed, timeout=None):
        """Synchronous submit and wait; returns the request's fetch list
        (ordered like the saved fetch targets)."""
        return self.submit(feed).result(timeout)

    @property
    def feed_names(self):
        return list(self._feed_names)

    # -- loop side ---------------------------------------------------------
    def _loop_once(self):
        plan, expired = self._sched.admit()
        for r in expired:
            self.metrics.note_failure(r, r._error, status="expired")
        if plan is None:
            self._sched.wait_for_work(timeout=0.05)
            return
        try:
            self._run_batch(plan)
        except Exception as e:  # noqa: BLE001 — a failed batch must not
            for r in plan.requests:          # kill the engine
                if not r.done():
                    self._fail(r, e)

    def _pad_seq(self, arr, bucket):
        t = arr.shape[0]
        if bucket is None or t == bucket:
            return arr
        return np.pad(arr, [(0, bucket - t)] + [(0, 0)] * (arr.ndim - 1))

    def _run_batch(self, plan):
        reqs = plan.requests
        n_rows = sum(r.rows for r in reqs)
        self.metrics.note_admit(plan, n_rows / float(self.slots),
                                self._sched.queue_depth())
        feed = {}
        for name in self._feed_names:
            if name in self._len_feeds:
                base = name[:-len("@LEN")]
                # sequence requests are single-row (submit enforces it)
                lens = [int(r.payload.get(name, np.shape(r.payload[base])[0]))
                        for r in reqs]
                lens += [lens[0]] * (self.slots - n_rows)
                feed[name] = np.asarray(lens, "int32")
                continue
            rows = []
            for r in reqs:
                a = np.asarray(r.payload[name])
                if name in self._seq_feeds:
                    a = self._pad_seq(a, plan.bucket)
                rows.append(a if r.rows > 1 else a[None])
            batch = np.concatenate(rows)
            if n_rows < self.slots:
                # fixed slot batches: pad with copies of row 0
                batch = np.concatenate(
                    [batch, np.repeat(batch[:1], self.slots - n_rows, 0)])
            feed[name] = batch
        t0 = time.perf_counter()
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self._scope)
        self.metrics.note_dispatch("batch", time.perf_counter() - t0)
        off = 0
        for req in reqs:
            lo, hi = off, off + req.rows
            off = hi
            if not all(_finite_row(outs, i, self.slots)
                       for i in range(lo, hi)):
                self._poisoned(req, "non-finite outputs")
                continue
            result = []
            for j, o in enumerate(outs):
                if o.ndim < 1 or o.shape[0] != self.slots:
                    result.append(o)
                    continue
                row = o[lo:hi] if req.rows > 1 else o[lo]
                if j in self._seq_fetches and req.length \
                        and req.rows == 1 and row.ndim >= 1 \
                        and row.shape[0] == plan.bucket:
                    # trim the bucket padding off the time dim
                    row = row[:req.length]
                result.append(row)
            if self._sched.complete(req, result):
                self.metrics.note_complete(req)


class GenerationEngine(_EngineBase):
    """Prefill/decode continuous batching over a decoder spec.

    The decode step is one program over every cache slot: inactive slots
    ride along masked (their writes land at position 0 of a free slot and
    are overwritten by the next prefill), so slot recycling changes host
    bookkeeping only.  Sampling is greedy argmax.  ``quantize`` rewrites
    the spec's three programs to int8 weights over the engine's scope
    (``DecoderSpec.quantize``)."""

    def __init__(self, spec, place=None, scope=None, eos_id=None,
                 max_new_tokens=32, timeout_s=60.0, bucket_bounds=None,
                 record_logits=False, start=True, quantize=None,
                 tuned_config=None, capture=True):
        super().__init__()
        self.place = _default_place(place, "GenerationEngine")
        self.eos_id = eos_id
        self.max_new_tokens = int(max_new_tokens)
        self.record_logits = bool(record_logits)
        self._exe = Executor(self.place, capture=capture)
        if scope is None:
            scope = Scope()
            spec.init_scope(self._exe, scope)
        self._scope = scope
        # int8 decode: the three programs are rewritten over the SHARED
        # scope (one int8 copy per weight name)
        self.quantize_mode = _resolve_quantize(quantize, tuned_config)
        if self.quantize_mode:
            spec = spec.quantize(scope, mode=self.quantize_mode)
        self.spec = spec
        self._sched = ContinuousBatchingScheduler(
            spec.slots, bucket_bounds or _default_buckets(spec.max_len),
            default_timeout_s=timeout_s)
        self.metrics = ServingMetrics()
        self._active = {}             # slot -> decode state dict
        if start:
            self.start()

    def close(self):
        super().close()
        self._active.clear()

    # -- client side -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, timeout_s=None):
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens or self.max_new_tokens)
        if len(prompt) + max_new > self.spec.max_len:
            raise ValueError(
                "prompt %d + max_new_tokens %d exceeds the cache "
                "capacity %d" % (len(prompt), max_new, self.spec.max_len))
        req = self._sched.submit(
            {"prompt": prompt, "max_new": max_new},
            length=len(prompt), timeout_s=timeout_s)
        self.metrics.note_submit(req, self._sched.queue_depth())
        return req

    def generate(self, prompt_ids, max_new_tokens=None, timeout=None):
        """Synchronous generation; returns ``{"tokens": [...],
        "prompt_len": int}`` (plus per-step ``logits`` rows under
        ``record_logits``)."""
        return self.submit(prompt_ids, max_new_tokens).result(timeout)

    # -- loop side ---------------------------------------------------------
    def _loop_once(self):
        plan, expired = self._sched.admit()
        for r in expired:
            self.metrics.note_failure(r, r._error, status="expired")
        if plan is not None:
            try:
                self._prefill(plan)
            except Exception as e:  # noqa: BLE001
                for r in plan.requests:
                    if not r.done():
                        self._active.pop(r.slot, None)
                        self._fail(r, e)
        self._evict_expired_running()
        if self._active:
            try:
                self._decode_step()
            except Exception as e:  # noqa: BLE001 — fail the batch,
                for slot in list(self._active):    # keep the engine
                    self._fail(self._active.pop(slot)["req"], e)
        elif plan is None:
            self._sched.wait_for_work(timeout=0.05)

    def _evict_expired_running(self):
        for req in self._sched.expired_running():
            self._active.pop(req.slot, None)
            self._fail(req, RequestTimeoutError(
                "request %s evicted mid-decode after its timeout budget"
                % req.id), status="expired")

    def _run(self, program, feed, logits_var, rows):
        """One dispatch; returns the logits rows ``rows`` (an index into
        the leading dims) on the host as float32.  Only those rows leave
        the device: a prefill's full [slots, bucket, vocab] logits stay
        there (a captured dispatch clones them there first)."""
        (logits,) = self._exe.run(program, feed=feed,
                                  fetch_list=[logits_var], scope=self._scope,
                                  return_numpy=False)
        return logits[rows].float().cpu().numpy()

    def _prefill(self, plan):
        spec = self.spec
        reqs = plan.requests
        n, t, p = len(reqs), plan.bucket, spec.slots
        self.metrics.note_admit(plan, self._sched.occupancy(),
                                self._sched.queue_depth())
        tok = np.zeros((p, t, 1), "int64")
        lens = np.zeros((p,), "int32")
        slots = np.zeros((p,), "int32")
        for i, r in enumerate(reqs):
            prompt = r.payload["prompt"]
            tok[i, :len(prompt), 0] = prompt
            lens[i] = len(prompt)
            slots[i] = r.slot
        # fixed-signature padding: duplicate row 0 including its slot; the
        # duplicate write re-writes identical content
        for i in range(n, p):
            tok[i], lens[i], slots[i] = tok[0], lens[0], slots[0]
        pos = np.broadcast_to(
            np.arange(t, dtype="int64")[None, :, None], (p, t, 1)).copy()
        feed = {"tok": tok, "tok@LEN": lens, "pos": pos, "slot": slots,
                "wpos": np.zeros((p,), "int32")}
        t0 = time.perf_counter()
        last = (torch.arange(n), torch.from_numpy(lens[:n].astype("int64") - 1))
        rows = self._run(spec.prefill_program, feed, spec.prefill_logits,
                         last)
        self.metrics.note_dispatch("prefill", time.perf_counter() - t0)
        for i, r in enumerate(reqs):
            row = rows[i]
            if not np.isfinite(row).all():
                self._poisoned(r, "non-finite prefill logits")
                continue
            nxt = int(np.argmax(row))
            st = {"req": r, "generated": [nxt], "pos": int(lens[i]),
                  "max_new": r.payload["max_new"], "logits": []}
            if self.record_logits:
                st["logits"].append(row.copy())
            if self._finished(st, nxt):
                self._complete(r.slot, st)
            else:
                self._active[r.slot] = st

    def _decode_step(self):
        spec = self.spec
        s = spec.slots
        tok = np.zeros((s, 1, 1), "int64")
        pos = np.zeros((s, 1, 1), "int64")
        wpos = np.zeros((s,), "int32")
        clen = np.ones((s,), "int32")
        for slot, st in self._active.items():
            tok[slot, 0, 0] = st["generated"][-1]
            pos[slot, 0, 0] = st["pos"]
            wpos[slot] = st["pos"]
            clen[slot] = st["pos"] + 1
        feed = {"tok": tok, "pos": pos, "wpos": wpos, "cache_len": clen}
        t0 = time.perf_counter()
        logits = self._run(spec.decode_program, feed, spec.decode_logits,
                           (slice(None), 0))
        self.metrics.note_dispatch("decode", time.perf_counter() - t0)
        self.metrics.note_decode_step(len(self._active),
                                      self._sched.occupancy())
        for slot in list(self._active):
            st = self._active[slot]
            row = logits[slot]
            if not np.isfinite(row).all():
                self._active.pop(slot)
                self._poisoned(st["req"], "non-finite decode logits")
                continue
            nxt = int(np.argmax(row))
            st["generated"].append(nxt)
            st["pos"] += 1
            if self.record_logits:
                st["logits"].append(row.copy())
            if self._finished(st, nxt):
                self._active.pop(slot)
                self._complete(slot, st)

    def _finished(self, st, last_tok):
        return (len(st["generated"]) >= st["max_new"]
                or (self.eos_id is not None and last_tok == self.eos_id))

    def _complete(self, slot, st):
        req = st["req"]
        result = {"tokens": list(st["generated"]),
                  "prompt_len": len(req.payload["prompt"])}
        if self.record_logits:
            result["logits"] = st["logits"]
        if self._sched.complete(req, result):
            self.metrics.note_complete(req, len(st["generated"]))
