"""Generation serving: continuous-batching prefill/decode over a
:class:`~.decoder.DecoderSpec` (counterpart of ``GenerationEngine`` in
``paddle_tpu/serving/engine.py``, fixed-region cache and greedy decoding).

Admitted prompts prefill into recycled cache slots (scattered
``kv_cache_write``); then one decode step advances every active slot by
one token, with the cache updated in place; a finished slot is refilled
between decode steps without draining the batch.  Per-request timeouts
expire queued work and evict wedged decodes, and a request whose logits
come out non-finite fails with :class:`~.scheduler.PoisonedRequestError`
while the engine keeps serving.

The engine runs on ``CUDAPlace(0)`` unless the caller passes a place; with
no place and no card it raises instead of falling back to the CPU.  Its
loop runs on its own thread, so ``torch.inference_mode()`` is entered
there: grad mode is thread-local in PyTorch.

Not ported yet: the paged cache, speculative decoding with a draft model,
int8 weights, the TunedConfig artifact, quarantine dumps, request tracing
and ``InferenceEngine``.
"""

import sys
import threading
import time

import numpy as np
import torch

from ..executor import CUDAPlace, Executor
from ..scope import Scope
from .metrics import ServingMetrics
from .scheduler import (ContinuousBatchingScheduler, PoisonedRequestError,
                        RequestTimeoutError)

__all__ = ["GenerationEngine"]


def _default_place(place):
    if place is not None:
        return place
    if not torch.cuda.is_available():
        raise RuntimeError(
            "GenerationEngine: no CUDA device is available; pass "
            "place=CPUPlace() to serve on the host")
    return CUDAPlace(0)


def _default_buckets(max_len):
    bounds, b = [], 8
    while b < max_len:
        bounds.append(b)
        b *= 2
    bounds.append(max_len)
    return bounds


class GenerationEngine:
    """Prefill/decode continuous batching over a decoder spec.

    The decode step is one program over every cache slot: inactive slots
    ride along masked (their writes land at position 0 of a free slot and
    are overwritten by the next prefill), so slot recycling changes host
    bookkeeping only.  Sampling is greedy argmax."""

    def __init__(self, spec, place=None, scope=None, eos_id=None,
                 max_new_tokens=32, timeout_s=60.0, bucket_bounds=None,
                 record_logits=False, start=True):
        self.spec = spec
        self.place = _default_place(place)
        self.eos_id = eos_id
        self.max_new_tokens = int(max_new_tokens)
        self.record_logits = bool(record_logits)
        self._exe = Executor(self.place)
        if scope is None:
            scope = Scope()
            spec.init_scope(self._exe, scope)
        self._scope = scope
        self._sched = ContinuousBatchingScheduler(
            spec.slots, bucket_bounds or _default_buckets(spec.max_len),
            default_timeout_s=timeout_s)
        self.metrics = ServingMetrics()
        self._active = {}             # slot -> decode state dict
        self._thread = None
        self._stop = threading.Event()
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
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
        self._active.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

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

    def _fail(self, req, error, status="failed"):
        self._sched.fail(req, error, status=status)
        self.metrics.note_failure(req, error, status=status)

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
        there."""
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

    def _poisoned(self, req, reason):
        self._fail(req, PoisonedRequestError(
            "request %s: %s" % (req.id, reason)), status="quarantined")
