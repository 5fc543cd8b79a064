"""Profile-guided auto-configuration (counterpart of
``paddle_tpu/autotune.py``): each knob a pure decision function of
measurements plus a tuner that measures it on the card.

* **batch size** (:func:`run_batch_ladder` / :func:`tune_batch_size`):
  a geometric ladder.  A rung's peak memory is its eager warm-up's
  measured peak (``program_profile``'s ``warmup_peak_bytes``); from the
  third rung on the peak is projected linearly from the measured ones, and
  a projection over the ceiling stops the ladder before that rung
  dispatches anything.  A warm-up that runs out of memory anyway is the
  rung's rejection (``evidence: "oom_in_warmup"``): its memory is
  released and the ladder stops.  A surviving rung captures its step once
  (the window's warm-up run) and times a window of replays; the ladder
  stops when seconds per example regress.
* **kernel rulings** (:func:`tune_attention_kernel`,
  :func:`tune_quant_kernel`): kernel #1 against
  ``F.scaled_dot_product_attention``, kernel #7 (dynamic) against
  ``torch._int_mm``, measured at one shape each (the fastest of
  ``AB_WINDOWS`` windows an arm) and kept in a persistent
  :class:`AttentionDecisionTable` under ``FLAGS_autotune_dir``
  (``attention_decisions.json``, ``quant_kernel_decisions.json``), which
  a warm process reads and pays nothing for.  The JSON field keeps the
  JAX name ``pallas``: ``true`` is the hand kernel, ``false`` the library
  arm.  With no ruling the kernel runs.  Where no library call computes
  the function (#1 with dropout, #7 ``weight_only``) the tuner measures
  nothing and records ``{"pallas": true, "evidence": "no_library_arm"}``,
  and the ops run the kernel whatever the ruling.  The plain PyTorch
  versions never run on the card.
* **bucket bounds** (:func:`choose_bucket_bounds`), **checkpoint
  interval** (:func:`decide_checkpoint_interval` /
  :func:`tune_checkpoint_interval`, from the checkpoint manager's
  measured costs), **quantization** (:func:`tune_quantization`,
  :func:`tune_kv_quantization`, :func:`tune_speculation_k`: accuracy
  gates) and the **pipeline** schedule and microbatches
  (:func:`tune_pipeline`: each candidate measured through a
  ``ParallelExecutor`` on the ``pp`` mesh, :func:`decide_pipeline`).

Decisions land in a :class:`TunedConfig` (JSON, the JAX package's keys:
an artifact written by either package loads in the other), consumed by
``contrib.Trainer(autotune=)``, the serving engines' ``tuned_config=``
and ``tools/autotune_report.py``; every decision publishes
``autotune/*`` counters and ``autotune_decision`` / ``autotune_probe`` /
``autotune_applied`` events through the monitor.

``trace_token()`` digests the rulings in force; every executor entry is
keyed by it (``compile_cache.trace_flag_values``), so a changed ruling
captures its step again, once.  The port has no flag that selects a
kernel, so no pin blocks a ruling; a pinned ``FLAGS_quantize_mode`` is
the operator's choice, which the quantization tuner records and never
measures over.
"""

import contextlib
import gc
import json
import math
import os
import threading
import time

import numpy as np

from . import flags as _flags

__all__ = [
    "TunedConfig", "AttentionDecisionTable", "attention_table",
    "attention_choice", "attention_shape_key", "trace_token",
    "hbm_ceiling", "batch_ladder", "project_peak_hbm",
    "run_batch_ladder", "decide_attention_kernel", "token_fill",
    "choose_bucket_bounds", "decide_checkpoint_interval",
    "tune_batch_size", "tune_attention_kernel",
    "tune_checkpoint_interval", "measure_step_window",
    "decide_pipeline", "tune_pipeline",
    "quant_kernel_table", "quant_kernel_choice", "quant_shape_key",
    "decide_quant_kernel", "tune_quant_kernel",
    "decide_quantization", "tune_quantization",
]

_mu = threading.Lock()


def _flag(name, default):
    try:
        return _flags.flag(name)
    except KeyError:
        return default


def _event(record):
    from . import monitor

    ev = record.get("event")
    if ev == "autotune_decision":
        monitor.count("autotune/decisions")
    elif ev == "autotune_probe":
        monitor.count("autotune/probes")
    record.setdefault("ts", time.time())
    monitor.log_event(record)


# ---------------------------------------------------------------------------
# pure decision functions (the JAX package's, line for line)
# ---------------------------------------------------------------------------

def batch_ladder(start=32, max_batch=4096, factor=2):
    """Geometric candidate ladder: start, start*factor, ... <= max_batch."""
    start = max(1, int(start))
    out = []
    b = start
    while b <= max_batch:
        out.append(b)
        nxt = int(b * factor)
        b = nxt if nxt > b else b + 1
    return out


def project_peak_hbm(pairs, batch):
    """A batch's peak memory projected from measured (batch, peak_bytes)
    pairs by a least-squares line (activations scale with the batch, the
    state does not); None under two distinct batches."""
    pts = [(float(b), float(p)) for b, p in pairs if p]
    if len({b for b, _ in pts}) < 2:
        return None
    xs = np.array([b for b, _ in pts])
    ys = np.array([p for _, p in pts])
    slope, intercept = np.polyfit(xs, ys, 1)
    return float(intercept + slope * float(batch))


def run_batch_ladder(ladder, hbm_limit, probe_fn, measure_fn,
                     regress_tol=0.05, headroom=0.9):
    """The batch-size decision, pure in its callbacks:
    ``probe_fn(batch)`` -> the rung's peak bytes (or None),
    ``measure_fn(batch)`` -> seconds a step.  A rung whose projected peak
    exceeds ``headroom * hbm_limit`` stops the ladder unprobed, one whose
    probed peak exceeds it stops it unmeasured, one whose seconds per
    example regress by more than ``regress_tol`` stops it after its
    window.  Returns the decision (``chosen``: the best seconds per
    example, None when no rung survived)."""
    limit = float(hbm_limit) if hbm_limit else None
    ceiling = limit * float(headroom) if limit else None
    candidates = []
    peaks = []
    best = None
    for b in ladder:
        cand = {"batch": int(b)}
        if ceiling is not None:
            projected = project_peak_hbm(peaks, b)
            if projected is not None and projected > ceiling:
                cand.update(status="rejected_projected_hbm",
                            projected_peak_hbm_bytes=int(projected))
                candidates.append(cand)
                break
            peak = probe_fn(b)
            if peak:
                cand["peak_hbm_bytes"] = int(peak)
                peaks.append((b, peak))
                if peak > ceiling:
                    cand["status"] = "rejected_hbm"
                    candidates.append(cand)
                    break
        else:
            peak = probe_fn(b)
            if peak:
                cand["peak_hbm_bytes"] = int(peak)
                peaks.append((b, peak))
        step_s = measure_fn(b)
        spe = step_s / float(b)
        cand.update(step_s=round(step_s, 6),
                    s_per_example=spe, status="ok")
        candidates.append(cand)
        if best is not None and spe > best[0] * (1.0 + regress_tol):
            cand["status"] = "regressed"
            break
        if best is None or spe < best[0]:
            best = (spe, int(b), step_s)
    decision = {
        "knob": "batch_size",
        "chosen": best[1] if best else None,
        "candidates": candidates,
        "hbm_limit_bytes": int(limit) if limit else None,
        "headroom": headroom,
        "regress_tol": regress_tol,
        "evidence": "hbm_preflight_estimate+measured_step_window",
    }
    if best:
        decision["chosen_s_per_example"] = best[0]
        decision["chosen_step_s"] = round(best[2], 6)
    return decision


def decide_attention_kernel(xla_step_s, pallas_step_s, min_speedup=1.03):
    """The hand kernel (``pallas``) only where the measured A/B favors it
    by ``min_speedup`` over the library arm (``xla``); ties go to the
    library arm, as in the JAX package."""
    xla_step_s = float(xla_step_s)
    pallas_step_s = float(pallas_step_s)
    use_pallas = (pallas_step_s > 0
                  and xla_step_s / pallas_step_s >= float(min_speedup))
    return {"knob": "attention_kernel", "pallas": bool(use_pallas),
            "xla_step_s": round(xla_step_s, 6),
            "pallas_step_s": round(pallas_step_s, 6),
            "speedup": round(xla_step_s / pallas_step_s, 4)
            if pallas_step_s > 0 else None,
            "min_speedup": float(min_speedup),
            "evidence": "measured_ab_window"}


def _length_counts(lengths):
    """A length sample ({len: count} or ints) as a sorted (length, count)
    list."""
    if isinstance(lengths, dict):
        items = [(int(n), int(c)) for n, c in lengths.items() if c > 0]
    else:
        lengths = list(lengths)
        if lengths and isinstance(lengths[0], tuple):
            items = [(int(n), int(c)) for n, c in lengths if c > 0]
        else:
            counts = {}
            for n in lengths:
                counts[int(n)] = counts.get(int(n), 0) + 1
            items = list(counts.items())
    if not items or min(n for n, _ in items) < 1:
        raise ValueError("lengths must be a non-empty sample of "
                         "positive ints")
    return sorted(items)


def token_fill(lengths, bounds):
    """Real tokens over padded tokens when each sample pads to the
    smallest bound at or above its length (the top bound clamps)."""
    counts = _length_counts(lengths)
    bounds = sorted(int(b) for b in bounds)
    if not bounds:
        raise ValueError("bounds must be non-empty")
    real = padded = 0
    for n, c in counts:
        b = next((b for b in bounds if b >= n), bounds[-1])
        real += min(n, b) * c
        padded += b * c
    return real / float(padded)


def choose_bucket_bounds(lengths, k=4, multiple=16, max_len=None):
    """Up to ``k`` bounds, multiples of ``multiple``, that maximize the
    real-token fill of a length histogram (the top bound covers
    ``max_len``, default the sample's max), by the exact DP over the
    candidate multiples."""
    counts = _length_counts(lengths)
    sample_max = counts[-1][0]
    max_len = int(max_len or sample_max)
    if max_len < sample_max:
        raise ValueError("max_len %d below the sample's max length %d"
                         % (max_len, sample_max))
    multiple = max(1, int(multiple))
    top = int(math.ceil(max_len / float(multiple))) * multiple
    cands = list(range(multiple, top + 1, multiple))
    k = max(1, min(int(k), len(cands)))
    n = len(cands)
    pref = [0] * (n + 1)
    it = iter(counts)
    cur = next(it, None)
    for i, c in enumerate(cands):
        pref[i + 1] = pref[i]
        while cur is not None and cur[0] <= c:
            pref[i + 1] += cur[1]
            cur = next(it, None)

    def seg(h, i):
        return (pref[i] - pref[h]) * cands[i - 1]

    INF = float("inf")
    dp = [[INF] * (k + 1) for _ in range(n + 1)]
    parent = [[0] * (k + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dp[i][1] = seg(0, i)
        for j in range(2, min(k, i) + 1):
            for h in range(j - 1, i):
                cost = dp[h][j - 1] + seg(h, i)
                if cost < dp[i][j]:
                    dp[i][j] = cost
                    parent[i][j] = h
    best_j = min(range(1, k + 1), key=lambda j: dp[n][j])
    bounds = []
    i, j = n, best_j
    while j >= 1:
        bounds.append(cands[i - 1])
        i, j = parent[i][j], j - 1
    bounds.reverse()
    best_fill = token_fill(counts, bounds)
    return {"knob": "bucket_bounds",
            "chosen": bounds,
            "fill": round(best_fill, 4),
            "k": k, "multiple": multiple, "top_bound": top,
            "candidates_considered": len(cands),
            "pad_to_max_fill": round(token_fill(counts, [top]), 4),
            "evidence": "length_histogram_fill"}


def decide_checkpoint_interval(step_s, snapshot_s, save_s=0.0,
                               budget=None, async_save=True,
                               replay_step_s=None, min_interval=1,
                               max_interval=100000):
    """CheckFreq's cadence: the smallest interval whose on-step cost (the
    snapshot, plus the write when synchronous) stays under ``budget``
    (default ``FLAGS_autotune_overhead_budget``) of the compute, and in
    which an asynchronous write drains.  Monotone in every cost;
    ``replay_step_s`` (default ``step_s``) prices a rollback's replay of
    one interval, as evidence."""
    step_s = float(step_s)
    if step_s <= 0:
        raise ValueError("step_s must be positive")
    snapshot_s = max(0.0, float(snapshot_s))
    save_s = max(0.0, float(save_s))
    if budget is None:
        budget = float(_flag("autotune_overhead_budget", 0.035))
    budget = float(budget)
    if budget <= 0:
        raise ValueError("budget must be positive")
    on_step_cost = snapshot_s + (0.0 if async_save else save_s)
    interval = int(math.ceil(on_step_cost / (budget * step_s)))
    drain = int(math.ceil(save_s / step_s)) if async_save else 0
    interval = max(int(min_interval), interval, drain)
    interval = min(interval, int(max_interval))
    replay_step_s = float(replay_step_s if replay_step_s is not None
                          else step_s)
    return {"knob": "checkpoint_interval",
            "chosen": interval,
            "step_s": round(step_s, 6),
            "snapshot_s": round(snapshot_s, 6),
            "save_s": round(save_s, 6),
            "async_save": bool(async_save),
            "budget": budget,
            "overhead_frac": round(
                on_step_cost / (interval * step_s), 6),
            "drain_bound_steps": drain,
            "worst_case_replay_s": round(interval * replay_step_s, 6),
            "evidence": "measured_checkpoint_spans"}


def decide_pipeline(candidates, tol=0.03):
    """The pipeline policy over measured candidates (``schedule``,
    ``microbatches``, ``step_s``, ``bubble_fraction``, ``in_flight``,
    ``rejected``): the fastest, and within ``tol`` of it the least bubble,
    then in-flight bound, then fewer microbatches."""
    ok = [c for c in candidates
          if not c.get("rejected") and c.get("step_s")]
    if not ok:
        raise ValueError(
            "decide_pipeline: no measured candidate survived "
            "(all rejected by the HBM gate or unmeasured)")
    best = min(ok, key=lambda c: c["step_s"])
    near = [c for c in ok if c["step_s"] <= best["step_s"] * (1 + tol)]
    near.sort(key=lambda c: (c.get("bubble_fraction", 1.0),
                             c.get("in_flight", 1 << 30),
                             c["microbatches"]))
    chosen = near[0]
    return {"knob": "pipeline",
            "chosen": {"schedule": chosen["schedule"],
                       "microbatches": int(chosen["microbatches"])},
            "candidates": [dict(c) for c in candidates],
            "evidence": "measured_step_window"}


def decide_quant_kernel(xla_step_s, pallas_step_s, min_speedup=1.03):
    """The hand dequant-matmul kernel only where the measured A/B favors
    it by ``min_speedup`` over the library arm (ties to the library)."""
    xla_step_s = float(xla_step_s)
    pallas_step_s = float(pallas_step_s)
    use_pallas = (pallas_step_s > 0
                  and xla_step_s / pallas_step_s >= float(min_speedup))
    return {"knob": "quant_kernel", "pallas": bool(use_pallas),
            "xla_step_s": round(xla_step_s, 6),
            "pallas_step_s": round(pallas_step_s, 6),
            "speedup": round(xla_step_s / pallas_step_s, 4)
            if pallas_step_s > 0 else None,
            "min_speedup": float(min_speedup),
            "evidence": "measured_ab_window"}


def eval_delta(reference, outputs):
    """Relative L1 between two fetch lists (0: the same values): the
    quantization gate's metric."""
    num = den = 0.0
    for r, o in zip(reference, outputs):
        r = np.asarray(r, np.float64)
        o = np.asarray(o, np.float64)
        num += float(np.abs(o - r).sum())
        den += float(np.abs(r).sum())
    return num / (den + 1e-12)


def decide_quantization(fp_step_s, candidates, budget,
                        min_speedup=1.0, batch=None):
    """The quantization policy: a candidate (``mode``,
    ``accuracy_delta``, ``step_s`` or ``rejected``) survives under
    ``budget`` and at least ``min_speedup`` over full precision; the
    fastest survivor is chosen, else full precision (``chosen`` None).
    Rejections stay in the candidate table."""
    fp_step_s = float(fp_step_s)
    ok = []
    cands = [dict(c) for c in candidates]
    for c in cands:
        if c.get("rejected"):
            continue
        delta = float(c.get("accuracy_delta", np.inf))
        step_s = float(c.get("step_s") or 0.0)
        speedup = fp_step_s / step_s if step_s > 0 else 0.0
        c["speedup_vs_fp"] = round(speedup, 4)
        if delta > float(budget):
            c["status"] = "rejected_accuracy"
            continue
        if speedup < float(min_speedup):
            c["status"] = "rejected_slower"
            continue
        c["status"] = "ok"
        ok.append(c)
    chosen = min(ok, key=lambda c: c["step_s"]) if ok else None
    decision = {"knob": "quantization",
                "chosen": chosen["mode"] if chosen else None,
                "fp_step_s": round(fp_step_s, 6),
                "accuracy_budget": float(budget),
                "min_speedup": float(min_speedup),
                "candidates": cands,
                "evidence": "measured_ab_window+eval_delta"}
    if batch:
        decision["fp_tok_s"] = round(batch / fp_step_s, 2)
    if chosen:
        decision["accuracy_delta"] = chosen["accuracy_delta"]
        decision["chosen_step_s"] = chosen["step_s"]
        if batch:
            decision["chosen_tok_s"] = round(batch / chosen["step_s"], 2)
    return decision


# ---------------------------------------------------------------------------
# TunedConfig artifact
# ---------------------------------------------------------------------------

class TunedConfig:
    """The tuner's artifact: decisions with their evidence, as JSON
    (``meta`` and ``decisions``, the JAX package's layout)."""

    VERSION = 1

    def __init__(self, decisions=None, meta=None):
        self.decisions = list(decisions or [])
        self.meta = dict(meta or {})
        self.meta.setdefault("version", self.VERSION)
        if "run_id" not in self.meta:
            from . import monitor

            self.meta["run_id"] = monitor.run_id()
        self.meta.setdefault("created_ts", time.time())

    def add(self, decision, fingerprint=None, source="measured"):
        """Append one decision dict, stamped with its provenance."""
        d = dict(decision)
        if fingerprint:
            d["fingerprint"] = fingerprint
        d.setdefault("source", source)
        self.decisions.append(d)
        _event({"event": "autotune_decision", "knob": d.get("knob"),
                "chosen": d.get("chosen", d.get("pallas")),
                "source": d.get("source"),
                "fingerprint": d.get("fingerprint")})
        return d

    def get(self, knob):
        """The last decision for ``knob``, or None."""
        for d in reversed(self.decisions):
            if d.get("knob") == knob:
                return d
        return None

    def value(self, knob, default=None):
        d = self.get(knob)
        if d is None:
            return default
        return d.get("chosen", d.get("pallas", default))

    def as_dict(self):
        return {"meta": dict(self.meta),
                "decisions": [dict(d) for d in self.decisions]}

    def save(self, path):
        """Atomic JSON write; returns ``path``."""
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            doc = json.load(f)
        return cls(decisions=doc.get("decisions", []),
                   meta=doc.get("meta", {}))

    def apply(self):
        """Install the kernel rulings into the process tables and list
        each decision's outcome: ``applied``, ``pinned`` (a pinned
        ``FLAGS_quantize_mode`` wins over a quantization ruling) or
        ``advisory`` (read from the artifact by its consumer: batch size,
        bucket bounds, checkpoint interval, quantization)."""
        outcomes = []
        for d in self.decisions:
            knob = d.get("knob")
            if knob in ("attention_kernel", "quant_kernel") \
                    and d.get("shape"):
                table = attention_table() if knob == "attention_kernel" \
                    else quant_kernel_table()
                table.record(d.get("fingerprint") or "", d["shape"],
                             bool(d.get("pallas")), d, persist=False)
                outcomes.append((knob, "applied"))
            elif knob == "quantization" \
                    and _flags.pinned("quantize_mode"):
                outcomes.append((knob, "pinned"))
            else:
                outcomes.append((knob, "advisory"))
        _event({"event": "autotune_applied",
                "outcomes": [list(o) for o in outcomes]})
        return outcomes


# ---------------------------------------------------------------------------
# persistent kernel-ruling tables
# ---------------------------------------------------------------------------

def _dtype_name(dtype):
    """``float32`` / ``bfloat16`` for a torch dtype, numpy dtype or
    string (the JAX package's shape-key spelling)."""
    if isinstance(dtype, str):
        return dtype
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    return np.dtype(dtype).name


def attention_shape_key(q_shape, k_shape, dtype):
    """(Tq, Tk, d, dtype): batch and heads do not change the ruling's
    regime."""
    return "T%d:K%d:d%d:%s" % (int(q_shape[2]), int(k_shape[2]),
                               int(q_shape[3]), _dtype_name(dtype))


def quant_shape_key(m, k, n, dtype, mode="weight_only"):
    """The dequant-matmul GEMM dims, activation dtype and mode."""
    return "M%d:K%d:N%d:%s:%s" % (int(m), int(k), int(n),
                                  _dtype_name(dtype), mode)


class AttentionDecisionTable:
    """Per-shape rulings keyed by ``fingerprint[:12] + "|" + shape key``,
    kept as JSON under ``FLAGS_autotune_dir`` (in memory only when it is
    unset); the quant-kernel table is the same class with its own file.
    A lookup falls back to the newest ruling at the shape under any
    fingerprint.  ``content_token`` digests the rulings for
    ``trace_token``, rebuilt once a mutation."""

    FILENAME = "attention_decisions.json"

    def __init__(self, dirname=None, filename=None):
        self._dir = dirname
        self._filename = filename or self.FILENAME
        self._entries = {}
        self._loaded = False
        self._token = None
        self._mu = threading.Lock()

    def _path(self):
        d = self._dir if self._dir is not None \
            else str(_flag("autotune_dir", "") or "")
        return os.path.join(d, self._filename) if d else None

    def _load_locked(self):
        if self._loaded:
            return
        self._loaded = True
        path = self._path()
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            entries = doc.get("entries", {})
            if isinstance(entries, dict):
                # the running process's rulings win over the file's
                merged = dict(entries)
                merged.update(self._entries)
                self._entries = merged
                self._token = None
        except (ValueError, OSError):
            # a torn write: measure again rather than trust it
            self._entries = dict(self._entries)

    def _persist_locked(self):
        path = self._path()
        if not path:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"entries": self._entries}, f, indent=2,
                      sort_keys=True)
        os.replace(tmp, path)

    @staticmethod
    def _key(fingerprint, shape_key):
        return "%s|%s" % ((fingerprint or "")[:12], shape_key)

    def lookup(self, fingerprint, shape_key):
        """The entry for (fingerprint, shape), else the newest at the
        shape, else None."""
        with self._mu:
            self._load_locked()
            e = self._entries.get(self._key(fingerprint, shape_key))
            if e is not None:
                return dict(e)
            suffix = "|" + shape_key
            newest = None
            for k, v in self._entries.items():
                if k.endswith(suffix) and (
                        newest is None
                        or v.get("ts", 0) >= newest.get("ts", 0)):
                    newest = v
            return dict(newest) if newest else None

    def record(self, fingerprint, shape_key, pallas, evidence=None,
               persist=True):
        entry = {"pallas": bool(pallas), "shape": shape_key,
                 "fingerprint": (fingerprint or "")[:12],
                 "ts": time.time()}
        if evidence:
            entry["evidence"] = {
                k: evidence[k] for k in ("xla_step_s", "pallas_step_s",
                                         "speedup", "min_speedup",
                                         "source")
                if k in evidence}
        with self._mu:
            self._load_locked()
            self._entries[self._key(fingerprint, shape_key)] = entry
            self._token = None
            if persist:
                self._persist_locked()
        return entry

    def entries(self):
        with self._mu:
            self._load_locked()
            return {k: dict(v) for k, v in self._entries.items()}

    def content_token(self):
        t = self._token
        if t is not None:
            return t
        with self._mu:
            self._load_locked()
            if self._token is None:
                self._token = tuple(sorted(
                    (k, bool(v.get("pallas"))) for k, v in
                    self._entries.items()))
            return self._token

    def clear(self):
        with self._mu:
            self._entries.clear()
            self._loaded = True
            self._token = None


_table = [None]
_qtable = [None]
QUANT_FILENAME = "quant_kernel_decisions.json"
# (kind, shape key) -> the arm an A/B is measuring (see _forced_arm)
_FORCED = {}


def attention_table():
    """The process-global attention-kernel table."""
    with _mu:
        if _table[0] is None:
            _table[0] = AttentionDecisionTable()
        return _table[0]


def quant_kernel_table():
    """The process-global dequant-matmul table (its own file)."""
    with _mu:
        if _qtable[0] is None:
            _qtable[0] = AttentionDecisionTable(filename=QUANT_FILENAME)
        return _qtable[0]


def _active(slot, make):
    # the instantiated table, or a lazily loaded one when
    # FLAGS_autotune_dir names a directory (setting it is the opt-in: a
    # fresh process reads the warm rulings); None when neither
    t = slot[0]
    if t is not None:
        return t
    if str(_flag("autotune_dir", "") or ""):
        return make()
    return None


def reset_attention_table():
    """Drop the process table (tests); the file stays."""
    with _mu:
        _table[0] = None


def reset_quant_kernel_table():
    with _mu:
        _qtable[0] = None


@contextlib.contextmanager
def _forced_arm(kind, shape_key, pallas):
    """Run an A/B arm: ``kind`` ("attention" / "quant") at ``shape_key``
    takes ``pallas`` whatever the tables say."""
    _FORCED[kind, shape_key] = bool(pallas)
    try:
        yield
    finally:
        _FORCED.pop((kind, shape_key), None)


def trace_token():
    """The rulings in force (both tables and any A/B arm), folded into
    every executor entry's key (``compile_cache.trace_flag_values``).
    An empty tuple when there is none."""
    if _table[0] is None and _qtable[0] is None and not _FORCED \
            and not _flags.flag("autotune_dir"):
        return ()      # no table: the common case, on every run
    parts = ()
    t = _active(_table, attention_table)
    if t is not None:
        parts += (("attention",) + t.content_token(),)
    q = _active(_qtable, quant_kernel_table)
    if q is not None:
        parts += (("quant",) + q.content_token(),)
    if _FORCED:
        parts += (("forced",) + tuple(sorted(_FORCED.items())),)
    return parts


def _choice(kind, slot, make, key):
    forced = _FORCED.get((kind, key)) if _FORCED else None
    if forced is not None:
        return forced
    t = _active(slot, make)
    if t is None:
        return None
    e = t.lookup("", key)
    return None if e is None else bool(e["pallas"])


def attention_choice(q_shape, k_shape, dtype):
    """The ruling for this attention shape (True: kernel #1, False: the
    library arm) or None; read by ``fused_attention`` and
    ``paged_attention`` on the card."""
    return _choice("attention", _table, attention_table,
                   attention_shape_key(q_shape, k_shape, dtype))


def quant_kernel_choice(m, k, n, dtype, mode="weight_only"):
    """The ruling for this dequant-matmul shape (True: kernel #7, False:
    the library arm) or None; read by ``dequant_matmul`` on the card."""
    return _choice("quant", _qtable, quant_kernel_table,
                   quant_shape_key(m, k, n, dtype, mode))


# ---------------------------------------------------------------------------
# the tuners, measured on the card
# ---------------------------------------------------------------------------

def hbm_ceiling(device=None):
    """The tuner's memory ceiling in bytes: ``FLAGS_autotune_hbm_bytes``,
    else ``FLAGS_preflight_hbm_bytes``, else the card's total
    (``torch.cuda.mem_get_info``); None off the card."""
    override = int(_flag("autotune_hbm_bytes", 0))
    if override > 0:
        return override
    pre = int(_flag("preflight_hbm_bytes", 0))
    if pre > 0:
        return pre
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(dev)[1])


def _release(place):
    """Free what dropped executors and scopes held on the card."""
    gc.collect()
    if place.device.type == "cuda":
        import torch

        torch.cuda.synchronize(place.device)
        torch.cuda.empty_cache()


def measure_step_window(exe, program, feed, fetch_list, steps=4,
                        warmup=1, scope=None):
    """Seconds a step over a window: the feed staged on the device once,
    ``warmup`` runs (on the card an entry's second run captures its
    graph), then ``steps`` runs (replays) closed by one synchronize."""
    from .executor import _as_tensor

    dev = exe.place.device
    staged = {k: _as_tensor(v).to(dev) for k, v in feed.items()}
    for _ in range(max(0, warmup)):
        exe.run(program, feed=staged, fetch_list=fetch_list, scope=scope,
                return_numpy=False)
    exe.sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        exe.run(program, feed=staged, fetch_list=fetch_list, scope=scope,
                return_numpy=False)
    exe.sync()
    return (time.perf_counter() - t0) / float(steps)


# windows an A/B arm times, keeping the fastest: a host stall (a
# collection, another thread) in one window must not decide a ruling
AB_WINDOWS = 3


def _ab_window(exe, program, feed, fetch_list, steps, warmup, scope):
    """The fastest of ``AB_WINDOWS`` ``measure_step_window`` windows (the
    first with the warm-up runs)."""
    best = measure_step_window(exe, program, feed, fetch_list, steps=steps,
                               warmup=warmup, scope=scope)
    for _ in range(AB_WINDOWS - 1):
        best = min(best, measure_step_window(
            exe, program, feed, fetch_list, steps=steps, warmup=0,
            scope=scope))
    return best


@contextlib.contextmanager
def _probe_run(place):
    """A fresh scope and executor whose steps are probe work
    (``program_profile.probe_accounting``: kept out of the per-program
    report, and each entry's warm-up peak recorded)."""
    from . import scope as _scope
    from .executor import Executor
    from .monitor import program_profile

    s = _scope.Scope()
    with _scope.scope_guard(s), program_profile.probe_accounting():
        yield Executor(place), s


def _feed_sig(block, feed):
    """The executor's profile signature of ``feed``."""
    from .executor import _as_tensor

    sig = []
    for n in sorted(feed):
        t = _as_tensor(feed[n])
        v = block._find_var_recursive(n)
        dt = v.dtype if v is not None and v.dtype is not None else t.dtype
        sig.append((n, tuple(t.shape), str(dt)))
    return tuple(sig)


def _graphs(exe):
    return sum(st.graphs for st in exe._steps.values())


def tune_batch_size(main_program, startup_program, make_feed, fetch,
                    place=None, ladder=None, start=32, max_batch=4096,
                    probe_steps=4, warmup_steps=1, regress_tol=0.05,
                    headroom=0.9, config=None):
    """Tune the batch of one program (see :func:`run_batch_ladder`).
    ``make_feed(batch)`` builds a rung's feed.  Each rung runs in an
    executor of its own over one probe scope: its eager warm-up gives the
    peak, the window's warm-up captures the step once and the window
    replays it.  Each measured candidate carries ``captures`` (the graphs
    its executor captured).  Appends the decision to ``config`` when
    given; returns it."""
    import torch

    from . import compile_cache
    from .executor import CUDAPlace, Executor
    from .framework import Variable
    from .monitor import program_profile

    place = place if place is not None else CUDAPlace(0)
    fetch_list = [fetch]
    fetch_names = (fetch.name if isinstance(fetch, Variable)
                   else str(fetch),)
    fp = compile_cache.program_fingerprint(main_program)
    block = main_program.global_block()
    rung = {}            # the executor of the rung in flight
    captures, oom = {}, []
    with _probe_run(place) as (exe, scope):
        exe.run(startup_program, scope=scope)
        del exe
        limit = hbm_ceiling(place.device)

        def probe_fn(b):
            rung.clear()
            _release(place)
            feed = make_feed(b)
            exe = rung["exe"] = Executor(place)
            failed = False
            try:
                exe.run(main_program, feed=feed, fetch_list=fetch_list,
                        scope=scope, return_numpy=False)
                exe.sync()
            except torch.cuda.OutOfMemoryError:
                if not limit:
                    raise
                failed = True
            if failed:
                # outside the handler, whose traceback holds the tensors
                rung.clear()
                del exe
                _release(place)
                oom.append(b)
                _event({"event": "autotune_probe", "knob": "batch_size",
                        "batch": int(b), "evidence": "oom_in_warmup",
                        "fingerprint": fp[:12]})
                return int(limit) + 1
            prof = program_profile.get(fp, _feed_sig(block, feed),
                                       kind="executor",
                                       fetch_names=fetch_names)
            peak = prof.warmup_peak_bytes if prof is not None else None
            _event({"event": "autotune_probe", "knob": "batch_size",
                    "batch": int(b), "peak_hbm_bytes": peak,
                    "fingerprint": fp[:12]})
            return peak

        def measure_fn(b):
            exe = rung["exe"]
            step_s = measure_step_window(exe, main_program, make_feed(b),
                                         fetch_list, steps=probe_steps,
                                         warmup=warmup_steps, scope=scope)
            captures[b] = _graphs(exe)
            return step_s

        decision = run_batch_ladder(
            ladder or batch_ladder(start, max_batch), limit,
            probe_fn, measure_fn, regress_tol=regress_tol,
            headroom=headroom)
        rung.clear()
    _release(place)
    for cand in decision["candidates"]:
        if cand["batch"] in captures:
            cand["captures"] = captures[cand["batch"]]
        if cand["batch"] in oom:
            cand.pop("peak_hbm_bytes", None)
            cand["evidence"] = "oom_in_warmup"
    if config is not None:
        config.add(decision, fingerprint=fp[:12])
    else:
        _event({"event": "autotune_decision", "knob": "batch_size",
                "chosen": decision["chosen"], "fingerprint": fp[:12]})
    return decision


def _cached_ruling(knob, table, fp, key, config):
    """A ruling the table already holds, as a decision (None if none)."""
    cached = table.lookup(fp, key)
    if cached is None:
        return None
    decision = {"knob": knob, "shape": key,
                "pallas": bool(cached["pallas"]),
                "evidence": "decision_table", "cached": True}
    decision.update(cached.get("evidence") or {})
    if config is not None:
        config.add(decision, fingerprint=fp[:12], source="cached")
    return decision


def _no_arm(knob, table, fp, key, config):
    """Record that no library call computes the function at ``key``: the
    kernel stays, nothing is measured."""
    decision = {"knob": knob, "shape": key, "pallas": True,
                "evidence": "no_library_arm"}
    table.record(fp, key, True, decision)
    if config is not None:
        config.add(decision, fingerprint=fp[:12])
    return decision


def _attention_has_arm(program):
    """SDPA computes ``fused_attention`` unless it drops weights: an op
    training with dropout has no library arm."""
    for blk in program.blocks:
        for op in blk.ops:
            if op.type == "fused_attention" \
                    and float(op.attrs.get("dropout_rate", 0.0)) \
                    and not op.attrs.get("is_test", False):
                return False
    return True


def tune_attention_kernel(main_program, startup_program, feed, fetch,
                          place=None, shape=None, probe_steps=4,
                          warmup_steps=1, min_speedup=1.03, table=None,
                          config=None):
    """Kernel #1 against ``F.scaled_dot_product_attention`` at one shape
    (``(q_shape, k_shape, dtype)`` or a shape key): each arm forced in a
    probe executor of its own, a measured window each, the ruling kept in
    the table (a warm table answers with no measurement)."""
    from . import compile_cache
    from .executor import CUDAPlace

    place = place if place is not None else CUDAPlace(0)
    key = shape if isinstance(shape, str) else attention_shape_key(*shape)
    table = table or attention_table()
    fp = compile_cache.program_fingerprint(main_program)
    cached = _cached_ruling("attention_kernel", table, fp, key, config)
    if cached is not None:
        return cached
    if not _attention_has_arm(main_program):
        return _no_arm("attention_kernel", table, fp, key, config)
    fetch_list = [fetch]
    measured = {}
    for pallas in (False, True):
        with _forced_arm("attention", key, pallas), \
                _probe_run(place) as (exe, scope):
            exe.run(startup_program, scope=scope)
            measured[pallas] = _ab_window(
                exe, main_program, feed, fetch_list, probe_steps,
                warmup_steps, scope)
        _release(place)
        _event({"event": "autotune_probe", "knob": "attention_kernel",
                "shape": key, "pallas": pallas,
                "step_s": round(measured[pallas], 6)})
    decision = decide_attention_kernel(measured[False], measured[True],
                                       min_speedup=min_speedup)
    decision["shape"] = key
    table.record(fp, key, decision["pallas"], decision)
    if config is not None:
        config.add(decision, fingerprint=fp[:12])
    return decision


def _span_mean(name):
    """Mean of a ``span/<name>`` monitor histogram, or None."""
    from . import monitor

    h = monitor.registry().get("span/" + name)
    if h is None or not getattr(h, "count", 0):
        return None
    return h.sum / h.count


def tune_checkpoint_interval(step_s=None, snapshot_s=None, save_s=None,
                             budget=None, async_save=True,
                             replay_step_s=None, manager=None,
                             config=None, guardian=None):
    """The checkpoint cadence from measured costs: explicit arguments,
    else the manager's (``measured_costs``), else the monitor's
    ``span/checkpoint/{snapshot,save}``; ``step_s`` from the StepStats
    mean when not given.  Raises without a measured cost or step time.
    A ``guardian`` that rolled back adds its measured replay
    (``last_replay_steps``) to the evidence."""
    costs = manager.measured_costs() if manager is not None else {}
    if snapshot_s is None:
        snapshot_s = costs.get("snapshot_s")
    if snapshot_s is None:
        snapshot_s = _span_mean("checkpoint/snapshot")
    if save_s is None:
        save_s = costs.get("save_s")
    if save_s is None:
        save_s = _span_mean("checkpoint/save")
    if snapshot_s is None and save_s is None:
        raise ValueError(
            "tune_checkpoint_interval: no measured checkpoint cost "
            "(pass snapshot_s/save_s, or complete at least one save "
            "through the manager / a monitored run first)")
    if step_s is None:
        from . import monitor

        summ = monitor.step_stats().summary() or {}
        step_s = summ.get("mean_step_seconds")
    if not step_s:
        raise ValueError(
            "tune_checkpoint_interval: no measured step time (pass "
            "step_s, or run some monitored steps first)")
    decision = decide_checkpoint_interval(
        step_s, snapshot_s or 0.0, save_s or 0.0, budget=budget,
        async_save=async_save, replay_step_s=replay_step_s)
    if manager is not None and costs:
        decision["measured_saves"] = costs.get("n", 0)
    replayed = getattr(guardian, "last_replay_steps", None)
    if replayed is not None:
        decision["last_replay_steps"] = int(replayed)
        decision["last_replay_s"] = round(
            replayed * float(replay_step_s or step_s), 6)
    if config is not None:
        config.add(decision)
    else:
        _event({"event": "autotune_decision",
                "knob": "checkpoint_interval",
                "chosen": decision["chosen"]})
    return decision


def tune_pipeline(main_program, startup_program, feed, fetch, mesh,
                  build_strategy=None, schedules=None,
                  microbatch_candidates=None, probe_steps=3,
                  warmup_steps=1, tol=0.03, headroom=0.9, config=None):
    """The pipeline schedule and microbatch count of a program with
    ``pipeline_region`` ops on ``mesh``'s ``pp`` axis, as the JAX
    package's tuner chooses them: every candidate through a
    ``ParallelExecutor`` of its own (a fresh scope from
    ``startup_program``), its warm-up peak (the entry's eager run,
    ``program_profile``, as ``tune_batch_size`` reads it) held to
    ``headroom`` times :func:`hbm_ceiling` before a measured window of
    ``probe_steps`` steps, and the schedule table's bubble accounting as
    evidence and tie-breaker (:func:`decide_pipeline`).  Every candidate
    that cannot run pipelined is recorded with its reason, never
    measured.  The candidates run on the world's device (the card without
    a world).

    Every rank of the world calls it alike, and every rank decides from
    the world's evidence (``distributed.gather_objects``): a candidate's
    peak is the largest any rank saw, its step time the slowest rank's,
    and a candidate that failed on one rank is rejected on all of them.
    So the ranks hold one candidate table and take one decision, and no
    rank runs the probe steps of a candidate its peers skip (under ``pp``
    each rank holds other stages, so their peaks differ).  An error
    raised on one rank inside a candidate's transfers leaves its peers
    waiting on it, as any collective does.

    Pin semantics: an explicit ``build_strategy.pipeline_schedule`` is the
    user's choice, recorded as a pinned decision and never measured."""
    from . import compile_cache
    from . import scope as _scope
    from .executor import CPUPlace, CUDAPlace, Executor
    from .framework import Variable
    from .monitor import program_profile
    from .parallel import distributed
    from .parallel.mesh import AXIS_PP
    from .parallel.parallel_executor import ParallelExecutor
    from .parallel.pipeline import SCHEDULES, region_plan, schedule_stats
    from .parallel.strategy import BuildStrategy

    bs = build_strategy or BuildStrategy()
    fp = compile_cache.program_fingerprint(main_program)
    pp = mesh.axis_size(AXIS_PP)
    regions = [op.attrs for op in main_program.global_block().ops
               if op.type == "pipeline_region"]
    region_stages = [int(r["stages"]) for r in regions]
    if pp <= 1 or not regions:
        raise ValueError(
            "tune_pipeline: program has no pipeline_region ops that "
            "would run pipelined on this mesh (pp=%d, regions=%d)"
            % (pp, len(regions)))

    if bs.pipeline_schedule is not None:
        decision = {"knob": "pipeline",
                    "chosen": {"schedule": bs.pipeline_schedule,
                               "microbatches": bs.pipeline_microbatches},
                    "evidence": "pinned", "candidates": []}
        if config is not None:
            config.add(decision, fingerprint=fp[:12], source="pinned")
        return decision

    batch = max((int(np.shape(v)[0]) for v in feed.values()
                 if np.ndim(v) >= 1), default=0)

    def _plans(sched, m=None):
        # the op's own engagement test: a candidate that would run the
        # sequential path is never measured as if it pipelined
        return [region_plan(r, sched, pp, m) for r in regions]

    def _engages(sched):
        return all(v for v, _ in _plans(sched))

    if schedules is None:
        schedules = [sc for sc in ("gpipe", "1f1b") if _engages(sc)]
        # interleaved by default only where it brings v > 1 chunks a rank
        if all(sc % pp == 0 and sc // pp > 1 for sc in region_stages):
            schedules.append("interleaved")
        elif not schedules and _engages("interleaved"):
            schedules.append("interleaved")
        if not schedules:
            raise ValueError(
                "tune_pipeline: no schedule runs the program's "
                "pipeline regions (stages=%s) pipelined on this mesh "
                "(pp=%d)" % (region_stages, pp))
    for sc in schedules:
        if sc not in SCHEDULES:
            raise ValueError("unknown schedule %r" % sc)
    if microbatch_candidates is None:
        microbatch_candidates = [m for m in (pp, 2 * pp, 4 * pp)
                                 if batch and batch % m == 0]
    if not microbatch_candidates:
        raise ValueError(
            "tune_pipeline: no microbatch candidate divides the batch "
            "(%d) — pass microbatch_candidates" % batch)
    wdev = distributed.device()
    use_cuda = wdev is None or wdev.type == "cuda"
    place = CUDAPlace(distributed.local_rank()) if use_cuda else CPUPlace()
    limit = hbm_ceiling(place.device)
    fetch_name = fetch.name if isinstance(fetch, Variable) else str(fetch)

    def _world_error(err):
        # the first failing rank's error, the same text on every rank
        errs = [(r, e) for r, e in enumerate(distributed.gather_objects(
            err)) if e is not None]
        return None if not errs else "error on rank %d: %s" % errs[0]

    candidates = []
    with program_profile.probe_accounting():
        for sched in schedules:
            for m in microbatch_candidates:
                cand = {"schedule": sched, "microbatches": int(m)}
                try:
                    plans = _plans(sched, m)
                except ValueError as e:
                    candidates.append(dict(cand, rejected=str(e)))
                    continue
                if not all(v for v, _ in plans):
                    candidates.append(dict(
                        cand, rejected="not pipelined on this mesh "
                                       "(stages=%s, pp=%d)"
                                       % (region_stages, pp)))
                    continue
                stats = [schedule_stats(sched, pp, m, v) for v, _ in plans]
                cand.update(
                    bubble_fraction=round(
                        sum(st["idle_units"] for st in stats)
                        / max(1, sum(st["total_units"] for st in stats)),
                        4),
                    in_flight=max(st["in_flight"] for st in stats))
                cbs = BuildStrategy()
                for attr, val in vars(bs).items():
                    setattr(cbs, attr, val)
                cbs.pipeline_schedule = sched
                cbs.pipeline_microbatches = int(m)
                scope = _scope.Scope()
                pe, err, peak = None, None, None
                try:
                    Executor(place).run(startup_program, scope=scope)
                    pe = ParallelExecutor(
                        use_cuda=use_cuda, loss_name=fetch_name, mesh=mesh,
                        build_strategy=cbs, main_program=main_program,
                        scope=scope)
                    for _ in range(max(1, warmup_steps)):
                        pe.run([fetch_name], feed=feed)
                    # the entry's eager warm-up peak (None on the CPU)
                    plan = next(iter(pe._plans.values()))
                    prof = program_profile.get(
                        program_profile.program_fingerprint(plan.program))
                    peak = prof.warmup_peak_bytes if prof is not None \
                        else None
                except Exception as e:  # noqa: BLE001 — a failed
                    # candidate is evidence, not a tuner crash
                    err = str(e)[:160]
                rejected = _world_error(err)
                peaks = [p for p in distributed.gather_objects(peak) if p]
                cand["peak_hbm_bytes"] = max(peaks) if peaks else None
                if rejected is None and limit and peaks \
                        and max(peaks) > headroom * limit:
                    rejected = "peak_hbm %d > %.0f" % (
                        max(peaks), headroom * limit)
                step_s = None
                if rejected is None:
                    try:
                        pe.sync()
                        t0 = time.perf_counter()
                        for _ in range(probe_steps):
                            pe.run([fetch_name], feed=feed,
                                   return_numpy=False)
                        pe.sync()
                        step_s = (time.perf_counter() - t0) / probe_steps
                    except Exception as e:  # noqa: BLE001
                        err = str(e)[:160]
                    rejected = _world_error(err)
                    if rejected is None:
                        # the world steps at its slowest rank's pace
                        step_s = max(distributed.gather_objects(step_s))
                if rejected is not None:
                    cand["rejected"] = rejected
                else:
                    cand["step_s"] = round(step_s, 6)
                del pe, scope
                _release(place)
                _event({"event": "autotune_probe", "knob": "pipeline",
                        "schedule": sched, "microbatches": int(m),
                        "step_s": cand.get("step_s"),
                        "rejected": cand.get("rejected"),
                        "fingerprint": fp[:12]})
                candidates.append(cand)
    decision = decide_pipeline(candidates, tol=tol)
    decision["mesh_pp"] = int(pp)
    if config is not None:
        config.add(decision, fingerprint=fp[:12])
    else:
        _event({"event": "autotune_decision", "knob": "pipeline",
                "chosen": decision["chosen"], "fingerprint": fp[:12]})
    return decision


# dequant-matmul ops in a quant A/B program: one op's replay is shorter
# than the host's launch of it, so a window of one-op replays would time
# the host, not the kernel
QUANT_AB_REPS = 24


def _quant_microbench(m, k, n, dtype, mode, seed=0, reps=QUANT_AB_REPS):
    """A ``dequant_matmul`` program and synthetic int8 weights: (program,
    feed, state values, fetch var).  With ``reps`` > 1 the op runs that
    many times on the same operands and a ``sum`` keeps every output
    live."""
    from .framework import Operator, Program
    from .registry import infer_op

    prog = Program()
    block = prog.global_block()
    x = block.create_var(name="qmb_x", shape=(int(m), int(k)),
                         dtype=dtype, is_data=True)
    qw = block.create_var(name="qmb_w", shape=(int(k), int(n)),
                          dtype="int8", persistable=True)
    sc = block.create_var(name="qmb_s", shape=(int(n),),
                          dtype="float32", persistable=True)
    out = block.create_var(name="qmb_out", dtype=dtype)
    reps = max(1, int(reps))
    outs = [out] if reps == 1 else [
        block.create_var(name="qmb_out_%d" % i, dtype=dtype)
        for i in range(reps)]
    for o in outs:
        op = Operator(block, type="dequant_matmul",
                      inputs={"X": [x.name], "QWeight": [qw.name],
                              "Scale": [sc.name]},
                      outputs={"Out": [o.name]},
                      attrs={"x_num_col_dims": 1, "mode": mode})
        infer_op(op, block)
        block.ops.append(op)
    if reps > 1:
        op = Operator(block, type="sum",
                      inputs={"X": [o.name for o in outs]},
                      outputs={"Out": [out.name]})
        infer_op(op, block)
        block.ops.append(op)
    prog._version += 1
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    s = (np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0).astype(
        np.float32)
    qwv = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    feed = {"qmb_x": rng.randn(m, k).astype(np.float32)}
    return prog, feed, {"qmb_w": qwv, "qmb_s": s}, out


def tune_quant_kernel(m, k, n, dtype="float32", place=None,
                      mode="weight_only", probe_steps=4, warmup_steps=1,
                      min_speedup=1.03, table=None, config=None):
    """Kernel #7 against its library arm (dynamic: ``torch._int_mm``) at
    one GEMM shape, on a ``_quant_microbench`` program;
    ``weight_only`` (or a shape ``_int_mm`` cannot take) has no arm and
    records so.  A warm table answers with no measurement."""
    import torch

    from . import compile_cache
    from .executor import CUDAPlace
    from .ops.cuda import quant_matmul as qm

    place = place if place is not None else CUDAPlace(0)
    key = quant_shape_key(m, k, n, dtype, mode)
    table = table or quant_kernel_table()
    prog, feed, values, fetch = _quant_microbench(m, k, n, dtype, mode)
    fp = compile_cache.program_fingerprint(prog)
    cached = _cached_ruling("quant_kernel", table, fp, key, config)
    if cached is not None:
        return cached
    if not qm.has_library_arm(k, n, mode):
        return _no_arm("quant_kernel", table, fp, key, config)
    measured = {}
    for pallas in (False, True):
        with _forced_arm("quant", key, pallas), \
                _probe_run(place) as (exe, scope):
            for name, v in values.items():
                scope.set_var(name, torch.from_numpy(v).to(place.device))
            measured[pallas] = _ab_window(exe, prog, feed, [fetch],
                                          probe_steps, warmup_steps, scope)
        _release(place)
        _event({"event": "autotune_probe", "knob": "quant_kernel",
                "shape": key, "pallas": pallas,
                "step_s": round(measured[pallas], 6)})
    decision = decide_quant_kernel(measured[False], measured[True],
                                   min_speedup=min_speedup)
    decision["shape"] = key
    table.record(fp, key, decision["pallas"], decision)
    if config is not None:
        config.add(decision, fingerprint=fp[:12])
    return decision


def tune_quantization(main_program, scope, feed, fetch_list, place=None,
                      modes=("weight_only", "dynamic"), budget=None,
                      probe_steps=4, warmup_steps=1, min_speedup=1.0,
                      candidates=None, config=None):
    """Full precision against each quantized program (``quantize_
    inference`` over the same scope, or the given ``(mode, program)``
    candidates): the fastest whose relative-L1 delta stays under
    ``budget`` (``FLAGS_quantize_accuracy_budget``) and that is
    ``min_speedup`` faster, else full precision; rejections are evidence.
    A pinned ``FLAGS_quantize_mode`` is recorded, not measured over."""
    from . import compile_cache
    from .executor import CUDAPlace, Executor
    from .monitor import program_profile

    place = place if place is not None else CUDAPlace(0)
    if budget is None:
        budget = float(_flag("quantize_accuracy_budget", 0.02))
    fp = compile_cache.program_fingerprint(main_program)
    if _flags.pinned("quantize_mode"):
        mode = str(_flags.flag("quantize_mode") or "off")
        decision = {"knob": "quantization",
                    "chosen": None if mode in ("", "off") else mode,
                    "accuracy_budget": float(budget),
                    "evidence": "pinned", "candidates": []}
        if config is not None:
            config.add(decision, fingerprint=fp[:12], source="pinned")
        return decision

    batch = max((int(np.shape(v)[0]) for v in feed.values()
                 if np.ndim(v) >= 1), default=0)
    with program_profile.probe_accounting():
        exe = Executor(place)
        ref = exe.run(main_program, feed=feed, fetch_list=fetch_list,
                      scope=scope)
        fp_step_s = measure_step_window(
            exe, main_program, feed, fetch_list, steps=probe_steps,
            warmup=warmup_steps, scope=scope)
        if candidates is None:
            from .transpiler.quantize_pass import quantize_inference

            candidates = [(mode, quantize_inference(
                main_program, scope=scope, mode=mode)) for mode in modes]
        cands = []
        for mode, qprog in candidates:
            cand = {"mode": mode}
            try:
                outs = exe.run(qprog, feed=feed, fetch_list=fetch_list,
                               scope=scope)
                cand["accuracy_delta"] = round(eval_delta(ref, outs), 6)
                step_s = measure_step_window(
                    exe, qprog, feed, fetch_list, steps=probe_steps,
                    warmup=warmup_steps, scope=scope)
                cand["step_s"] = round(step_s, 6)
                if batch:
                    cand["tok_s"] = round(batch / step_s, 2)
            except Exception as e:  # noqa: BLE001 — a failed candidate
                cand["rejected"] = "error: %s" % str(e)[:160]  # is
                # evidence, not a tuner crash
            _event({"event": "autotune_probe", "knob": "quantization",
                    "mode": mode,
                    "accuracy_delta": cand.get("accuracy_delta"),
                    "step_s": cand.get("step_s"),
                    "rejected": cand.get("rejected"),
                    "fingerprint": fp[:12]})
            cands.append(cand)
    decision = decide_quantization(fp_step_s, cands, budget,
                                   min_speedup=min_speedup, batch=batch)
    if config is not None:
        config.add(decision, fingerprint=fp[:12])
    else:
        _event({"event": "autotune_decision", "knob": "quantization",
                "chosen": decision["chosen"], "fingerprint": fp[:12]})
    return decision


def tune_kv_quantization(build_spec, prompts, place=None,
                         max_new_tokens=8, budget=None, min_speedup=0.0,
                         config=None):
    """int8 KV pages through the accuracy gate: ``build_spec(kv_dtype)``
    (None, then "int8") served by a paged engine each, the greedy
    logits compared with :func:`eval_delta` under ``budget``; int8 KV is
    a capacity knob, so it need not win time (``min_speedup`` 0)."""
    from .executor import CUDAPlace
    from .serving.engine import GenerationEngine

    if budget is None:
        budget = float(_flag("quantize_accuracy_budget", 0.02))
    place = place if place is not None else CUDAPlace(0)

    def _drive(kv_dtype):
        spec = build_spec(kv_dtype)
        eng = GenerationEngine(spec, place=place,
                               max_new_tokens=max_new_tokens,
                               timeout_s=600.0, record_logits=True)
        try:
            t0 = time.monotonic()
            outs = [eng.submit(p).result(1200) for p in prompts]
            wall = time.monotonic() - t0
        finally:
            eng.close()
        toks = sum(len(o["tokens"]) for o in outs)
        logits = [row for o in outs for row in o["logits"]]
        tokens = [tuple(o["tokens"]) for o in outs]
        return logits, tokens, wall / max(toks, 1)

    ref_logits, ref_tokens, fp_step_s = _drive(None)
    cand = {"mode": "kv_int8"}
    try:
        q_logits, q_tokens, q_step_s = _drive("int8")
        cand["accuracy_delta"] = round(eval_delta(ref_logits, q_logits),
                                       6)
        cand["step_s"] = round(q_step_s, 6)
        cand["greedy_tokens_match"] = q_tokens == ref_tokens
    except Exception as e:  # noqa: BLE001 — evidence, not a crash
        cand["rejected"] = "error: %s" % str(e)[:160]
    _event({"event": "autotune_probe", "knob": "kv_quantization",
            "mode": "kv_int8",
            "accuracy_delta": cand.get("accuracy_delta"),
            "step_s": cand.get("step_s"),
            "rejected": cand.get("rejected")})
    decision = decide_quantization(fp_step_s, [cand], budget,
                                   min_speedup=min_speedup)
    decision["knob"] = "kv_quantization"
    decision["evidence"] = "paged_generation_ab+eval_delta"
    if config is not None:
        config.add(decision)
    else:
        _event({"event": "autotune_decision", "knob": "kv_quantization",
                "chosen": decision["chosen"]})
    return decision


def tune_speculation_k(make_engine, prompts, candidates=(None, 2, 4),
                       config=None):
    """The speculative ``k`` of a workload: each candidate's engine
    (``make_engine(k)``; None: no speculation) serves the prompts, the
    fastest in tokens/s wins, and a candidate whose tokens differ from
    the baseline's is rejected."""
    baseline_tokens = None
    cands = []
    for k in candidates:
        cand = {"k": k}
        try:
            eng = make_engine(k)
            try:
                t0 = time.monotonic()
                outs = [eng.submit(p).result(1200) for p in prompts]
                wall = time.monotonic() - t0
                toks = sum(len(o["tokens"]) for o in outs)
                tokens = [tuple(o["tokens"]) for o in outs]
                snap = eng.metrics.paged_snapshot()
            finally:
                eng.close()
            cand["tok_s"] = round(toks / max(wall, 1e-9), 2)
            cand["acceptance_rate"] = snap.get("spec_acceptance_rate")
            if k is None:
                baseline_tokens = tokens
            elif baseline_tokens is not None \
                    and tokens != baseline_tokens:
                cand["rejected"] = "greedy_outputs_diverged"
        except Exception as e:  # noqa: BLE001
            cand["rejected"] = "error: %s" % str(e)[:160]
        _event({"event": "autotune_probe", "knob": "speculation_k",
                "k": k, "tok_s": cand.get("tok_s"),
                "acceptance_rate": cand.get("acceptance_rate"),
                "rejected": cand.get("rejected")})
        cands.append(cand)
    ok = [c for c in cands if not c.get("rejected")
          and c.get("tok_s")]
    best = max(ok, key=lambda c: c["tok_s"]) if ok else None
    decision = {"knob": "speculation_k",
                "chosen": best["k"] if best else None,
                "candidates": cands,
                "evidence": "measured_generation_window"}
    if best:
        decision["chosen_tok_s"] = best["tok_s"]
    if config is not None:
        config.add(decision)
    else:
        _event({"event": "autotune_decision", "knob": "speculation_k",
                "chosen": decision["chosen"]})
    return decision
