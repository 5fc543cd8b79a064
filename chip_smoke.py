#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, one line each:

1. ``device``  — the card's name and power limit (``nvidia-smi``), and the
   TF32 switches, which this script turns off so that float32 products
   stay float32;
2. ``build``   — compiles every kernel under ``paddle_tpu_torch/csrc``
   with ``nvcc`` (in parallel) and reports the seconds taken;
3. ``kernels`` — each hand-written kernel against its plain PyTorch
   version at the serving slice's shapes: max abs error and tolerance,
   the kernel's, the plain version's and one PyTorch library call's
   median time (CUDA events, L2 flushed before every launch), and the
   least time the card could take (device-memory bytes at 3.35 TB/s or
   operations at the data-sheet peak of the input type);
4. ``serve``   — a decoder LM at Transformer-base width (6 layers,
   d_model 512, 8 heads, d_inner 2048, vocab 32000, 1024-token cache,
   8 slots, float32, random weights from build_decoder_lm's seed) served by
   ``GenerationEngine`` on ``CUDAPlace(0)``: 16 requests with prompts of
   64..700 tokens, 32 new tokens each.  The launch counters are zeroed
   just before and read just after; every prefill and decode dispatch
   must have launched the attention kernel 6 times and the layer-norm
   kernel 12 times, and one request's recorded logits must match a full
   forward recompute of the score program (rtol/atol 2e-4).

Then the kernel table as one JSON line, the ``nvidia-smi`` line, and, as
the last line, ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero; without a CUDA device the script exits 2 and prints no
result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
REPO = os.path.dirname(os.path.abspath(__file__))

# the serving slice: Transformer-base widths, float32
MODEL = dict(vocab_size=32000, max_len=1024, slots=8, n_layer=6, n_head=8,
             d_model=512, d_inner=2048, dtype="float32")
N_REQUESTS, MAX_NEW = 16, 32

# tolerances (allclose: |kernel - plain| <= atol + rtol * |plain|).
# float32: both sum ~1e3 terms in float32 in different orders.  bfloat16:
# the kernel rounds the probabilities to bf16 before normalizing, the
# plain version after (as the JAX kernel and reference do), and each
# output is then rounded to bf16: a few bf16 ulps (2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def log(phase, payload):
    print("%s: %s" % (phase, json.dumps(payload)), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Timer:
    """Median device time of one call, from CUDA events around each
    launch, with the 50 MB L2 evicted before every launch (the serving
    loop touches every layer's weights and cache between two calls of one
    kernel on the same data)."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=15, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got, want, dtype):
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) \
        and bool(torch.isfinite(got).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(fa, timer, name, tq, tk, causal, klen, dtype,
                   rate=0.0, seed=None):
    from torch.nn.functional import scaled_dot_product_attention

    b, h, d = 8, 8, 64
    g = torch.Generator(device="cuda").manual_seed(len(name))
    q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda")
               .to(dtype) for t in (tq, tk, tk))
    kl = torch.tensor(klen, dtype=torch.int32, device="cuda")
    args = (q, k, v, kl, seed, causal, rate)
    out, lse = fa.flash_attention_fwd(*args)
    want = fa.reference_attention(*args)
    torch.cuda.synchronize()
    err, ok = max_err(out, want, dtype)
    # fully masked rows: zeros and the +1e30 LSE sentinel
    empty = (kl == 0).nonzero().flatten().tolist()
    for i in empty:
        ok = ok and bool((out[i] == 0).all()) and bool((lse[i] == 1e30).all())
    ok = ok and bool(torch.isfinite(lse[kl > 0]).all())

    # what this run's data needs: the (query, key) pairs the masks keep,
    # and the keys any query of a row reads
    gq = torch.arange(tq, device="cuda")[:, None]
    gk = torch.arange(tk, device="cuda")[None, :]
    klc = kl.long().clamp(max=tk).reshape(b, 1, 1, 1)
    valid = gk < klc
    if causal:
        valid = valid & ((gq >= gk) if tq == tk else (gq + klc - tq >= gk))
    pairs = int(valid.sum()) * h
    keys = int(valid.any(dim=2).sum()) * h
    item = q.element_size()
    nbytes = (q.numel() * item + 2 * keys * d * item + out.numel() * item
              + lse.numel() * 4 + kl.numel() * 4)
    bound_ms, bound_by = bound(nbytes, 4 * d * pairs, dtype)

    library_ms = None
    if not rate:
        scale = 1.0 / d ** 0.5
        library_ms = timer(lambda: scaled_dot_product_attention(
            q, k, v, attn_mask=valid, scale=scale))
    res = {"check": name, "q": list(q.shape), "k": list(k.shape),
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "dropout": rate, "max_abs_err": err, "tol": TOL[dtype],
           "kernel_ms": timer(lambda: fa.flash_attention_fwd(*args)),
           "plain_ms": timer(lambda: fa.reference_attention(*args), iters=5),
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "ok": ok}
    return res


def layer_norm_case(ln, timer, n, d, dtype):
    from torch.nn.functional import layer_norm

    g = torch.Generator(device="cuda").manual_seed(n)
    x = (torch.randn((n, d), generator=g, device="cuda") * 3 + 1).to(dtype)
    gamma = torch.randn((d,), generator=g, device="cuda").to(dtype)
    beta = torch.randn((d,), generator=g, device="cuda").to(dtype)
    got = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    want = ln.layer_norm_reference(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    errs = [max_err(a, b, dtype) for a, b in zip(got, want)]
    item = x.element_size()
    nbytes = 2 * x.numel() * item + 2 * d * item + 2 * n * 4
    bound_ms, bound_by = bound(nbytes, 8 * n * d, dtype)
    return {"check": "layer_norm_%dx%d" % (n, d), "x": [n, d],
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(e for e, _ in errs), "tol": TOL[dtype],
            "kernel_ms": timer(lambda: ln.layer_norm_fwd(x, gamma, beta,
                                                         1e-5)),
            "plain_ms": timer(lambda: ln.layer_norm_reference(
                x, gamma, beta, 1e-5)),
            "library_ms": timer(lambda: layer_norm(x, (d,), gamma, beta,
                                                   1e-5)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ok": all(ok for _, ok in errs)}


def kernels_phase():
    from paddle_tpu_torch.ops import cuda
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import layer_norm as ln

    timer = Timer()
    prefill_klen = [1024, 700, 513, 64, 1, 0, 300, 999]
    decode_klen = [1024, 65, 700, 1, 333, 512, 1000, 2]
    attn = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        attn.append(attention_case(fa, timer, "prefill_" + tag, 1024, 1024,
                                   True, prefill_klen, dtype))
        attn.append(attention_case(fa, timer, "decode_" + tag, 1, 1024,
                                   True, decode_klen, dtype))
    attn.append(attention_case(fa, timer, "prefill_float32_dropout", 1024,
                               1024, True, prefill_klen, torch.float32,
                               rate=0.1, seed=1234))
    norm = [layer_norm_case(ln, timer, n, 512, torch.float32)
            for n in (8 * 1024, 8)]
    norm.append(layer_norm_case(ln, timer, 8 * 1024, 512, torch.bfloat16))
    # launches made by these checks and their timing loops (the main
    # path's count is taken separately, in the serve phase)
    log("kernels", {"flash_attention_fwd": attn, "layer_norm_fwd": norm,
                    "check_launches": cuda.launch_counts()})
    bad = [c["check"] for c in attn + norm if not c["ok"]]
    if bad:
        raise SystemExit("kernel disagrees with its plain version: %s"
                         % bad)
    return attn, norm


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------

def serve_phase(place, model=MODEL, n_requests=N_REQUESTS, max_new=MAX_NEW,
                prompt_range=(64, 700)):
    """Serve ``n_requests`` prompts through ``GenerationEngine`` on
    ``place``; returns (the summary dict, the kernels' launch counts)."""
    from paddle_tpu_torch.ops import cuda
    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_lm
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    spec = build_decoder_lm(**model)
    eng = GenerationEngine(spec, place=place, max_new_tokens=max_new,
                           record_logits=True, timeout_s=900.0, start=False)
    rng = np.random.RandomState(0)
    # arrival order shuffled, so admissions mix buckets as traffic would
    lens = rng.permutation(np.linspace(prompt_range[0], prompt_range[1],
                                       n_requests).astype(int))
    prompts = [list(rng.randint(0, model["vocab_size"], n)) for n in lens]
    try:
        eng.start()
        eng.submit(prompts[0][:8], max_new_tokens=2).result(900)  # warm-up
        eng.metrics = ServingMetrics()
        # the main path, in one piece: counters zeroed just before, read
        # just after
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [eng.submit(p) for p in prompts]
        results = [r.result(900) for r in reqs]
        if place.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda.launch_counts()
    finally:
        eng.close()

    counts = eng.metrics.summary()["counts"]
    dispatches = counts["batches"] + counts["decode_steps"]
    tokens = sum(len(r["tokens"]) for r in results)
    assert counts["completed"] == n_requests, counts
    assert all(len(r["tokens"]) == max_new for r in results), \
        [len(r["tokens"]) for r in results]

    # decode-vs-recompute: the longest request's recorded logits against
    # a full causal forward of the score program over prompt + output
    i = int(np.argmax(lens))
    seq = prompts[i] + results[i]["tokens"]
    t = len(seq)
    with torch.inference_mode():
        (full,) = eng._exe.run(
            spec.score_program,
            feed={"tok": np.asarray(seq, "int64").reshape(1, t, 1),
                  "tok@LEN": np.asarray([t], "int32"),
                  "pos": np.arange(t, dtype="int64").reshape(1, t, 1)},
            fetch_list=[spec.score_logits], scope=eng._scope)
    assert full.shape == (1, t, model["vocab_size"]), full.shape
    assert np.isfinite(full).all()
    want = full[0, len(prompts[i]) - 1:t - 1]
    got = np.stack(results[i]["logits"])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    pre = eng.metrics.percentiles("prefill")
    dec = eng.metrics.percentiles("decode")
    summary = {
        "requests": n_requests, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "prefills": counts["batches"],
        "decode_steps": counts["decode_steps"],
        "p50_prefill_ms": pre["p50_s"] * 1e3,
        "p50_decode_step_ms": dec["p50_s"] * 1e3,
        "p50_request_ms": eng.metrics.percentiles()["p50_s"] * 1e3,
        "recompute_max_abs_err": float(np.abs(got - want).max()),
        "launches": launches, "dispatches": dispatches,
        "cache_mb": spec.cache.bytes() / 1e6,
        "params_mb": sum(
            eng._scope.var(n).numel() * eng._scope.var(n).element_size()
            for n in eng._scope.local_var_names()
            if n not in spec.cache.names()) / 1e6}
    per = {"flash_attention_fwd": model["n_layer"],
           "layer_norm_fwd": 2 * model["n_layer"]}
    return summary, launches, {k: n * dispatches for k, n in per.items()}


# ---------------------------------------------------------------------------
# --profile: where a dispatch's time goes
# ---------------------------------------------------------------------------

def _union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_phase(place, model=MODEL, steps=20, prompt=400, bucket=512):
    """torch.profiler over one prefill (every slot, ``prompt`` tokens in
    the ``bucket`` bucket) and ``steps`` decode steps of the serving
    slice, each driven through ``Executor.run`` and fetched as the engine
    fetches it.  Reports per dispatch kind the host wall time, the device
    busy time (union of kernel intervals inside the dispatch) and the
    device's idle share, and the kernels and host ops that take the most
    time."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import build_decoder_lm
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    spec = build_decoder_lm(**model)
    exe, scope = pt.Executor(place), pt.Scope()
    spec.init_scope(exe, scope)
    s, v = spec.slots, model["vocab_size"]
    rng = np.random.RandomState(1)
    prefill = {"tok": rng.randint(0, v, (s, bucket, 1)).astype("int64"),
               "tok@LEN": np.full((s,), prompt, "int32"),
               "pos": np.broadcast_to(
                   np.arange(bucket, dtype="int64")[None, :, None],
                   (s, bucket, 1)).copy(),
               "slot": np.arange(s, dtype="int32"),
               "wpos": np.zeros((s,), "int32")}
    last = (torch.arange(s), torch.full((s,), prompt - 1))

    def decode(i):
        p = prompt + i
        return {"tok": rng.randint(0, v, (s, 1, 1)).astype("int64"),
                "pos": np.full((s, 1, 1), p, "int64"),
                "wpos": np.full((s,), p, "int32"),
                "cache_len": np.full((s,), p + 1, "int32")}

    def dispatch(kind, feed):
        prog, var, rows = ((spec.prefill_program, spec.prefill_logits, last)
                           if kind == "prefill" else
                           (spec.decode_program, spec.decode_logits,
                            (slice(None), 0)))
        with record_function("dispatch/" + kind):
            (out,) = exe.run(prog, feed=feed, fetch_list=[var], scope=scope,
                             return_numpy=False)
            out[rows].float().cpu()

    with torch.inference_mode():
        dispatch("prefill", prefill)
        for i in range(2):
            dispatch("decode", decode(i))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dispatch("prefill", prefill)
            for i in range(steps):
                dispatch("decode", decode(i))
            torch.cuda.synchronize()

    events = prof.events()
    # device activity: kernels and copies; the dispatch/* ranges are also
    # mirrored onto the device timeline as annotations, which are not work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("dispatch/")]
    kernels = [(e.time_range.start, e.time_range.end) for e in device]
    by_name = {}
    for e in device:
        d = by_name.setdefault(e.name[:70], [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    per_kind = {}
    for e in events:
        if e.device_type != DeviceType.CPU \
                or not e.name.startswith("dispatch/"):
            continue
        a, b = e.time_range.start, e.time_range.end
        busy = _union_us([(max(x, a), min(y, b)) for x, y in kernels
                          if y > a and x < b])
        d = per_kind.setdefault(e.name[len("dispatch/"):],
                                {"n": 0, "wall_us": 0.0, "busy_us": 0.0})
        d["n"] += 1
        d["wall_us"] += b - a
        d["busy_us"] += busy
    for d in per_kind.values():
        d["idle_share"] = 1.0 - d["busy_us"] / d["wall_us"]
        d["wall_ms_each"] = d["wall_us"] / d["n"] / 1e3
        d["busy_ms_each"] = d["busy_us"] / d["n"] / 1e3

    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    top_host = sorted(prof.key_averages(),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    log("profile", {
        "window": "1 prefill (%d x %d, bucket %d) + %d decode steps"
                  % (s, prompt, bucket, steps),
        "kernel_events": len(kernels), "dispatch": per_kind,
        "top_device_us": [(k, us, n) for k, (us, n) in top_dev],
        "top_host_self_us": [(e.key[:70], e.self_cpu_time_total, e.count)
                             for e in top_host]})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import build

    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", {"nvidia_smi": smi,
                   "name": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count(),
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   "matmul.allow_tf32":
                       torch.backends.cuda.matmul.allow_tf32,
                   "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    built = build.build()
    ptxas = {n: [ln.split("info    : ")[-1] for ln in
                 build.build_log.get(n, "").splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in built}
    log("build", {"seconds": time.perf_counter() - t0,
                  "kernels": sorted(built), "ptxas": ptxas})
    if "--profile" in sys.argv[1:]:
        profile_phase(pt.CUDAPlace(0))
        return 0

    attn, norm = kernels_phase()
    serve, launches, need = serve_phase(pt.CUDAPlace(0))
    log("serve", serve)
    short = {k: (launches[k], n) for k, n in need.items()
             if launches[k] < n or n == 0}
    if short:
        raise SystemExit("the main path skipped a kernel (launches, "
                         "needed): %s" % short)

    rows = []
    for name, checks, src, tpu in (
            ("flash_attention_fwd", attn, "csrc/flash_attention_fwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:328"),
            ("layer_norm_fwd", norm, "csrc/layer_norm_fwd.cu",
             "paddle_tpu/ops/pallas/layer_norm.py:59")):
        head = checks[0]      # the float32 prefill shape of the main path
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/" + src, "replaces": tpu,
                     "launches": launches[name],
                     "max_abs_err": head["max_abs_err"],
                     "ms": head["kernel_ms"],
                     "plain_ms": head["plain_ms"],
                     "bound_ms": head["bound_ms"],
                     "bound_by": head["bound_by"],
                     "library_ms": head["library_ms"],
                     "at": head["check"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
