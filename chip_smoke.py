#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --profile   # device, build, then the profiles
    python3 chip_smoke.py --serve-ab  # device, build, fp and int8 serving
                                      # in turns (fp, wo, dyn, dyn, wo, fp)
    python3 chip_smoke.py --conv-bn   # device, build, kernels #8-#11 only
    python3 chip_smoke.py --train-kernels  # device, build, kernels #1-#6
    python3 chip_smoke.py --serve-kernels  # device, build, kernels #1, #3,
                                           # #7
    python3 chip_smoke.py --resnet-default # device, build, ResNet-50 steps
                                           # with cuDNN's default algorithms

Run from the root of a checkout.  Phases, one line each:

1. ``device``  — the card's name and power limit (``nvidia-smi``), and the
   TF32 switches, which this script turns off so that float32 products
   stay float32, and cuBLAS's reduced-precision bf16 reduction, which the
   port turns off so that bf16 products sum in float32;
2. ``build``   — compiles every kernel under ``paddle_tpu_torch/csrc``
   with ``nvcc`` (in parallel) and reports the seconds taken, each
   kernel's registers and spills, the ``HGMMA`` (wgmma) instructions in
   the ``conv_bn`` and ``conv_bn_nhwc`` libraries, the ``HMMA`` (mma.sync
   TF32 / bf16 / f16) ones in ``flash_attention_fwd``,
   ``flash_attention_bwd`` and ``quant_matmul`` and the ``IMMA`` (int8
   mma.sync) ones in ``quant_matmul`` (``cuobjdump --dump-sass``); it
   fails if any of them is 0;
3. ``kernels`` — each hand-written kernel against its plain PyTorch
   version at the shapes its paths give it (the serving slice's and the
   training slice's): max abs error and tolerance, the kernel's, the plain
   version's and one PyTorch library call's median time (CUDA events, L2
   flushed before every launch), the device time of one kernel call and of
   one library call (``device_ms``: the sum of the device kernels it ran,
   ``torch.profiler``; a library backward is several launches, whose event
   time also counts the host's gaps), and the least time the card could take
   (device-memory bytes at 3.35 TB/s or operations at the data-sheet peak
   of the input type; #1 float32 at three TF32 passes, #7's
   weight_only float32 at two, with the float32 units' bound beside);
   #1 and #7 also give the same bits twice, run one device kernel a call
   (the dynamic prefill two) and launch with the key / K split their
   wrappers plan; the fused conv+BN kernels #8-#11 at ResNet-50's
   stage 1, 3 and 4 shapes in both layouts (tensor cores, float32 as
   three TF32 passes, bound at 3 x operations / 495 TFLOP/s beside the
   float32-unit bound), and at a ragged shape in each (NHWC M 1000, NCHW 3
   images of 7x7; C 72, O 200); #2, #4 and their library calls also name
   the device kernels they ran (SDPA's backend); the AMP paths' shapes
   and types too: #1/#2 in bfloat16 at the training shape with dropout
   0.1, #8-#11 in bfloat16 at stages 1, 3 and 4;
Every path below runs twice, in turns: captured (the default
``Executor``: each dispatch signature's first run eager, its second
captured as a CUDA graph and replayed, later ones replayed; the main path,
whose launch counts the kernel table reports) and eager
(``capture=False``, the path ``<name>:eager``).  The two must give the
same bits.  Each reports wall, device busy time and idle share, tokens/s
or images/s and peak memory; its timed runs are taken with the launch
counters zeroed just before and read just after, then it runs once more
under ``torch.profiler`` (a pass or a step: busy time, idle share, and
each kernel's launches counted in the device trace).  Launches must be
exactly what the programs imply (``launch_faults``): an eager path's
wrappers count them in the timed runs and in the profiled window, whose
trace shows the same; a captured path's wrappers count none (every timed
and profiled run replays a graph), and its window's trace shows each
kernel as often as the eager one.  The kernel table reports the traced
counts of each path's profiled window.

4. ``serve``   — a decoder LM at Transformer-base width (6 layers,
   d_model 512, 8 heads, d_inner 2048, vocab 32000, 1024-token cache,
   8 slots, float32, random weights from build_decoder_lm's seed) served by
   ``GenerationEngine`` on ``CUDAPlace(0)``: after two dispatches of every
   prefill bucket, 16 requests with prompts of 64..700 tokens, 32 new
   tokens each.  Every prefill and decode dispatch must launch the
   attention kernel 6 times and the layer-norm kernel 12 times (the
   dequant-matmul kernel never), and one request's recorded logits must
   match a full forward recompute of the score program (rtol/atol 2e-4);
   the generated tokens and recorded logits of the captured and the eager
   engine are the same bits (``capture_check``);
5. ``serve_int8`` — the same model and requests with
   ``GenerationEngine(..., quantize=mode)`` for ``weight_only`` and
   ``dynamic``: every dispatch launches the dequant-matmul kernel once per
   ``dequant_matmul`` op (37); weight_only decode logits match the
   quantized score program's recompute within 2e-4 (dynamic within
   relative L1 0.02), and the quantized score logits the fp ones within
   relative L1 0.02 (the int8 accuracy budget); the int8 weights are a
   quarter of the float32 bytes;
6. ``infer``   — the score program saved with ``io.save_inference_model``
   and served cold by ``InferenceEngine(model_dir=..., quantize=
   "weight_only")``: 16 requests of 32..256 tokens, each [T, 32000] output
   against a direct ``Executor.run`` of the quantized program (2e-4) and of
   the fp program (relative L1 0.02); the quantized program saved again
   and served cold with no pass, to the same outputs;
6b. ``infer_bf16`` — the score program saved in float32, rewritten by
   ``contrib.Bfloat16Transpiler`` (bf16 parameters, #1 and #3 in bf16,
   the logits cast back to float32), saved, and served cold by
   ``InferenceEngine`` (captured): every output float32 and within
   relative L1 0.02 of a direct run of the float32 program, the engine's
   parameters bf16 on the card, #1 6 and #3 12 launches a batch;
7. ``train_check`` — the Transformer-base train program at dropout 0,
   one batch of 4 rows at full width, one step on ``CUDAPlace(0)`` (the
   kernels) and one on ``CPUPlace()`` (the plain versions) from one
   startup state: the losses agree within rtol 1e-4, the parameters'
   gradients within relative L2 1e-4 at the median and 1e-2 for each,
   the CPU taking the card's ReLU decisions (see ``train_check_phase``),
   and the step moved the parameters;
8. ``train``   — Transformer-base training as bench.py configures it
   (6+6 layers, d_model 512, 8 heads, d_inner 2048, vocab 32000, batch
   256 x 64 tokens, source and target lengths drawn per row in [16, 64],
   dropout 0.1, label smoothing 0.1, noam(512, 4000), Adam(0.9, 0.997,
   1e-9)) on ``CUDAPlace(0)``, captured and eager from one startup
   state: two untimed steps each (the captured second is the capture),
   then timed steps in turns; each kernel must launch exactly as often
   as the program's ops imply; the losses at every step and every scope
   tensor after them are the same bits, and after a parameter is swapped
   in both scopes (``scope.set_var``; numpy in the captured one) the next
   step is too, the captured scope pointing back at its captured tensor;
7b/8b. ``train_amp_check`` and ``train_amp`` — the same two phases with
   the optimizer wrapped in ``contrib.mixed_precision.decorate``
   (bench.py's default rungs): #1/#2 in bfloat16, #3-#6 in float32; the
   check holds the loss within rtol 1e-2 and the gradients within 3x a
   floor measured in the same call by ``resnet_check``'s 1e-7 nudge (no
   fixed band holds under AMP at batch 4: ``AMP_NUDGE``), and every
   float32 persistable (parameters, moments, counters) stays float32;
9. ``resnet_check`` — bench.py's ResNet-50 (depth 50, 3x224x224, class_dim
   1000, Momentum(1e-3, 0.9)) after ``fuse_conv_bn`` and after
   ``convert_to_nhwc`` + ``fuse_conv_bn``, batch 4 at full width: one step
   on the card (kernels #8-#11) against one on the CPU from one startup
   state, and against the plain program on the card: loss rtol 1e-4, and
   gradients within 3x the relative-L2 floor that a 1e-7 nudge of the
   weights gives the plain program in the same call (median and maximum;
   see ``resnet_check_phase``);
10. ``resnet_train`` — the same model at batch 128 (cut from bench.py's
   512) in three programs, plain, fused and NHWC + fused, on the same
   batches, each eager and captured: two untimed steps each, then 5
   timed steps taken in turns (exactly 30 launches of #8 and #9 a step on
   the fused program, of #10 and #11 on the NHWC one, none on the plain
   one), then one profiled step each.  The phase runs with cuDNN's
   deterministic algorithms and ``torch.use_deterministic_algorithms``
   (cuDNN's default backward sums with atomics in no fixed order), and
   the captured arm's losses and every scope tensor (parameters, running
   statistics, velocities) are the eager arm's bits;
9b/10b. ``resnet_amp_check`` and ``resnet_amp`` — the same two phases
   under ``decorate``: the trunk runs in bfloat16 after the first
   convolution, #8-#11 in bfloat16; the check's loss band is rtol 1e-2
   and its gradient floor is of the order of the gradients under AMP
   (``resnet_check_phase``); every float32 persistable stays float32.

3b. ``train_amp_small_check`` and ``resnet_amp_small_check`` (after
   ``kernels``) — the AMP step, card against CPU, at
   ``tests/test_torch_amp.py``'s small configurations (the 2+2-layer
   Transformer with one 64-wide head; the bf16-stem net plain, fused and
   NHWC + fused): the fixed band (loss rtol 1e-2, gradients relative L2
   2e-2 at the median) and the same-call floor of a 1e-7 weight nudge,
   each reported; the stem net is held to the band, the Transformer to
   3x its floor (``amp_small_checks``);
11. ``mlp_trainer`` — the MNIST MLP (784-256-256-10, Adam 1e-3, batch
   256, ``tests/test_mnist_mlp.py``'s synthetic rule): captured = eager
   bit for bit over 20 steps, bench.py's compute rung (a staged batch,
   replays, one graph) and ``Trainer.train`` over a ``reader.batch``
   reader with the ``DataFeeder`` converting every step, images/s each;
   the loss falls;
12. ``realdist`` — bench.py's ``transformer_realdist`` under AMP:
   Transformer-base fed pad-to-max (128 x 64) and bucketed
   (``bucket_by_length``, bounds 16 / 32 / 48 / 64, 512 / 256 / 170 /
   128 rows, ``DataFeeder.feed(pad_to=bound)``): real tokens/s of each
   and their ratio; 5 graphs; captured = eager over the four buckets;
   exact launches of #1-#6 in each bucket's replayed step (paths
   ``realdist:b16`` .. ``realdist:b64``); and ``realdist_check_b16`` /
   ``realdist_check_b64``, a float32 step of a whole bucket batch, card
   against CPU, at ``train_check``'s bands, and ``realdist_fault_tf32_b64``
   / ``realdist_fault_klen_b16``, the same check on a planted fault (TF32
   products, key lengths one short), which it must fail;
13. ``resnet_feed`` — ResNet-50 plain under AMP at batch 128 fed staged
   on the card, synchronously from the host, and through ``PyReader``
   (``DevicePrefetcher``), with float32 and with uint8 images: wall,
   device busy, wall minus busy and images/s of each; the prefetched
   losses are the synchronous arm's bits.

Then the script's total seconds (``total``), the kernel table as one JSON
line, the ``nvidia-smi`` line, and, as the last line, ``{"ok": true,
"device": {...}}``.  Any failure raises and
exits nonzero; without a CUDA device the script exits 2 and prints no
result.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
                  torch.int8: 1979e12}
# the tensor cores' TF32 rate: #1, #2 and #8-#11 take a float32 product as
# three TF32 passes, #7 (weight_only, whose int8 weight has no lo part) as
# two, so their float32 bound counts 3 x or 2 x the operations at it
TF32_OPS_PER_S = 495e12
REPO = os.path.dirname(os.path.abspath(__file__))

# the serving slice: Transformer-base widths, float32
MODEL = dict(vocab_size=32000, max_len=1024, slots=8, n_layer=6, n_head=8,
             d_model=512, d_inner=2048, dtype="float32")
N_REQUESTS, MAX_NEW = 16, 32
SERVE_PROMPTS = (64, 700)   # the served prompts' shortest and longest

# tolerances (allclose: |kernel - plain| <= atol + rtol * |plain|).
# float32: both sum ~1e3 terms in float32 in different orders.  bfloat16:
# the kernel rounds the probabilities to bf16 before normalizing, the
# plain version after (as the JAX kernel and reference do), and each
# output is then rounded to bf16: a few bf16 ulps (2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# outputs whose entries are probabilities of a 32000-way softmax (~3e-5
# each) and their gradients: the same relative terms, an absolute term
# below the values themselves
TOL_P = {torch.float32: (1e-7, 1e-4), torch.bfloat16: (1e-5, 2e-2)}

# the training slice: bench.py's Transformer-base configuration
TRAIN = dict(n_layer=6, n_head=8, d_model=512, d_inner=2048)
TRAIN_VOCAB, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 32000, 64, 256, 5


_T0 = time.perf_counter()


def log(phase, payload):
    if isinstance(payload, dict):
        payload = dict(payload, at_s=time.perf_counter() - _T0)
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


def max_err(got, want, dtype, tol=TOL):
    atol, rtol = tol[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) \
        and bool(torch.isfinite(got).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(fa, timer, name, tq, tk, causal, klen, dtype,
                   rate=0.0, seed=None, split=False):
    from torch.nn.functional import scaled_dot_product_attention

    b, h, d = len(klen), 8, 64
    g = torch.Generator(device="cuda").manual_seed(len(name))
    q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda")
               .to(dtype) for t in (tq, tk, tk))
    kl = torch.tensor(klen, dtype=torch.int32, device="cuda")
    # the dropout seed is device data, as the executor hands it over
    seed = None if seed is None else fa.seed_tensor(seed, "cuda")
    args = (q, k, v, kl, seed, causal, rate)
    out, lse = fa.flash_attention_fwd(*args)
    again = fa.flash_attention_fwd(*args)
    want = fa.reference_attention(*args)
    torch.cuda.synchronize()
    err, ok = max_err(out, want, dtype)
    # the decode split combines its ranks in a fixed order: the same bits
    # every launch
    same_bits = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    # the cluster the kernel launched with, against the wrapper's planner
    from paddle_tpu_torch.ops.cuda import build
    cluster = build.library(
        "flash_attention_fwd").ptt_flash_attention_fwd_cluster(b, h, tq, tk)
    planned = fa._split_cluster(b, h, tq, tk)
    calls = kernel_calls(lambda: fa.flash_attention_fwd(*args))
    ok = ok and same_bits and cluster == planned and sum(calls.values()) == 1
    # a case meant for the key split must take it
    ok = ok and (cluster > 1 or not split)
    # fully masked rows: zeros and the +1e30 LSE sentinel
    empty = (kl == 0).nonzero().flatten().tolist()
    for i in empty:
        ok = ok and bool((out[i] == 0).all()) and bool((lse[i] == 1e30).all())
    ok = ok and bool(torch.isfinite(lse[kl > 0]).all())

    valid, pairs, keys = _pairs_and_keys(b, h, tq, tk, causal, kl)
    item = q.element_size()
    nbytes = (q.numel() * item + 2 * keys * d * item + out.numel() * item
              + lse.numel() * 4 + kl.numel() * 4)
    bound_ms, bound_by, bound_simt = tf32_bound(nbytes, 4 * d * pairs, dtype)

    library_ms = library_dev = None
    if not rate:
        scale = 1.0 / d ** 0.5

        def lib():
            scaled_dot_product_attention(q, k, v, attn_mask=valid,
                                         scale=scale)
        library_ms = timer(lib)
        library_dev = device_ms(library_kernels(lib))
    res = {"check": name, "q": list(q.shape), "k": list(k.shape),
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "dropout": rate, "klen": list(klen)[:8], "cluster": cluster,
           "cluster_planned": planned, "repeatable_bits": same_bits,
           "device_kernel_calls": calls,
           "max_abs_err": err, "tol": TOL[dtype],
           "kernel_ms": timer(lambda: fa.flash_attention_fwd(*args)),
           "device_ms": device_ms(library_kernels(
               lambda: fa.flash_attention_fwd(*args))),
           "plain_ms": timer(lambda: fa.reference_attention(*args), iters=5),
           "library_ms": library_ms, "library_device_ms": library_dev,
           "bound_ms": bound_ms,
           "bound_by": bound_by, "ok": ok}
    if bound_simt is not None:
        res.update(bound_rate="3xTF32", bound_simt_ms=bound_simt)
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
            "device_ms": device_ms(library_kernels(
                lambda: ln.layer_norm_fwd(x, gamma, beta, 1e-5))),
            "plain_ms": timer(lambda: ln.layer_norm_reference(
                x, gamma, beta, 1e-5)),
            "library_ms": timer(lambda: layer_norm(x, (d,), gamma, beta,
                                                   1e-5)),
            "library_device_ms": device_ms(library_kernels(
                lambda: layer_norm(x, (d,), gamma, beta, 1e-5))),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ok": all(ok for _, ok in errs)}


def _pairs_and_keys(b, h, tq, tk, causal, kl):
    """The boolean mask [B,1,Tq,Tk] of the (query, key) pairs the klen and
    causal masks keep, their count over all heads, and the count of keys
    any query of a row reads (what this run's data needs)."""
    gq = torch.arange(tq, device="cuda")[:, None]
    gk = torch.arange(tk, device="cuda")[None, :]
    klc = kl.long().clamp(max=tk).reshape(b, 1, 1, 1)
    valid = gk < klc
    if causal:
        valid = valid & ((gq >= gk) if tq == tk else (gq + klc - tq >= gk))
    return valid, int(valid.sum()) * h, int(valid.any(dim=2).sum()) * h


# seconds a profiled window waits after the profiler starts before it
# runs anything: kernels launched at once were now and then missing from
# the trace (a serving window lost most of its first dispatch's), while
# none went missing once the profiler had this long to settle
TRACE_SETTLE_S = 0.05


def _device_kernels(fn, tries=3):
    """The device kernels one call of ``fn`` runs, as ``torch.profiler``'s
    averages (after a warm-up call).  A window that recorded no device
    event at all is a profiler miss (it happens now and then), not a call
    that ran nothing: it is profiled again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S)
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)) > 0]
        if kernels:
            break
    return kernels


def library_kernels(fn):
    """The device kernels one call of ``fn`` runs, {name: device us}: which
    backend a library call took."""
    return {e.key[:100]: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
            for e in _device_kernels(fn)}


def kernel_calls(fn):
    """{device kernel name: launches} of one call of ``fn``: how many
    kernels a wrapper call runs."""
    return {e.key[:100]: e.count for e in _device_kernels(fn)}


def device_ms(kernels):
    """Device time of one call, ms: the sum of the kernels it ran (a
    ``library_kernels`` dict).  The like-for-like reading beside a
    library call's, whose CUDA-event time also counts the host's gaps
    between its launches."""
    return sum(kernels.values()) / 1e3


def attention_bwd_case(fa, timer, name, tq, tk, causal, klen, dtype,
                       rate=0.0, seed=None):
    """Kernel #2 against ``attention_bwd_reference`` on the kernel
    forward's O and LSE, and twice against itself; the library yardstick
    is the backward of ``scaled_dot_product_attention`` under the same
    boolean mask."""
    from torch.nn.functional import scaled_dot_product_attention

    b, h, d = len(klen), 8, 64
    g = torch.Generator(device="cuda").manual_seed(len(name) + 101)
    q, k, v, dout = (torch.randn((b, h, t, d), generator=g, device="cuda")
                     .to(dtype) for t in (tq, tk, tk, tq))
    kl = torch.tensor(klen, dtype=torch.int32, device="cuda")
    seed = None if seed is None else fa.seed_tensor(seed, "cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, kl, seed, causal, rate)
    args = (q, k, v, kl, seed, causal, rate, None, out, lse, dout)
    got = fa.flash_attention_bwd(*args)
    again = fa.flash_attention_bwd(*args)
    want = fa.attention_bwd_reference(*args)
    torch.cuda.synchronize()
    errs = [max_err(a, w, dtype) for a, w in zip(got, want)]
    # no atomics (dQ's key-tile parts are added in a fixed order): the
    # same bits every launch
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = all(o for _, o in errs) and same_bits
    # fully masked rows: zero gradients, never NaN
    for i in (kl == 0).nonzero().flatten().tolist():
        ok = ok and all(bool((t[i] == 0).all()) for t in got)
    valid, pairs, keys = _pairs_and_keys(b, h, tq, tk, causal, kl)
    item = q.element_size()
    nbytes = (3 * q.numel() * item + 2 * keys * d * item + lse.numel() * 4
              + kl.numel() * 4 + q.numel() * item + 2 * k.numel() * item)
    # S and G recomputed once, then dQ, dK and dV: five products a pair
    bound_ms, bound_by = bound(nbytes, 10 * d * pairs, dtype)

    library_ms, library = None, {}
    if not rate and bool((kl > 0).all()):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = scaled_dot_product_attention(*leaves, attn_mask=valid,
                                         scale=1.0 / d ** 0.5)

        def lib():
            torch.autograd.grad(o, leaves, dout, retain_graph=True)
        library_ms = timer(lib)
        lib_kernels = library_kernels(lib)
        library = {"library_kernels": lib_kernels,
                   "library_device_ms": device_ms(lib_kernels),
                   "library_ms_again": timer(lib)}
    # the kernels one wrapper call runs on the device, by name: what of
    # its time is the kernel itself and what the wrapper's own launches
    kernels = library_kernels(lambda: fa.flash_attention_bwd(*args))
    return dict(library, **{"check": name, "q": list(q.shape), "k": list(k.shape),
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "dropout": rate, "klen_zero_rows": int((kl == 0).sum()),
            "repeatable_bits": same_bits,
            "max_abs_err": max(e for e, _ in errs), "tol": TOL[dtype],
            "max_abs_plain": max(float(w.float().abs().max()) for w in want),
            "kernel_ms": timer(lambda: fa.flash_attention_bwd(*args)),
            "device_ms": device_ms(kernels), "device_kernels": kernels,
            "plain_ms": timer(lambda: fa.attention_bwd_reference(*args),
                              iters=5),
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ok": ok})


def layer_norm_bwd_case(ln, timer, n, d, dtype):
    """Kernel #4 against ``layer_norm_bwd_reference``, and twice against
    itself: dgamma/dbeta are reduced without atomics, so the bits repeat.
    The library yardstick is the backward of ``F.layer_norm``."""
    from torch.nn.functional import layer_norm

    g = torch.Generator(device="cuda").manual_seed(n + 1)
    x = (torch.randn((n, d), generator=g, device="cuda") * 3 + 1).to(dtype)
    gamma, beta = (torch.randn((d,), generator=g, device="cuda").to(dtype)
                   for _ in range(2))
    dy = torch.randn((n, d), generator=g, device="cuda").to(dtype)
    _, mean, var = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    rstd = torch.rsqrt(var + 1e-5)
    args = (x, gamma, mean, rstd, dy)
    got = ln.layer_norm_bwd(*args)
    again = ln.layer_norm_bwd(*args)
    want = ln.layer_norm_bwd_reference(*args)
    torch.cuda.synchronize()
    errs = [max_err(a, w, dtype) for a, w in zip(got, want)]
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    item = x.element_size()
    nbytes = 3 * x.numel() * item + 3 * d * item + 2 * n * 4
    bound_ms, bound_by = bound(nbytes, 13 * n * d, dtype)
    leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    y = layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)

    def lib():
        torch.autograd.grad(y, leaves, dy, retain_graph=True)
    kernels = library_kernels(lambda: ln.layer_norm_bwd(*args))
    lib_kernels = library_kernels(lib)
    return {"check": "layer_norm_bwd_%dx%d" % (n, d), "x": [n, d],
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(e for e, _ in errs), "tol": TOL[dtype],
            "repeatable_bits": same_bits,
            "kernel_ms": timer(lambda: ln.layer_norm_bwd(*args)),
            "device_ms": device_ms(kernels), "device_kernels": kernels,
            "plain_ms": timer(lambda: ln.layer_norm_bwd_reference(*args)),
            "library_ms": timer(lib), "library_kernels": lib_kernels,
            "library_device_ms": device_ms(lib_kernels),
            "library_ms_again": timer(lib),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ok": all(o for _, o in errs) and same_bits}


def softmax_xent_cases(sx, timer, n, c, eps, dtype):
    """Kernel #5, and kernel #6 without and with the softmax cotangent,
    against their plain versions.  One label lies past C: it must pick 0
    and read nothing out of bounds.  The library yardstick is
    ``F.cross_entropy(..., label_smoothing=eps, reduction="none")`` (same
    loss formula, no softmax output) and its backward, on in-range
    labels."""
    from torch.nn.functional import cross_entropy

    tag = str(dtype).replace("torch.", "")
    g = torch.Generator(device="cuda").manual_seed(c)
    logits = (torch.randn((n, c), generator=g, device="cuda") * 2).to(dtype)
    label = torch.randint(0, c, (n,), generator=g, device="cuda")
    label_in = label.clone()
    label[n // 2] = c + 3
    loss, sm = sx.softmax_xent_fwd(logits, label, eps)
    want_loss, want_sm = sx.softmax_xent_reference(logits, label, eps)
    torch.cuda.synchronize()
    errs = [max_err(loss, want_loss, dtype), max_err(sm, want_sm, dtype,
                                                     TOL_P)]
    item = logits.element_size()
    nbytes = 2 * logits.numel() * item + n * 8 + n * item
    bound_ms, bound_by = bound(nbytes, 6 * n * c, dtype)
    lib_leaf = logits.detach().clone().requires_grad_()
    lib_loss = cross_entropy(lib_leaf, label_in, label_smoothing=eps,
                             reduction="none")
    fwd = {"check": "softmax_xent_fwd_%dx%d_%s" % (n, c, tag),
           "logits": [n, c], "dtype": tag, "eps": eps,
           "max_abs_err": max(e for e, _ in errs),
           "tol": {"loss": TOL[dtype], "softmax": TOL_P[dtype]},
           "kernel_ms": timer(lambda: sx.softmax_xent_fwd(logits, label,
                                                          eps)),
           "device_ms": device_ms(library_kernels(
               lambda: sx.softmax_xent_fwd(logits, label, eps))),
           "plain_ms": timer(lambda: sx.softmax_xent_reference(
               logits, label, eps), iters=5),
           "library_ms": timer(lambda: cross_entropy(
               logits, label_in, label_smoothing=eps, reduction="none")),
           "library_device_ms": device_ms(library_kernels(
               lambda: cross_entropy(logits, label_in, label_smoothing=eps,
                                     reduction="none"))),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": all(o for _, o in errs)}
    del want_loss, want_sm

    bwd = []
    dloss = torch.randn((n, 1), generator=g, device="cuda").to(dtype)
    for with_dsm in (False, True):
        dsm = (torch.randn((n, c), generator=g, device="cuda").to(dtype)
               if with_dsm else None)
        args = (sm, label, dloss, dsm, eps)
        got = sx.softmax_xent_bwd(*args)
        err, ok = max_err(got, sx.softmax_xent_bwd_reference(*args), dtype,
                          TOL_P)
        del got
        nbytes = ((3 if with_dsm else 2) * sm.numel() * item + n * 8
                  + n * item)
        bound_ms, bound_by = bound(nbytes, (7 if with_dsm else 3) * n * c,
                                   dtype)
        library_ms = library_dev = None
        if not with_dsm:
            def lib():
                torch.autograd.grad(lib_loss, [lib_leaf], dloss.reshape(n),
                                    retain_graph=True)
            library_ms = timer(lib)
            library_dev = device_ms(library_kernels(lib))
        bwd.append({
            "check": "softmax_xent_bwd_%dx%d_%s%s" % (
                n, c, tag, "_dsm" if with_dsm else ""),
            "logits": [n, c], "dtype": tag, "eps": eps, "dsm": with_dsm,
            "max_abs_err": err, "tol": TOL_P[dtype],
            "kernel_ms": timer(lambda: sx.softmax_xent_bwd(*args)),
            "device_ms": device_ms(library_kernels(
                lambda: sx.softmax_xent_bwd(*args))),
            "plain_ms": timer(lambda: sx.softmax_xent_bwd_reference(*args),
                              iters=5),
            "library_ms": library_ms, "library_device_ms": library_dev,
            "bound_ms": bound_ms, "bound_by": bound_by, "ok": ok})
        del dsm, args
    del logits, sm, lib_leaf, lib_loss
    torch.cuda.empty_cache()
    return fwd, bwd


def quant_matmul_case(qm, timer, m, k, n, mode, dtype, xscale=None):
    """Kernel #7 against ``dequant_matmul_reference``.  weight_only within
    TOL (float32 sums in another order); dynamic: the int8 grid qx, its
    scales sx and the int32 accumulator must equal the plain version's bit
    for bit (the output follows from them).  The library yardstick is
    ``torch.matmul`` on a weight dequantized beforehand (the float32 path
    int8 replaces) for weight_only, and ``torch._int_mm`` (the int32
    product alone) for dynamic where it takes the shape."""
    tag = str(dtype).replace("torch.", "")
    g = torch.Generator(device="cuda").manual_seed(m * 7 + k * 3 + n)
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    w = torch.randn((k, n), generator=g, device="cuda") * 0.05
    scale = torch.clamp(w.abs().amax(dim=0), min=1e-12) / 127.0
    qw = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    del w
    xs = (None if xscale is None
          else torch.tensor([xscale], dtype=torch.float32, device="cuda"))
    name = "%s_%dx%dx%d_%s%s" % (mode, m, k, n, tag,
                                 "_xscale" if xscale is not None else "")
    # the K split the kernel takes, against the wrapper's planner
    from paddle_tpu_torch.ops.cuda import build
    gemv, planned, _ = qm._k_splits(m, n, k)
    planned = planned if gemv else 0
    splits = build.library("quant_matmul").ptt_dequant_matmul_splits(
        m, n, k, int(mode == "dynamic"))
    res = {"check": name, "mnk": [m, k, n], "mode": mode, "dtype": tag,
           "xscale": xscale, "splits": splits, "splits_planned": planned}
    want = qm.dequant_matmul_reference(x, qw, scale, mode, xs)
    if mode == "dynamic":
        out, qx, sx, acc = qm.dequant_matmul_kernel(x, qw, scale, mode, xs,
                                                    parts=True)
        again = qm.dequant_matmul_kernel(x, qw, scale, mode, xs, parts=True)
        pqx, psx = qm.quantize_rows_reference(x, xs)
        pacc = qm.int8_matmul_reference(pqx, qw)
        torch.cuda.synchronize()
        res["grid_bit_exact"] = bool(
            torch.equal(qx, pqx)
            and torch.equal(sx, psx.reshape(-1).expand(m))
            and torch.equal(acc, pacc))
        res["out_bit_exact"] = bool(torch.equal(out, want))
        same_bits = all(torch.equal(a, b)
                        for a, b in zip((out, qx, sx, acc), again))
        ok = res["grid_bit_exact"]
        del qx, sx, acc, pqx, pacc, again
    else:
        out = qm.dequant_matmul_kernel(x, qw, scale, mode, xs)
        again = qm.dequant_matmul_kernel(x, qw, scale, mode, xs)
        torch.cuda.synchronize()
        # the K split's partial sums are added in rank order
        same_bits = torch.equal(out, again)
        ok = True
        del again
    # one device kernel a call; the dynamic prefill runs its row grid first
    calls = kernel_calls(lambda: qm.dequant_matmul_kernel(x, qw, scale, mode,
                                                          xs))
    want_calls = 1 if gemv or mode == "weight_only" else 2
    err, close = max_err(out, want, torch.float32)
    res.update(max_abs_err=err, tol=TOL[torch.float32],
               repeatable_bits=same_bits, device_kernel_calls=calls,
               ok=(ok and close and same_bits and splits == planned
                   and sum(calls.values()) == want_calls))
    del out, want
    nbytes = m * k * x.element_size() + k * n + 4 * n + 4 * m * n
    ops = 2.0 * m * k * n
    if mode == "dynamic":
        bound_ms, bound_by = bound(nbytes, ops, torch.int8)
    elif dtype == torch.float32:
        # x_hi w + x_lo w: two TF32 passes (the int8 weight has no lo part)
        bound_ms, bound_by, simt = tf32_bound(nbytes, ops, dtype, passes=2)
        res.update(bound_rate="2xTF32", bound_simt_ms=simt)
    else:
        # one bfloat16 / float16 pass at the tensor cores' 16-bit rate
        bound_ms, bound_by = bound(nbytes, ops, torch.bfloat16)
    res.update(bound_ms=bound_ms, bound_by=bound_by,
               kernel_ms=timer(lambda: qm.dequant_matmul_kernel(
                   x, qw, scale, mode, xs)),
               device_ms=device_ms(library_kernels(
                   lambda: qm.dequant_matmul_kernel(x, qw, scale, mode,
                                                    xs))),
               plain_ms=timer(lambda: qm.dequant_matmul_reference(
                   x, qw, scale, mode, xs), iters=5))
    lib = None
    if mode == "weight_only":
        w_deq = qw.float() * scale
        xf = x.float()

        def lib():
            torch.matmul(xf, w_deq)
        res["library"] = "torch.matmul(x_f32, w_dequantized_f32)"
    else:
        qx_lib = qm.quantize_rows_reference(x, xs)[0]
        try:
            torch._int_mm(qx_lib, qw)

            def lib():
                torch._int_mm(qx_lib, qw)
            res["library"] = "torch._int_mm(qx, qw): the int32 product alone"
        except RuntimeError as e:   # the yardstick does not take the shape
            res["library"] = "none (torch._int_mm: %s)" % str(e)[:80]
    res["library_ms"] = None if lib is None else timer(lib)
    res["library_device_ms"] = (None if lib is None
                                else device_ms(library_kernels(lib)))
    del lib
    torch.cuda.empty_cache()
    return res


def quant_matmul_cases(qm, timer):
    """Kernel #7 at the serving slice's shapes (decode M = 8 against each
    weight, the logits projection first; prefill M = 4096 = 8 slots x the
    512 bucket), then off-path cases: a ragged shape, K < 128, bfloat16 and
    float16 activations and the static XScale."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = []
    for mode in ("weight_only", "dynamic"):
        for k, n in ((512, 32000), (512, 512), (512, 2048), (2048, 512)):
            cases.append((8, k, n, mode, f32, None))
        cases.append((4096, 512, 32000, mode, f32, None))
        cases += [(5, 130, 200, mode, f32, None),
                  (5, 130, 200, mode, bf16, None),
                  (8, 40, 512, mode, f32, None),
                  (8, 512, 32000, mode, bf16, None)]
    # the decode kernel's 16- and 32-row blocks, K split past a stage edge
    cases += [(13, 512, 2048, "weight_only", f32, None),
              (29, 520, 512, "dynamic", f32, None),
              (8, 512, 2048, "weight_only", f16, None),
              (8, 512, 2048, "dynamic", f16, None),
              (8, 512, 2048, "dynamic", f32, 3.0),
              (5, 130, 200, "dynamic", bf16, 3.0)]
    return [quant_matmul_case(qm, timer, *c) for c in cases]


# the fused conv+BN layers of ResNet-50 at batch 128: (B, C, O, HW)
CONV_BN_STAGES = {"stage1": (128, 64, 256, 3136),
                  "stage3": (128, 256, 1024, 196),
                  "stage4": (128, 2048, 512, 49),
                  # off the path: every NHWC tile edge ragged, C and O not
                  # multiples of the 128-wide tile, C not of the k tile
                  "ragged": (1, 72, 200, 1000),
                  # the same in NCHW: 147 positions, HW 49 straddles the
                  # 16-byte chunks of positions and the images the tiles
                  "ragged_hw49": (3, 72, 200, 49)}
# allclose with a magnitude term: |kernel - plain| <= rtol |plain| +
# scale_tol * scale, where scale is the sum of the absolute values of the
# terms each output sums (|W| @ |xn| for z); the two sum ~1e2-4e5 terms in
# different orders.  bfloat16: z and dx are rounded to bf16 (rtol 1e-2),
# and an operand the two round to bf16 from float32 values one ulp apart
# may differ by a bf16 ulp (the scale term).
CONV_BN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-3)}


def tf32_bound(nbytes, ops, dtype, passes=3):
    """(bound ms, by, the float32 units' bound ms or None): a kernel that
    takes float32 on the tensor cores as ``passes`` TF32 passes (#1, #2,
    #8-#11: three; #7: two) is bound at passes x operations / 495 TFLOP/s,
    with the float32 units' bound beside it."""
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    if dtype != torch.float32:
        return bound_ms, bound_by, None
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, passes * ops / TF32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops
            else "operations (%dxTF32)" % passes, bound_ms)


def _close(got, want, scale, dtype, f32_out=False):
    rtol, stol = CONV_BN_TOL[dtype]
    if f32_out:
        rtol = CONV_BN_TOL[torch.float32][0]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= rtol * want.abs() + stol * scale.float()).all()) \
        and bool(torch.isfinite(got).all())
    return float(err.max()), ok


def _conv_bn_inputs(b, c, o, hw, nhwc, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = (rnd(*((b * hw, c) if nhwc else (b, c, hw))) + 0.5).to(dtype)
    w = (rnd(o, c) / c ** 0.5).to(dtype)
    mean = rnd(c) * 0.1 + 0.5
    rstd = torch.rand(c, generator=g, device="cuda") + 0.5
    gamma = torch.rand(c, generator=g, device="cuda") + 0.5
    beta = rnd(c) * 0.1
    shift = rnd(o) * 0.1
    return g, x, w, mean, rstd, gamma, beta, shift


def _conv_bn_prologue(cb, x, mean, rstd, gamma, beta, apply_bn, nhwc):
    """xn as the kernels feed it to the product (rounded to x's dtype),
    and the view that broadcasts a channel vector."""
    view = (1, -1) if nhwc else (1, -1, 1)
    act = "relu" if apply_bn else ""
    return cb._act_norm(x, mean, rstd, gamma, beta, act, apply_bn,
                        view).to(x.dtype), view


def conv_bn_fwd_case(cb, timer, stage, nhwc, apply_bn, dtype):
    """Kernel #8 (NCHW) or #10 (NHWC) against ``bn_act_matmul_reference``,
    and twice against itself (the stats are reduced without atomics).
    ``apply_bn``: the BN-apply + ReLU prologue; else the raw input.  The
    library yardstick computes less: ``F.conv2d`` 1x1 (NCHW) or
    ``torch.matmul`` (NHWC) on an input normalised beforehand, no stats."""
    from torch.nn.functional import conv2d

    b, c, o, hw = CONV_BN_STAGES[stage]
    _, x, w, mean, rstd, gamma, beta, shift = _conv_bn_inputs(
        b, c, o, hw, nhwc, dtype, seed=c + o)
    act = "relu" if apply_bn else ""
    args = (x, w, mean, rstd, gamma, beta, shift, act, apply_bn, True)
    kern = cb.conv_bn_fwd_nhwc if nhwc else cb.conv_bn_fwd
    got = kern(*args)
    again = kern(*args)
    want = cb.bn_act_matmul_reference(*args, nhwc=nhwc)
    xn, view = _conv_bn_prologue(cb, x, mean, rstd, gamma, beta, apply_bn,
                                 nhwc)
    pos = (0,) if nhwc else (0, 2)
    absprod = cb.bn_act_matmul_reference(xn.abs(), w.abs(), None, None, None,
                                         None, None, "", False, False,
                                         nhwc=nhwc)[0].float()
    zc = want[0].float() - shift.view(view)
    scales = [absprod, (zc.abs() + absprod).sum(dim=pos),
              (zc * zc + 2 * zc.abs() * absprod).sum(dim=pos)]
    del absprod, zc
    torch.cuda.synchronize()
    errs = [_close(gt, wt, sc, dtype, f32_out=i > 0)
            for i, (gt, wt, sc) in enumerate(zip(got, want, scales))]
    same_bits = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
    del got, again, want, scales
    n, item = b * hw, x.element_size()
    bound_ms, bound_by, bound_simt = tf32_bound(
        n * c * item + n * o * item + o * c * item, 2.0 * n * c * o, dtype)
    if nhwc:
        wt = w.t()
        library = "torch.matmul(xn, w.t()) on xn normalised beforehand"

        def lib():
            torch.matmul(xn, wt)
    else:
        xn4, w4 = xn.reshape(b, c, hw, 1), w.reshape(o, c, 1, 1)
        library = "F.conv2d 1x1 on xn normalised beforehand"

        def lib():
            conv2d(xn4, w4)
    tag = str(dtype).replace("torch.", "")
    res = {"check": "%s_%s_%s_%s" % ("nhwc" if nhwc else "nchw", stage,
                                     "bn_relu" if apply_bn else "raw", tag),
           "bcoh": [b, c, o, hw], "nhwc": nhwc, "apply_bn": apply_bn,
           "dtype": tag, "max_abs_err": max(e for e, _ in errs),
           "max_abs_err_z_sum_sumsq": [e for e, _ in errs],
           "tol": CONV_BN_TOL[dtype], "repeatable_bits": same_bits,
           "kernel_ms": timer(lambda: kern(*args)),
           "device_ms": device_ms(library_kernels(lambda: kern(*args))),
           "plain_ms": timer(lambda: cb.bn_act_matmul_reference(
               *args, nhwc=nhwc), iters=5),
           "library_ms": timer(lib), "library": library,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": all(ok for _, ok in errs) and same_bits}
    if bound_simt is not None:
        res["bound_simt_ms"] = bound_simt
    del xn, lib
    torch.cuda.empty_cache()
    return res


def conv_bn_bwd_case(cb, timer, stage, nhwc, apply_bn, with_stats, dtype):
    """Kernel #9 (NCHW) or #11 (NHWC) against
    ``bn_act_matmul_bwd_reference``, and twice against itself (dW, dgamma
    and dbeta are reduced in a fixed order).  ``with_stats``: the stats'
    cotangents are folded into dz.  The library yardstick computes less:
    the two products (dx and dW) by ``torch.matmul`` on operands prepared
    beforehand."""
    b, c, o, hw = CONV_BN_STAGES[stage]
    g, x, w, mean, rstd, gamma, beta, shift = _conv_bn_inputs(
        b, c, o, hw, nhwc, dtype, seed=c + o + 1)
    act = "relu" if apply_bn else ""
    z = cb.bn_act_matmul_reference(x, w, mean, rstd, gamma, beta, shift, act,
                                   apply_bn, False, nhwc=nhwc)[0]
    dz = torch.randn(z.shape, generator=g, device="cuda").to(dtype)
    dsum = torch.randn(o, generator=g, device="cuda") if with_stats else None
    dsumsq = (torch.randn(o, generator=g, device="cuda") * 1e-2
              if with_stats else None)
    args = (x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta, shift, act,
            apply_bn, with_stats)
    kern = cb.conv_bn_bwd_nhwc if nhwc else cb.conv_bn_bwd
    got = kern(*args)
    again = kern(*args)
    want = cb.bn_act_matmul_bwd_reference(*args, nhwc=nhwc)
    # magnitudes: the plain backward on |operands| with no prologue gives
    # |W|^T |dz'| and |dz'| |xn|^T
    xn, view = _conv_bn_prologue(cb, x, mean, rstd, gamma, beta, apply_bn,
                                 nhwc)
    d = dz.float()
    if with_stats:
        d = d + dsum.view(view) \
            + 2.0 * (z.float() - shift.view(view)) * dsumsq.view(view)
    d = d.to(dtype)
    dxn_scale, dw_scale, _, _ = cb.bn_act_matmul_bwd_reference(
        xn.abs(), w.abs(), None, d.abs(), None, None, None, None, None, None,
        None, "", False, False, nhwc=nhwc)
    dxn_scale = dxn_scale.float()
    del xn, d
    pos = (0,) if nhwc else (0, 2)
    if apply_bn:
        pre = ((x.float() - mean.view(view)) * rstd.view(view)).abs()
        scales = [dxn_scale * (gamma * rstd).view(view), dw_scale,
                  (dxn_scale * pre).sum(dim=pos), dxn_scale.sum(dim=pos)]
        del pre
    else:
        scales = [dxn_scale, dw_scale, torch.zeros_like(gamma),
                  torch.zeros_like(gamma)]
    torch.cuda.synchronize()
    errs = [_close(gt, wt, sc, dtype, f32_out=i > 0)
            for i, (gt, wt, sc) in enumerate(zip(got, want, scales))]
    same_bits = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
    del got, again, want, scales, dxn_scale, dw_scale
    n, item = b * hw, x.element_size()
    nbytes = (2 * n * c * item + n * o * item * (2 if with_stats else 1)
              + o * c * (item + 4))
    bound_ms, bound_by, bound_simt = tf32_bound(nbytes, 4.0 * n * c * o,
                                                   dtype)
    if nhwc:
        def lib():
            torch.matmul(dz, w)
            torch.matmul(dz.t(), x)
    else:
        wt, xt = w.t(), x.transpose(1, 2)

        def lib():
            torch.matmul(wt, dz)
            torch.matmul(dz, xt).sum(dim=0)
    tag = str(dtype).replace("torch.", "")
    res = {"check": "%s_%s_%s%s_%s" % (
               "nhwc" if nhwc else "nchw", stage,
               "bn_relu" if apply_bn else "raw",
               "_stats" if with_stats else "", tag),
           "bcoh": [b, c, o, hw], "nhwc": nhwc, "apply_bn": apply_bn,
           "with_stats": with_stats, "dtype": tag,
           "max_abs_err": max(e for e, _ in errs),
           "max_abs_err_dx_dw_dgamma_dbeta": [e for e, _ in errs],
           "tol": CONV_BN_TOL[dtype], "repeatable_bits": same_bits,
           "kernel_ms": timer(lambda: kern(*args)),
           "device_ms": device_ms(library_kernels(lambda: kern(*args))),
           "plain_ms": timer(lambda: cb.bn_act_matmul_bwd_reference(
               *args, nhwc=nhwc), iters=5),
           "library_ms": timer(lib),
           "library": "the two products (dx, dW) by torch.matmul",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": all(ok for _, ok in errs) and same_bits}
    if bound_simt is not None:
        res["bound_simt_ms"] = bound_simt
    del x, z, dz, args
    torch.cuda.empty_cache()
    return res


def conv_bn_cases(cb, timer):
    """Kernels #8-#11: the main path's shape first (stage 3, 256 -> 1024
    at 14x14, the most frequent fused layer, with the BN + ReLU prologue
    and, backward, the stats fold), then stage 1 (64 -> 256 at 56x56, raw
    input), stage 4 (2048 -> 512 at 7x7, no stats cotangent backward) and
    stages 3, 1 and 4 in bfloat16 (the AMP path's); each layout.  Then
    each layout's ragged shape in both types, with the prologue and the
    fold."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    for nhwc in (False, True):
        sfx = "_nhwc" if nhwc else ""
        ragged = [("ragged" if nhwc else "ragged_hw49", dt)
                  for dt in (f32, bf16)]
        out["conv_bn_fwd" + sfx] = [
            conv_bn_fwd_case(cb, timer, st, nhwc, bn, dt)
            for st, bn, dt in (("stage3", True, f32), ("stage1", False, f32),
                               ("stage4", True, f32), ("stage3", True, bf16),
                               ("stage1", False, bf16), ("stage4", True, bf16))
            + tuple((st, True, dt) for st, dt in ragged)]
        out["conv_bn_bwd" + sfx] = [
            conv_bn_bwd_case(cb, timer, st, nhwc, bn, ws, dt)
            for st, bn, ws, dt in (("stage3", True, True, f32),
                                   ("stage1", False, True, f32),
                                   ("stage4", True, False, f32),
                                   ("stage3", True, True, bf16),
                                   ("stage1", False, True, bf16),
                                   ("stage4", True, False, bf16))
            + tuple((st, True, True, dt) for st, dt in ragged)]
    return out


def _train_klen():
    """The training slice's key lengths: 256 rows of 64 tokens, lengths
    in [16, 64]; and the same with row 7 empty."""
    train_klen = np.random.RandomState(3).randint(
        16, TRAIN_SEQ + 1, TRAIN_BATCH).tolist()
    train_klen0 = list(train_klen)
    train_klen0[7] = 0
    return train_klen, train_klen0


# the realdist path's buckets (bench.py's transformer_realdist): pad
# bounds and the rows a bucket's batch holds
REALDIST_BOUNDS, REALDIST_SIZES = (16, 32, 48, 64), (512, 256, 170, 128)


def _bucket_klen(bound, rows):
    """Key lengths of one realdist bucket's rows: in (previous bound,
    bound], the first bucket's from 4 (bench.py's shortest sentence)."""
    lo = max([3] + [b for b in REALDIST_BOUNDS if b < bound]) + 1
    return np.random.RandomState(bound).randint(lo, bound + 1, rows).tolist()


def _bucket_attention_cases(case, fa, timer):
    """#1 or #2 (``case``) in bfloat16 with dropout 0.1, causal, at the
    realdist buckets of bound 16, 32 and 48 (64 is the training shape)."""
    return [case(fa, timer, "realdist_b%d_causal_dropout_bfloat16" % bound,
                 bound, bound, True, _bucket_klen(bound, rows),
                 torch.bfloat16, rate=0.1, seed=1234)
            for bound, rows in zip(REALDIST_BOUNDS[:3], REALDIST_SIZES[:3])]


def attention_fwd_cases(timer):
    """Kernel #1 at the training, prefill and decode shapes, the main
    path's (training, causal float32) first."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    train_klen, train_klen0 = _train_klen()
    prefill_klen = [1024, 700, 513, 64, 1, 0, 300, 999]
    decode_klen = [1024, 65, 700, 1, 333, 512, 1000, 2]
    # the decode split (8 ranks of 128 keys at klen 1024) with empty
    # slices: no key, one or two keys, and a klen just past a tile edge
    empty_klen = [0, 65, 129, 1, 2, 193, 1024, 64]
    t = TRAIN_SEQ
    fwd = [attention_case(fa, timer, "train_causal_" + tag, t, t, True,
                          train_klen, dtype)
           for dtype, tag in ((torch.float32, "float32"),
                              (torch.bfloat16, "bfloat16"))]
    fwd.append(attention_case(fa, timer, "train_self_dropout_klen0", t, t,
                              False, train_klen0, torch.float32, rate=0.1,
                              seed=1234))
    # the AMP training path's calls: bfloat16 with dropout 0.1, causal
    # (decoder self-attention) and not (encoder and cross attention)
    for causal, tag in ((True, "causal"), (False, "self")):
        fwd.append(attention_case(fa, timer,
                                  "train_%s_dropout_bfloat16" % tag, t, t,
                                  causal, train_klen, torch.bfloat16,
                                  rate=0.1, seed=1234))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        fwd.append(attention_case(fa, timer, "prefill_" + tag, 1024, 1024,
                                  True, prefill_klen, dtype))
        fwd.append(attention_case(fa, timer, "decode_" + tag, 1, 1024,
                                  True, decode_klen, dtype))
    fwd.append(attention_case(fa, timer, "prefill_float32_dropout", 1024,
                              1024, True, prefill_klen, torch.float32,
                              rate=0.1, seed=1234))
    fwd.append(attention_case(fa, timer, "decode_empty_slices_float32", 1,
                              1024, True, empty_klen, torch.float32))
    # the key split of Tq > 1 (the tiles' 64-row partials combined): the
    # engine's 128 and 256 prefill buckets at 8 slots (cluster 2), the
    # suffix (Tq < Tk) alignment (cluster 4), and the B = 1 causal score
    # program over the longest served sequence (cluster 4)
    for t, kl in ((128, [128, 100, 65, 64, 1, 0, 127, 33]),
                  (256, [256, 200, 129, 64, 1, 0, 255, 130])):
        for dtype in (torch.float32, torch.bfloat16):
            fwd.append(attention_case(
                fa, timer, "prefill_bucket%d_%s" % (t, str(dtype)[6:]), t, t,
                True, kl, dtype, split=True))
    fwd.append(attention_case(fa, timer, "suffix_dropout_float32", 70, 300,
                              True, [300, 150, 70, 71, 299, 100, 3, 250],
                              torch.float32, rate=0.1, seed=99, split=True))
    t = max(SERVE_PROMPTS) + MAX_NEW
    fwd.append(attention_case(fa, timer, "score_b1_float32", t, t, True, [t],
                              torch.float32, split=True))
    return fwd + _bucket_attention_cases(attention_case, fa, timer)


def layer_norm_fwd_cases(timer):
    """Kernel #3 at the training rows (the main path's shape first), the
    prefill and decode rows, and bfloat16."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln

    rows, d = TRAIN_BATCH * TRAIN_SEQ, TRAIN["d_model"]
    # 8192 and 8160: the realdist buckets' rows (512 x 16 ... 128 x 64,
    # and 170 x 48)
    norm = [layer_norm_case(ln, timer, n, d, torch.float32)
            for n in (rows, 8 * 1024, 8, 8160)]
    norm.append(layer_norm_case(ln, timer, rows, d, torch.bfloat16))
    return norm


def serve_kernel_cases(timer):
    """Kernels #1, #3 and #7, the serving path's, against their plain
    versions (``--serve-kernels``)."""
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    return {"flash_attention_fwd": attention_fwd_cases(timer),
            "layer_norm_fwd": layer_norm_fwd_cases(timer),
            "dequant_matmul": quant_matmul_cases(qm, timer)}


def train_kernel_cases(timer):
    """Kernels #1-#6 (the serving and Transformer-training slices)
    against their plain versions; {kernel name: [checks]}, the main
    path's shape first."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    from paddle_tpu_torch.ops.cuda import softmax_xent as sx

    train_klen, train_klen0 = _train_klen()
    t = TRAIN_SEQ
    bwd = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        bwd.append(attention_bwd_case(fa, timer, "train_causal_" + tag, t,
                                      t, True, train_klen, dtype))
        bwd.append(attention_bwd_case(fa, timer, "train_self_" + tag, t, t,
                                      False, train_klen, dtype))
    bwd.append(attention_bwd_case(fa, timer, "train_causal_dropout_klen0", t,
                                  t, True, train_klen0, torch.float32,
                                  rate=0.1, seed=1234))
    for causal, tag in ((True, "causal"), (False, "self")):
        bwd.append(attention_bwd_case(fa, timer,
                                      "train_%s_dropout_bfloat16" % tag, t,
                                      t, causal, train_klen, torch.bfloat16,
                                      rate=0.1, seed=1234))
    # off the training path: several tiles per row, ragged last tiles,
    # and the suffix (Tq < Tk) causal alignment
    ragged_klen = [200, 150, 65, 64, 1, 0, 130, 199]
    for dtype in (torch.float32, torch.bfloat16):
        bwd.append(attention_bwd_case(
            fa, timer, "ragged_causal_" + str(dtype)[6:], 200, 200, True,
            ragged_klen, dtype))
    bwd.append(attention_bwd_case(fa, timer, "suffix_dropout", 70, 300,
                                  True, [300, 150, 70, 71, 299, 100, 3, 250],
                                  torch.float32, rate=0.1, seed=99))
    bwd += _bucket_attention_cases(attention_bwd_case, fa, timer)
    rows = TRAIN_BATCH * TRAIN_SEQ
    d = TRAIN["d_model"]
    norm_bwd = [layer_norm_bwd_case(ln, timer, rows, d, dt)
                for dt in (torch.float32, torch.bfloat16)]
    # off the path: a ragged last block of rows and other row widths
    norm_bwd += [layer_norm_bwd_case(ln, timer, 1000, 96, torch.float32),
                 layer_norm_bwd_case(ln, timer, 5, 1024, torch.bfloat16)]
    norm_bwd += [layer_norm_bwd_case(ln, timer, n, d, torch.float32)
                 for n in (8192, 8160)]
    xent_fwd, xent_bwd = [], []
    for dtype in (torch.float32, torch.bfloat16):
        f, b = softmax_xent_cases(sx, timer, rows, TRAIN_VOCAB, 0.1, dtype)
        xent_fwd.append(f)
        xent_bwd += b
    # 300 x 1000: off the path; 8192 and 8160: the realdist buckets
    for n, c, eps in ((300, 1000, 0.0), (8192, TRAIN_VOCAB, 0.1),
                      (8160, TRAIN_VOCAB, 0.1)):
        f, b = softmax_xent_cases(sx, timer, n, c, eps, torch.float32)
        xent_fwd.append(f)
        xent_bwd += b
    return {"flash_attention_fwd": attention_fwd_cases(timer),
            "flash_attention_bwd": bwd,
            "layer_norm_fwd": layer_norm_fwd_cases(timer),
            "layer_norm_bwd": norm_bwd,
            "softmax_xent_fwd": xent_fwd, "softmax_xent_bwd": xent_bwd}


def log_checks(checks):
    """Log the kernel checks, with the launches they and their timing
    loops made (the main paths' counts are taken separately, in the
    serve and train phases); fail if any kernel disagrees."""
    from paddle_tpu_torch.ops import cuda

    log("kernels", dict(checks, check_launches=cuda.launch_counts()))
    bad = [c["check"] for cs in checks.values() for c in cs if not c["ok"]]
    if bad:
        raise SystemExit("kernel disagrees with its plain version: %s"
                         % bad)
    return checks


def kernels_phase():
    """Every kernel against its plain version at its paths' shapes.
    Returns {kernel name: [checks]}, the main path's shape first."""
    from paddle_tpu_torch.ops.cuda import conv_bn as cb
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    timer = Timer()
    checks = train_kernel_cases(timer)
    checks["dequant_matmul"] = quant_matmul_cases(qm, timer)
    checks.update(conv_bn_cases(cb, timer))
    return log_checks(checks)


# ---------------------------------------------------------------------------
# phases 4-6: the serving slices
# ---------------------------------------------------------------------------

def count_ops(program, op_type):
    return sum(op.type == op_type for op in program.global_block().ops)


def rel_l1(ref, out):
    """Relative L1 distance (the JAX package's ``autotune.eval_delta``): the
    int8 accuracy budget's metric, ``FLAGS_quantize_accuracy_budget``
    0.02."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).sum() / (np.abs(ref).sum() + 1e-12))


INT8_BUDGET = 0.02
# the bfloat16 score program's logits against the float32 program's, by
# the same metric: the one-shot inference band (bf16 weights and
# activations round at 2^-8 relative, well inside the int8 budget)
INFER_BF16_BAND = 0.02


def device_window(fn):
    """Run ``fn`` under ``torch.profiler``: its host wall (which the
    profiler's own host work lengthens), the device's busy time (the union
    of the kernel and copy intervals) and idle share, the number of device
    events, each kernel's launches as the device trace shows them
    (``trace_launches``: what a replayed CUDA graph ran) and as its wrapper
    counted them in the window (``wrapper_launches``: launches made from
    the host, none in a replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import cuda

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_SETTLE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    wrapper = cuda.launch_counts()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("dispatch/")]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in events]) / 1e3
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall * 1e3),
            "device_events": len(events),
            "trace_launches": cuda.device_launch_counts(
                e.name for e in events),
            "wrapper_launches": wrapper}


def launch_record(captured, timed, need, window, window_need):
    """A path's launch counts beside what its program implies (read by
    ``launch_faults``): its wrappers' counts over its timed runs
    (``timed``, implied ``need``) and its profiled window (``window``, a
    ``device_window``, implied ``window_need``)."""
    return dict(captured=captured, timed=timed, need=need, window=window,
                window_need=window_need)


def launch_faults(rec):
    """{check:kernel: (counted, implied)} where a path's launches are not
    what its program implies (kernels it leaves out: none).  A captured
    path's timed runs and profiled window replay graphs: its wrappers
    launch nothing, and the window's device trace shows each kernel as
    often as the program implies.  An eager path's wrappers launch each
    kernel as often as the program implies, in the timed runs and in the
    window, whose trace shows the same counts."""
    from paddle_tpu_torch.ops.cuda import KERNELS

    window, eager = rec["window"], not rec["captured"]
    checks = (("timed", rec["timed"], rec["need"] if eager else {}),
              ("window_wrapper", window["wrapper_launches"],
               rec["window_need"] if eager else {}),
              ("window_trace", window["trace_launches"], rec["window_need"]))
    return {"%s:%s" % (check, k): (got.get(k, 0), want.get(k, 0))
            for check, got, want in checks for k in KERNELS
            if got.get(k, 0) != want.get(k, 0)}


def _warm_buckets(eng, lengths, submit):
    """Two dispatches of every bucket the lengths fall in, one request at
    a time, so that a captured engine has captured each of them before it
    is timed (an entry runs eagerly first, captures at its second run)."""
    for n in sorted({eng._sched.bucket_for(n): n for n in lengths}.values()):
        for _ in range(2):
            submit(n).result(900)


def serve_phase(place, model=MODEL, n_requests=N_REQUESTS, max_new=MAX_NEW,
                prompt_range=SERVE_PROMPTS, quantize=None, capture=True):
    """Serve ``n_requests`` prompts through ``GenerationEngine`` on
    ``place`` (int8 weights with ``quantize``; CUDA graphs of every
    dispatch with ``capture``, every dispatch eager without); returns (the
    summary dict, its ``launch_record``, the results).  The engine first
    dispatches every bucket the prompts fall in twice; then the requests
    are served with the launch counters zeroed just before and read just
    after (timed), and once more under the profiler (device busy time,
    idle share, launches in the trace)."""
    from paddle_tpu_torch.ops import cuda
    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_lm
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    fp_spec = build_decoder_lm(**model)
    eng = GenerationEngine(fp_spec, place=place, max_new_tokens=max_new,
                           record_logits=True, timeout_s=900.0, start=False,
                           quantize=quantize, capture=capture)
    spec = eng.spec
    rng = np.random.RandomState(0)
    # arrival order shuffled, so admissions mix buckets as traffic would
    lens = rng.permutation(np.linspace(prompt_range[0], prompt_range[1],
                                       n_requests).astype(int))
    prompts = [list(rng.randint(0, model["vocab_size"], n)) for n in lens]
    try:
        torch.cuda.reset_peak_memory_stats()
        eng.start()
        _warm_buckets(eng, lens, lambda n: eng.submit(
            prompts[list(lens).index(n)], max_new_tokens=2))
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
        peak = torch.cuda.max_memory_allocated()
        metrics, eng.metrics = eng.metrics, ServingMetrics()
        window = device_window(lambda: [r.result(900) for r in [
            eng.submit(p) for p in prompts]])
        profiled = eng.metrics.summary()["counts"]
    finally:
        eng.close()

    counts = metrics.summary()["counts"]
    dispatches = counts["batches"] + counts["decode_steps"]
    profiled_dispatches = profiled["batches"] + profiled["decode_steps"]
    tokens = sum(len(r["tokens"]) for r in results)
    assert counts["completed"] == n_requests, counts
    assert all(len(r["tokens"]) == max_new for r in results), \
        [len(r["tokens"]) for r in results]

    # decode-vs-recompute: the longest request's recorded logits against
    # a full causal forward of the score program over prompt + output
    i = int(np.argmax(lens))
    seq = prompts[i] + results[i]["tokens"]
    t = len(seq)
    feed = {"tok": np.asarray(seq, "int64").reshape(1, t, 1),
            "tok@LEN": np.asarray([t], "int32"),
            "pos": np.arange(t, dtype="int64").reshape(1, t, 1)}
    with torch.inference_mode():
        (full,) = eng._exe.run(spec.score_program, feed=feed,
                               fetch_list=[spec.score_logits],
                               scope=eng._scope)
        # the fp masters stay in the scope beside the int8 weights
        (fp_full,) = eng._exe.run(fp_spec.score_program, feed=feed,
                                  fetch_list=[fp_spec.score_logits],
                                  scope=eng._scope) if quantize else (full,)
    assert full.shape == (1, t, model["vocab_size"]), full.shape
    assert np.isfinite(full).all()
    want = full[0, len(prompts[i]) - 1:t - 1]
    got = np.stack(results[i]["logits"])
    recompute_rel_l1 = rel_l1(want, got)
    if quantize == "dynamic":
        # a per-row int8 grid may round an activation differently when the
        # decode and the recompute differ in the last float bits
        assert recompute_rel_l1 < INT8_BUDGET, recompute_rel_l1
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    vs_fp = rel_l1(fp_full, full)
    assert vs_fp < INT8_BUDGET, vs_fp

    pre = metrics.percentiles("prefill")
    dec = metrics.percentiles("decode")
    summary = {
        "capture": capture, "requests": n_requests, "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefills": counts["batches"],
        "decode_steps": counts["decode_steps"],
        "p50_prefill_ms": pre["p50_s"] * 1e3,
        "p50_decode_step_ms": dec["p50_s"] * 1e3,
        "p50_request_ms": metrics.percentiles()["p50_s"] * 1e3,
        "profiled_pass": window, "peak_mem_gb": peak / 1e9,
        "graphs": sum(s.graph is not None for s in eng._exe._steps.values()),
        "recompute_max_abs_err": float(np.abs(got - want).max()),
        "recompute_rel_l1": recompute_rel_l1,
        "quantize": quantize, "score_vs_fp_rel_l1": vs_fp,
        "launches": launches, "dispatches": dispatches,
        "profiled_dispatches": profiled_dispatches,
        "cache_mb": spec.cache.bytes() / 1e6,
        "params_mb": sum(
            eng._scope.var(n).numel() * eng._scope.var(n).element_size()
            for n in eng._scope.local_var_names()
            if n not in spec.cache.names()) / 1e6}
    n_dq = count_ops(spec.decode_program, "dequant_matmul")
    assert n_dq == count_ops(spec.prefill_program, "dequant_matmul")
    assert (n_dq > 0) == bool(quantize), n_dq
    if quantize:
        info = spec.score_program._quantize_info["weights"]
        assert all(4 * w["bytes_int8"] == w["bytes_fp"]
                   for w in info.values()), info
        # the engine's scope holds the int8 weights on the engine's device
        assert all(eng._scope.var(w["int8"]).dtype == torch.int8
                   and eng._scope.var(w["int8"]).device == place.device
                   for w in info.values())
        summary.update(
            int8_weights=len(info),
            int8_weight_mb=sum(w["bytes_int8"] for w in info.values()) / 1e6,
            fp_weight_mb=sum(w["bytes_fp"] for w in info.values()) / 1e6,
            dequant_matmul_per_dispatch=n_dq)
    per = {"flash_attention_fwd": model["n_layer"],
           "layer_norm_fwd": 2 * model["n_layer"],
           "dequant_matmul": n_dq}
    return summary, launch_record(
        capture, launches, {k: n * dispatches for k, n in per.items()},
        window, {k: n * profiled_dispatches for k, n in per.items()}), results


def serve_phases(place):
    """fp, weight_only and dynamic serving, each captured and eager in
    turns (the order flips from mode to mode, as host load drifts within
    a call); the generated tokens and the recorded logits of the two runs
    must be the same bits.  Returns {path: (summary, launch record)}, the
    captured runs as ``serve`` / ``serve_int8:<mode>`` and the eager ones
    with ``:eager`` after."""
    # what a captured dispatch adds: the clone of a prefill's fetched
    # [slots, 512, vocab] logits (a replay rewrites the graph's own)
    logits = torch.empty((MODEL["slots"], 512, MODEL["vocab_size"]),
                         device="cuda")
    nbytes = 2 * logits.numel() * logits.element_size()
    log("fetch_clone", {"shape": list(logits.shape),
                        "ms": Timer()(logits.clone, iters=10),
                        "bound_ms": bound(nbytes, 0, torch.float32)[0]})
    del logits
    out, bad = {}, []
    for i, quantize in enumerate((None, "weight_only", "dynamic")):
        path = "serve_int8:" + quantize if quantize else "serve"
        runs = {}
        for capture in ((True, False) if i % 2 else (False, True)):
            summary, record, results = serve_phase(
                place, quantize=quantize, capture=capture)
            runs[capture] = results
            name = path if capture else path + ":eager"
            log("serve_int8" if quantize else "serve", summary)
            out[name] = summary, record
        same = [a["tokens"] == b["tokens"]
                and all(np.array_equal(x, y)
                        for x, y in zip(a["logits"], b["logits"]))
                for a, b in zip(runs[True], runs[False])]
        log("capture_check", {"path": path, "same_bits_as_eager": all(same)})
        if not all(same):
            bad.append(path)
    if bad:
        raise SystemExit("captured serving differs from eager: %s" % bad)
    return out


def _infer_requests(n_requests, length_range, vocab, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.permutation(np.linspace(length_range[0], length_range[1],
                                       n_requests).astype(int))
    return [{"tok": rng.randint(0, vocab, (n, 1)).astype("int64"),
             "pos": np.arange(n, dtype="int64").reshape(n, 1)}
            for n in lens]


def _direct(exe, program, fetch, scope, req):
    """One request through ``Executor.run`` alone: the engine's oracle."""
    t = len(req["tok"])
    (out,) = exe.run(program, feed={"tok": req["tok"].reshape(1, t, 1),
                                    "tok@LEN": np.asarray([t], "int32"),
                                    "pos": req["pos"].reshape(1, t, 1)},
                     fetch_list=[fetch], scope=scope)
    return out[0]


def _serve_infer(eng, reqs):
    """Two dispatches of every bucket ``reqs`` fall in, then ``reqs`` with
    the launch counters zeroed just before and read just after (timed),
    then once more under the profiler; returns (outputs, launches,
    summary, with the profiled pass's batches)."""
    from paddle_tpu_torch.ops import cuda
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    lens = [len(q["tok"]) for q in reqs]
    torch.cuda.reset_peak_memory_stats()
    _warm_buckets(eng, lens, lambda n: eng.submit(reqs[lens.index(n)]))
    eng.metrics = ServingMetrics()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [r.result(900)[0] for r in [eng.submit(q) for q in reqs]]
    if eng.place.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    counts = eng.metrics.summary()["counts"]
    assert counts["completed"] == len(reqs), counts
    tokens = sum(len(q["tok"]) for q in reqs)
    summary = {
        "capture": eng._exe.capture, "requests": len(reqs),
        "tokens": tokens, "wall_s": wall,
        "requests_per_s": len(reqs) / wall, "tokens_per_s": tokens / wall,
        "batches": counts["batches"],
        "p50_batch_ms": eng.metrics.percentiles("batch")["p50_s"] * 1e3,
        "p50_request_ms": eng.metrics.percentiles()["p50_s"] * 1e3,
        "peak_mem_gb": peak / 1e9}
    eng.metrics = ServingMetrics()
    summary["profiled_pass"] = device_window(
        lambda: [r.result(900) for r in [eng.submit(q) for q in reqs]])
    summary["profiled_batches"] = eng.metrics.summary()["counts"]["batches"]
    summary["graphs"] = sum(s.graph is not None
                            for s in eng._exe._steps.values())
    return outs, launches, summary


def infer_phase(place, model=MODEL, n_requests=N_REQUESTS,
                length_range=(32, 256)):
    """The decoder's score program (feeds tok, tok@LEN, pos; fetch the
    logits) saved with ``io.save_inference_model`` and served cold by
    ``InferenceEngine(model_dir=..., quantize="weight_only")``; then the
    quantized program saved again and served cold with no pass.  Each
    request's [T, vocab] logits must match a direct ``Executor.run`` of the
    quantized program (2e-4) and the fp program (relative L1 < 0.02).  The
    first engine is served eagerly too (``capture=False``, before the
    captured one): the two give the same bits.  Returns (summary, {path:
    launch record}) for the engines' runs."""
    import shutil
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import InferenceEngine, build_decoder_lm

    tmp = os.path.join(REPO, "_smoke_tmp")
    os.makedirs(tmp, exist_ok=True)
    work = tempfile.mkdtemp(dir=tmp)
    try:
        spec = build_decoder_lm(**model)
        exe, scope = pt.Executor(place), pt.Scope()
        spec.init_scope(exe, scope)
        feeds = ["tok", "tok@LEN", "pos"]
        fp_dir, q_dir = os.path.join(work, "fp"), os.path.join(work, "int8")
        with pt.scope_guard(scope):
            pt.io.save_inference_model(fp_dir, feeds, [spec.score_logits],
                                       exe, main_program=spec.score_program)
        reqs = _infer_requests(n_requests, length_range,
                               model["vocab_size"])
        served = {}
        for capture in (False, True):
            eng = InferenceEngine(model_dir=fp_dir, place=place,
                                  slots=model["slots"],
                                  quantize="weight_only", timeout_s=900.0,
                                  capture=capture)
            try:
                served[capture] = _serve_infer(eng, reqs)
            finally:
                eng.close()
        outs, launches, summary = served[True]
        eager_outs, eager_launches, eager_summary = served[False]
        same_bits = all(np.array_equal(a, b)
                        for a, b in zip(outs, eager_outs))
        prog, logits = eng._program, eng._fetch_vars[0]
        n_dq = count_ops(prog, "dequant_matmul")
        per = {"dequant_matmul": n_dq, "flash_attention_fwd": model["n_layer"],
               "layer_norm_fwd": 2 * model["n_layer"]}
        int8 = {n for n in eng._scope.local_var_names()
                if n.endswith("@INT8")}
        assert int8 and all(eng._scope.var(n).dtype == torch.int8
                            and eng._scope.var(n).device == place.device
                            for n in int8), "int8 weights off the card"
        # the oracles: each request alone through the quantized and the fp
        # programs (the fp masters are still in the engine's scope)
        errs, deltas = [], []
        with torch.inference_mode():
            with open(os.path.join(fp_dir, "__model__")) as f:
                fp_prog = pt.Program.from_dict(json.load(f)["program"])
            for q, out in zip(reqs, outs):
                assert out.shape == (len(q["tok"]), model["vocab_size"])
                want = _direct(eng._exe, prog, logits.name, eng._scope, q)
                np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
                errs.append(float(np.abs(out - want).max()))
                deltas.append(rel_l1(_direct(
                    eng._exe, fp_prog, logits.name, eng._scope, q), out))
        assert max(deltas) < INT8_BUDGET, deltas
        # the quantized program saved again and loaded cold: no pass
        with pt.scope_guard(eng._scope):
            pt.io.save_inference_model(q_dir, feeds, [logits], eng._exe,
                                       main_program=prog)
        cold = InferenceEngine(model_dir=q_dir, place=place,
                               slots=model["slots"], timeout_s=900.0)
        try:
            assert cold.quantize_mode is None
            assert count_ops(cold._program, "dequant_matmul") == n_dq
            assert cold._scope.find_var("declm_logits.w_0") is None
            cold_outs, cold_launches, cold_summary = _serve_infer(cold, reqs)
        finally:
            cold.close()
        cold_err = max(float(np.abs(a - b).max())
                       for a, b in zip(cold_outs, outs))
        assert cold_err <= 2e-4, cold_err

        def mb(d):
            return sum(os.path.getsize(os.path.join(d, f))
                       for f in os.listdir(d)) / 1e6
        summary.update(
            eager=eager_summary, same_bits_as_eager=same_bits,
            quantize="weight_only", dequant_matmul_per_batch=n_dq,
            launches=launches, vs_direct_max_abs_err=max(errs),
            vs_fp_rel_l1_max=max(deltas), artifact_fp_mb=mb(fp_dir),
            artifact_int8_mb=mb(q_dir), cold=cold_summary,
            cold_launches=cold_launches, cold_vs_first_max_abs_err=cold_err)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if not os.listdir(tmp):
            os.rmdir(tmp)

    def record(launches, s):
        return launch_record(
            s["capture"], launches,
            {k: n * s["batches"] for k, n in per.items()},
            s["profiled_pass"],
            {k: n * s["profiled_batches"] for k, n in per.items()})
    return summary, {"infer": record(launches, summary),
                     "infer:eager": record(eager_launches, eager_summary),
                     "infer_cold": record(cold_launches, cold_summary)}


def infer_bf16_phase(place, model=MODEL, n_requests=N_REQUESTS,
                     length_range=(32, 256)):
    """The decoder's score program saved in float32, loaded, rewritten by
    ``contrib.Bfloat16Transpiler`` (bfloat16 parameters in the scope, #1
    and #3 in bfloat16, the logits cast back to float32) and saved again
    (``io`` writes bfloat16 as float32); served cold from that artifact
    by ``InferenceEngine`` (captured: each bucket's second dispatch
    captured, the rest replayed).  Each request's [T, vocab] logits come
    back float32 and within relative L1 ``INFER_BF16_BAND`` of a direct
    run of the float32 program; the engine's parameters are bfloat16 on
    the card.  Returns (summary, {path: launch record})."""
    import shutil
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import Bfloat16Transpiler
    from paddle_tpu_torch.serving import InferenceEngine, build_decoder_lm

    tmp = os.path.join(REPO, "_smoke_tmp")
    os.makedirs(tmp, exist_ok=True)
    work = tempfile.mkdtemp(dir=tmp)
    try:
        spec = build_decoder_lm(**model)
        exe, scope = pt.Executor(place), pt.Scope()
        spec.init_scope(exe, scope)
        feeds = ["tok", "tok@LEN", "pos"]
        fp_dir, bf_dir = os.path.join(work, "fp"), os.path.join(work, "bf16")
        with pt.scope_guard(scope):
            pt.io.save_inference_model(fp_dir, feeds, [spec.score_logits],
                                       exe, main_program=spec.score_program)
        rewrite_scope = pt.Scope()
        with pt.scope_guard(rewrite_scope):
            prog, _, fetch = pt.io.load_inference_model(fp_dir, exe)
            Bfloat16Transpiler().transpile(prog, place, scope=rewrite_scope,
                                           fetch_targets=fetch)
            pt.io.save_inference_model(bf_dir, feeds, fetch, exe,
                                       main_program=prog)
        del rewrite_scope
        reqs = _infer_requests(n_requests, length_range,
                               model["vocab_size"])
        eng = InferenceEngine(model_dir=bf_dir, place=place,
                              slots=model["slots"], timeout_s=900.0)
        try:
            outs, launches, summary = _serve_infer(eng, reqs)
            params = [p.name for p in eng._program.all_parameters()]
            not_bf16 = [n for n in params
                        if eng._scope.var(n).dtype != torch.bfloat16
                        or eng._scope.var(n).device != place.device]
            casts = count_ops(eng._program, "cast")
            fetch_dtype = str(eng._fetch_vars[0].dtype)
        finally:
            eng.close()
        deltas = []
        with torch.inference_mode():
            for q, out in zip(reqs, outs):
                assert out.dtype == np.float32, out.dtype
                assert out.shape == (len(q["tok"]), model["vocab_size"])
                deltas.append(rel_l1(_direct(
                    exe, spec.score_program, spec.score_logits.name, scope,
                    q), out))
        per = {"flash_attention_fwd": model["n_layer"],
               "layer_norm_fwd": 2 * model["n_layer"]}
        summary.update(params=len(params), not_bfloat16=not_bf16,
                       cast_ops=casts, fetch_dtype=fetch_dtype,
                       vs_fp32_rel_l1_max=max(deltas),
                       vs_fp32_rel_l1_median=statistics.median(deltas),
                       band=INFER_BF16_BAND, launches=launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if not os.listdir(tmp):
            os.rmdir(tmp)
    log("infer_bf16", summary)
    if not_bf16 or max(deltas) >= INFER_BF16_BAND \
            or fetch_dtype != "torch.float32":
        raise SystemExit("the bf16 score program disagrees: %s" % summary)
    return summary, {"infer_bf16": launch_record(
        summary["capture"], launches,
        {k: n * summary["batches"] for k, n in per.items()},
        summary["profiled_pass"],
        {k: n * summary["profiled_batches"] for k, n in per.items()})}


# ---------------------------------------------------------------------------
# phases 7 and 8: the training slice
# ---------------------------------------------------------------------------

def build_train(dropout, amp=False):
    """(main, startup, cost) of bench.py's Transformer-base train program,
    built with the port's layers; with ``amp`` the optimizer is wrapped in
    ``contrib.mixed_precision.decorate``, as bench.py's ``_maybe_amp``
    does for its default (bf16) rungs.  Fixed program seeds: every run
    starts from the same random weights and draws the same dropout
    masks."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    main.random_seed, startup.random_seed = 2, 1
    with pt.program_guard(main, startup):
        words = [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = transformer.transformer(
            *words, TRAIN_SEQ, TRAIN_SEQ, TRAIN_VOCAB, TRAIN_VOCAB,
            dropout_rate=dropout, label_smooth_eps=0.1, **TRAIN)
        lr = pt.layers.noam_decay(TRAIN["d_model"], 4000)
        opt = optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                             epsilon=1e-9)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(cost)
    return main, startup, cost


def float32_state_faults(program, scope):
    """The persistables ``program`` declares float32 whose scope value is
    not: under AMP the parameters, the optimizer's moments and velocities
    and the running statistics stay float32 masters."""
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and v.dtype == torch.float32
                  and scope.find_var(v.name) is not None
                  and scope.find_var(v.name).dtype != torch.float32)


def train_feed(rng, batch):
    """Random ids in [2, vocab) (as bench.py draws them); source and
    target lengths drawn per row in [16, 64], the labels padded as the
    target."""
    src_len = rng.randint(16, TRAIN_SEQ + 1, batch).astype("int32")
    tgt_len = rng.randint(16, TRAIN_SEQ + 1, batch).astype("int32")
    feed = {n: rng.randint(2, TRAIN_VOCAB, (batch, TRAIN_SEQ, 1))
            .astype("int64") for n in ("src_word", "tgt_word", "lbl_word")}
    feed.update({"src_word@LEN": src_len, "tgt_word@LEN": tgt_len,
                 "lbl_word@LEN": tgt_len})
    return feed


def kernel_launches_per_step(program):
    """Each kernel's launches in one step, from the program's ops: a grad
    op reruns its forward (the generic grad's recompute), so each forward
    kernel launches once per forward op and once per grad op."""
    n = {}
    for op in program.global_block().ops:
        n[op.type] = n.get(op.type, 0) + 1
    per = {}
    for kernel, op in (("flash_attention", "fused_attention"),
                       ("layer_norm", "layer_norm"),
                       ("softmax_xent", "softmax_with_cross_entropy")):
        grads = n.get(op + "_grad", 0)
        per[kernel + "_fwd"] = n.get(op, 0) + grads
        per[kernel + "_bwd"] = grads
    return per


# Under AMP no fixed gradient band holds at batch 4, on either device:
# scaling every weight by (1 + 1e-7 N(0, 1)) moves the AMP step's
# gradients by 3.5e-2 relative L2 at the median and 2.46 at most on the
# CPU (the decoder's self-attention q/k weights: near-uniform attention
# at initialisation makes their gradient a difference of near-equal sums,
# and bf16 rounds each term at 2^-8).  So under AMP the card is held to
# the CPU as ``resnet_check`` holds it: within ``floor_scale`` times a
# floor that nudge gives on the card in the same call, median and maximum.
AMP_NUDGE = 1e-7


def relu_sign_flips(program, feed, got, want):
    """The ReLU inputs (the FFNs' first products) whose sign differs
    between two runs of ``program`` (``got``, ``want``: the fetches of
    ``relu_inputs``), at the rows' valid positions: (count, the largest
    magnitude among them)."""
    n, top = 0, 0.0
    for name, a, b in zip(relu_inputs(program), got, want):
        lens = feed["src_word@LEN" if name.startswith("enc")
                    else "tgt_word@LEN"]
        valid = np.arange(a.shape[1])[None, :] < lens[:, None]
        flip = np.sign(a[valid]) != np.sign(b[valid])
        n += int(flip.sum())
        if flip.any():
            top = max(top, float(np.abs(a[valid][flip]).max()))
    return n, top


def relu_inputs(program):
    return [op.inputs["X"][0] for op in program.global_block().ops
            if op.type == "relu"]


@contextlib.contextmanager
def relu_decisions(program, card_inputs):
    """While open, each ``relu`` op of ``program`` keeps the units that the
    card kept: Out = X * (the card's X > 0), ``card_inputs`` being the
    card's fetches of ``relu_inputs``.  The CPU step then takes the card's
    side wherever a ReLU input lies within float32 rounding of 0 and
    computes every value itself; its backward (the generic grad reruns
    the forward) passes the gradient through the same units."""
    from paddle_tpu_torch import registry

    at = [i for i, op in enumerate(program.global_block().ops)
          if op.type == "relu"]
    keep = {i: torch.from_numpy(a > 0) for i, a in zip(at, card_inputs)}
    relu = registry.get_op_def("relu")
    plain = relu.compute
    relu.compute = lambda ins, attrs, ctx, op_index: {
        "Out": ins["X"][0] * keep[op_index].to(ins["X"][0].dtype)}
    try:
        yield
    finally:
        relu.compute = plain


TRAIN_CHECK_FAULTS = ("tf32", "klen")


def train_check_phase(batch=4, amp=False, floor_scale=3.0, feed=None,
                      name=None, fault=None):
    """One step of the dropout-0 program on the card and on the CPU from
    one startup state: losses within rtol 1e-4; the parameters' gradients
    within relative L2 1e-4 at the median and 1e-2 for every one; the
    parameters moved.  ``feed`` (``realdist``: a bucket's ragged rows at
    its pad bound) replaces the random batch of ``batch`` rows; the phase
    logs as ``name``.

    In float32 the CPU step takes the card's ReLU decisions
    (``relu_decisions``): where a ReLU input lies within float32 rounding
    of 0 (~1e-6 relative), the two devices may take opposite sides, and
    that unit's gradient for that token appears on one side only.  One
    such flip moves an FFN weight's gradient by ~1e-3 relative L2 and
    every parameter upstream of it a little; a whole realdist bucket
    (6-7k real tokens, 2048 units a layer) flips tens of them, which
    alone puts the median above 1e-4.  With the card's decisions the
    comparison sees rounding and faults only, at the fixed band.  The
    inputs that did take opposite sides are counted and reported
    (``relu_sign_flips``).

    ``fault`` plants a fault on the card's side, to show that the check
    fails on it: ``"tf32"`` lets cuBLAS round float32 products to TF32,
    ``"klen"`` feeds the card every ``src_word@LEN`` one shorter.  The
    phase then returns its summary (``within`` False when the check
    caught the fault) and does not raise.

    With ``amp`` (``train_amp_check``) the program is built under
    ``decorate`` and the CPU takes its own ReLU decisions; the losses
    agree within rtol 1e-2, the gradients within ``floor_scale`` times the
    floor of an ``AMP_NUDGE`` nudge (the CPU tests' fixed band, 2e-2 at
    the median, is reported beside it), and every float32 persistable is
    still float32 after the step."""
    import paddle_tpu_torch as pt

    assert fault in (None,) + TRAIN_CHECK_FAULTS and not (fault and amp)
    main, startup, cost = build_train(0.0, amp)
    params = [p.name for p in main.all_parameters() if p.trainable]
    card_scope, cpu_scope = pt.Scope(), pt.Scope()
    card = pt.Executor(pt.CUDAPlace(0))
    card.run(startup, scope=card_scope)
    for n in card_scope.local_var_names():
        cpu_scope.set_var(n, card_scope.var(n).cpu().clone())
    before = {n: cpu_scope.var(n).clone() for n in params}
    if feed is None:
        feed = train_feed(np.random.RandomState(11), batch)
    card_feed = dict(feed)
    if fault == "klen":
        card_feed["src_word@LEN"] = np.maximum(feed["src_word@LEN"] - 1,
                                               1).astype("int32")
    fetch = [cost.name] + [n + "@GRAD" for n in params] + relu_inputs(main)
    k = 1 + len(params)
    if amp:
        # the floor: the same step on the card with every weight nudged
        g = torch.Generator().manual_seed(0)
        nudged_scope = pt.Scope()
        for n in cpu_scope.local_var_names():
            v = cpu_scope.var(n).clone()
            if n in params:
                v.mul_(1 + AMP_NUDGE * torch.randn(v.shape, generator=g))
            nudged_scope.set_var(n, v.cuda())
        nudged = card.run(main, feed=feed, fetch_list=fetch[:k],
                          scope=nudged_scope)
    torch.backends.cuda.matmul.allow_tf32 = fault == "tf32"
    try:
        t0 = time.perf_counter()
        got = card.run(main, feed=card_feed, fetch_list=fetch,
                       scope=card_scope)
        card_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    cpu = pt.Executor(pt.CPUPlace())
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if amp
          else relu_decisions(main, got[k:])):
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    assert all(np.isfinite(a).all() for a in got), "non-finite on the card"
    flips, flip_top = relu_sign_flips(main, feed, got[k:], want[k:])
    got, want = got[:k], want[:k]
    loss_rtol = 1e-2 if amp else 1e-4
    loss_within = bool(np.all(np.abs(got[0] - want[0])
                              <= loss_rtol * np.abs(want[0])))
    rel = _grad_rel_l2(params, got[1:], want[1:])
    ranked = sorted(rel, key=rel.get, reverse=True)
    med = statistics.median(rel.values())
    moved = sum(not torch.equal(before[n], card_scope.var(n).cpu())
                for n in params)
    rows, seq = feed["src_word"].shape[:2]
    summary = {"batch": rows, "seq": seq, "tokens": rows * seq, "amp": amp,
               "fault": fault,
               "real_tokens": int(feed["src_word@LEN"].sum()),
               "loss_card": float(got[0][0]), "loss_cpu": float(want[0][0]),
               "params": len(params), "moved": moved,
               "grad_rel_l2_top5": [[n, rel[n]] for n in ranked[:5]],
               "grad_rel_l2_median": med,
               "relu_sign_flips": flips, "relu_flip_max_abs": flip_top,
               "cpu_takes_card_relu": not amp,
               "not_float32": float32_state_faults(main, card_scope),
               "card_step_s": card_s, "cpu_step_s": cpu_s}
    if amp:
        floor = _grad_rel_l2(params, nudged[1:], got[1:])
        floor_med = statistics.median(floor.values())
        floor_max = max(floor.values())
        summary.update(nudge=AMP_NUDGE, floor_scale=floor_scale,
                       floor_rel_l2_median=floor_med,
                       floor_rel_l2_max=floor_max,
                       floor_worst=max(floor, key=floor.get),
                       fixed_band_median_2e_2_met=med <= 2e-2)
        within = med <= floor_scale * floor_med \
            and rel[ranked[0]] <= floor_scale * floor_max
    else:
        within = rel[ranked[0]] <= 1e-2 and med <= 1e-4
    summary["within"] = within = bool(within and loss_within)
    log(name or ("train_amp_check" if amp else "train_check"), summary)
    if fault:
        return summary
    if not within or moved != len(params) or summary["not_float32"]:
        raise SystemExit("card and CPU disagree on the training step: %s"
                         % summary)
    return summary


def copy_scope(scope):
    """A scope holding clones of ``scope``'s tensors."""
    import paddle_tpu_torch as pt

    out = pt.Scope()
    for n in scope.local_var_names():
        out.set_var(n, scope.var(n).clone())
    return out


def state_rel_l2(a, b):
    """{name: relative L2 distance} of the tensors of two scopes that are
    not the same bits (empty when every one is)."""
    out = {}
    for n in a.local_var_names():
        x, y = a.var(n), b.var(n)
        if not torch.equal(x, y):
            x, y = x.double(), y.double()
            out[n] = float((x - y).norm() / y.norm().clamp_min(1e-30))
    return out


def _step(run, program, feed, fetch):
    """One timed ``Executor.run`` of ``run`` (its executor and scope) that
    fetches the loss (the fetch waits for the step's device work); keeps
    the loss's float32 value and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (loss,) = run["exe"].run(program, feed=feed, fetch_list=[fetch],
                             scope=run["scope"])
    dt = time.perf_counter() - t0
    run["losses"].append(float(loss[0]))
    run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated())
    return dt


def train_phase(place, steps=TRAIN_STEPS, batch=TRAIN_BATCH, amp=False):
    """The dropout-0.1 program from one startup state in two executors:
    eager (``capture=False``) and captured (the default: the first step
    eager, the second captured and replayed, the rest replayed).  Two
    untimed steps each (the captured executor's second is its capture,
    timed apart), then ``steps`` timed steps taken in turns, each with the
    launch counters zeroed just before and read just after, then one
    profiled step each (device busy time, idle share).  The two must give
    the same loss bits at every step and the same bits in every scope
    tensor (parameters, moments, counters) after them; then a parameter
    is swapped in both scopes (a tensor in the eager one, a numpy array in
    the captured one) between two runs, and the next step must again give
    the same bits, with the captured scope pointed back at the captured
    tensor.  With ``amp`` (``train_amp``, paths ``train_amp`` and
    ``train_amp:eager``) the program is built under ``decorate``: #1 and #2
    run in bfloat16, and every float32 persistable (parameters, Adam
    moments, the step counter) must still be float32 in both scopes at
    the end.  Returns (summary, {path: launch record})."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    main, startup, cost = build_train(0.1, amp)
    start = pt.Scope()
    pt.Executor(place).run(startup, scope=start)
    rng = np.random.RandomState(0)
    feeds = [train_feed(rng, batch) for _ in range(steps + 4)]
    # the captured arm first: a capture empties the allocator's cache, which
    # the eager arm then refills before it is timed
    runs = {arm: {"exe": pt.Executor(place, capture=arm == "captured"),
                  "scope": copy_scope(start), "losses": [], "times": [],
                  "launches": {}, "peak": 0}
            for arm in ("captured", "eager")}
    del start
    first = {arm: [_step(r, main, f, cost) for f in feeds[:2]]
             for arm, r in runs.items()}
    for i, f in enumerate(feeds[2:2 + steps]):
        for arm in (("eager", "captured") if i % 2 == 0
                    else ("captured", "eager")):
            r = runs[arm]
            cuda.reset_launch_counts()
            r["times"].append(_step(r, main, f, cost))
            for k, n in cuda.launch_counts().items():
                r["launches"][k] = r["launches"].get(k, 0) + n
    windows = {arm: device_window(lambda r=r: _step(r, main,
                                                    feeds[2 + steps], cost))
               for arm, r in runs.items()}
    same_losses = runs["eager"]["losses"] == runs["captured"]["losses"]
    diff = state_rel_l2(runs["captured"]["scope"], runs["eager"]["scope"])
    # a state swap between two captured runs: the next replay must see it
    name = main.all_parameters()[0].name
    captured_tensor = runs["captured"]["scope"].find_var(name)
    swapped = runs["eager"]["scope"].find_var(name) * 0.5
    runs["eager"]["scope"].set_var(name, swapped.clone())
    runs["captured"]["scope"].set_var(name, swapped.cpu().numpy())
    for r in runs.values():
        _step(r, main, feeds[-1], cost)
    swap_same = runs["eager"]["losses"] == runs["captured"]["losses"] \
        and not state_rel_l2(runs["captured"]["scope"],
                             runs["eager"]["scope"])
    swap_seen = runs["captured"]["scope"].find_var(name) is captured_tensor
    per_step = kernel_launches_per_step(main)
    not_f32 = {arm: float32_state_faults(main, r["scope"])
               for arm, r in runs.items()}
    summary = {"batch": batch, "seq": TRAIN_SEQ, "steps": steps, "amp": amp,
               "ops": len(main.global_block().ops),
               "not_float32": not_f32,
               "same_loss_bits": same_losses,
               "state_not_bit_equal": diff, "swap_param": name,
               "swap_same_bits": swap_same, "swap_seen_by_replay": swap_seen,
               "launches_per_step": per_step,
               "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    for arm, r in runs.items():
        step_s = statistics.median(r["times"])
        summary[arm] = {
            "first_steps_ms": [t * 1e3 for t in first[arm]],
            "losses": r["losses"], "step_ms": [t * 1e3 for t in r["times"]],
            "median_step_ms": step_s * 1e3,
            "tokens_per_s": batch * TRAIN_SEQ / step_s,
            "target_tokens_per_s": float(np.median(
                [f["tgt_word@LEN"].sum() for f in feeds[2:2 + steps]]))
            / step_s,
            "profiled_step": windows[arm], "peak_mem_gb": r["peak"] / 1e9,
            "launches": r["launches"]}
        assert all(np.isfinite(r["losses"])), r["losses"]
    name = "train_amp" if amp else "train"
    log(name, summary)
    if not (same_losses and not diff and swap_same and swap_seen) \
            or any(not_f32.values()):
        raise SystemExit("the captured training step differs from the "
                         "eager one, or a master left float32: %s" % {
                             k: summary[k] for k in (
                                 "same_loss_bits", "state_not_bit_equal",
                                 "swap_same_bits", "swap_seen_by_replay",
                                 "not_float32")})
    return summary, {
        (name if arm == "captured" else name + ":eager"): launch_record(
            arm == "captured", r["launches"],
            {k: n * steps for k, n in per_step.items()}, windows[arm],
            per_step)
        for arm, r in runs.items()}


# ---------------------------------------------------------------------------
# phases 9 and 10: the ResNet-50 training slice
# ---------------------------------------------------------------------------

RESNET_MODES = ("plain", "fuse", "nhwc_fuse")
RESNET_BATCH, RESNET_STEPS, RESNET_FUSED = 128, 5, 30


def build_resnet(mode, amp=False, uint8=False):
    """(main, startup, loss) of bench.py's ResNet-50 train program
    (``resnet_imagenet`` depth 50 on 3x224x224 float32, class_dim 1000,
    mean cross-entropy, Momentum(1e-3, 0.9)), built with the port's
    layers; ``mode`` adds ``fuse_conv_bn`` (fuse) or ``convert_to_nhwc``
    then ``fuse_conv_bn`` (nhwc_fuse) before ``minimize``, as bench.py
    does, and ``amp`` wraps the optimizer in ``decorate`` (bench.py's
    default rungs).  With ``uint8`` the image feed is bench.py's
    reader-included one (``bench.py:1476-1481``): uint8 pixels, cast to
    float32 and scaled by 1/255 on the device.  Fixed seeds and fresh
    names: every mode has the same parameters and the same startup
    state."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    main, startup = pt.Program(), pt.Program()
    main.random_seed, startup.random_seed = 2, 1
    with pt.program_guard(main, startup), pt.unique_name.guard():
        if uint8:
            raw = pt.layers.data("img", shape=[3, 224, 224], dtype="uint8")
            img = pt.layers.scale(pt.layers.cast(raw, "float32"),
                                  scale=1.0 / 255.0)
        else:
            img = pt.layers.data("img", shape=[3, 224, 224])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        pred = resnet_imagenet(img, class_dim=1000, depth=50)
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        if mode == "nhwc_fuse":
            assert pt.transpiler.convert_to_nhwc(main) == 53
        if mode != "plain":
            assert pt.transpiler.fuse_conv_bn(main) == 53
        opt = pt.optimizer.Momentum(learning_rate=1e-3, momentum=0.9)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def resnet_feed(rng, batch):
    return {"img": rng.rand(batch, 3, 224, 224).astype("float32"),
            "label": rng.randint(0, 1000, (batch, 1)).astype("int64")}


def _grad_rel_l2(names, got, want):
    rel = {}
    for n, a, b in zip(names, got, want):
        den = float(np.linalg.norm(b))
        rel[n] = float(np.linalg.norm(a - b)) / den if den else \
            float(np.linalg.norm(a))
    return rel


def resnet_check_phase(batch=4, floor_scale=3.0, amp=False):
    """The fused programs (NCHW and NHWC) at full width, batch 4, from one
    startup state: one step on the card (kernels #8-#11) against one on the
    CPU (their plain versions), and against the plain program on the card.
    Losses within rtol 1e-4.

    Gradients are held against a floor measured in the same call, not a
    fixed band: the plain program on the card from the startup state with
    every parameter scaled by (1 + 1e-7 N(0, 1)), against the plain
    program from the state itself.  At batch 4 ResNet-50's backward
    through 53 batch norms amplifies rounding with depth: on the CPU (port,
    plain versions) that perturbation moved the gradients by 2.3e-2
    relative L2 at the median and 2.7e-2 at most (the first conv's most,
    the fc's 2.4e-5), so no run that sums in another order can match to
    1e-4.  Each comparison must stay within ``floor_scale`` times the
    floor's median (at the median) and its maximum (for every parameter).
    On the CPU the fused program sat at 7.2e-3 / 1.0e-2 from the plain
    one, and a fused backward folding with the running mean after its
    update (the JAX package's shift fault) at 2.9e-2 / 4.15: the maximum
    is what catches a wrong backward.

    With ``amp`` (``resnet_amp_check``) every program is built under
    ``decorate`` and held by the same method; the losses agree within
    rtol 1e-2, and every float32 persistable must still be float32 after
    the card's step.  Under AMP the floor is of the order of the gradients
    themselves: on the CPU the nudge moved the batch-4 step's gradients by
    0.96 relative L2 at the median (1.16 at most), and the last stage's
    forward activations by 0.33 already (bf16 rounds each layer's output
    at 2^-8 and the net amplifies it block by block); at batch 64 still
    0.97.  So there the gradients catch only a gross fault; the fused
    kernels are held to their plain versions in bfloat16 in the kernels
    phase."""
    import paddle_tpu_torch as pt

    card = pt.Executor(pt.CUDAPlace(0))
    cpu = pt.Executor(pt.CPUPlace())
    feed = resnet_feed(np.random.RandomState(11), batch)
    plain, startup, plain_loss = build_resnet("plain", amp)
    start = pt.Scope()
    card.run(startup, scope=start)
    params = [p.name for p in plain.all_parameters() if p.trainable]
    fetch = [n + "@GRAD" for n in params]

    def scope_copy(device, perturb=0.0):
        sc = pt.Scope()
        g = torch.Generator().manual_seed(0)
        for n in start.local_var_names():
            v = start.var(n).to(device, copy=True)
            if perturb and n in params:
                v.mul_(1 + perturb * torch.randn(v.shape, generator=g)
                       .to(device))
            sc.set_var(n, v)
        return sc

    plain_out = card.run(plain, feed=feed, fetch_list=[plain_loss] + fetch,
                         scope=scope_copy("cuda"))
    nudged = card.run(plain, feed=feed, fetch_list=[plain_loss] + fetch,
                      scope=scope_copy("cuda", perturb=1e-7))
    floor = _grad_rel_l2(params, nudged[1:], plain_out[1:])
    floor_med, floor_max = statistics.median(floor.values()), \
        max(floor.values())
    summary = {"batch": batch, "params": len(params), "amp": amp,
               "floor_rel_l2_median": floor_med, "floor_rel_l2_max": floor_max,
               "floor_scale": floor_scale,
               "loss_plain_card": float(plain_out[0][0])}
    bad = []
    for mode in ("fuse", "nhwc_fuse"):
        main, _, loss = build_resnet(mode, amp)
        card_scope = scope_copy("cuda")
        before = {n: card_scope.var(n).clone() for n in params}
        t0 = time.perf_counter()
        got = card.run(main, feed=feed, fetch_list=[loss] + fetch,
                       scope=card_scope)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = cpu.run(main, feed=feed, fetch_list=[loss] + fetch,
                       scope=scope_copy("cpu"))
        cpu_s = time.perf_counter() - t0
        assert all(np.isfinite(a).all() for a in got), "non-finite on card"
        rel = _grad_rel_l2(params, got[1:], want[1:])
        vs_plain = _grad_rel_l2(params, got[1:], plain_out[1:])
        moved = sum(not torch.equal(before[n], card_scope.var(n))
                    for n in params)
        s = {"loss_card": float(got[0][0]), "loss_cpu": float(want[0][0]),
             "moved": moved,
             "not_float32": float32_state_faults(main, card_scope),
             "vs_cpu_rel_l2_median": statistics.median(rel.values()),
             "vs_cpu_rel_l2_max": max(rel.values()),
             "vs_cpu_worst": max(rel, key=rel.get),
             "vs_plain_rel_l2_median": statistics.median(vs_plain.values()),
             "vs_plain_rel_l2_max": max(vs_plain.values()),
             "vs_plain_worst": max(vs_plain, key=vs_plain.get),
             "card_step_s": card_s, "cpu_step_s": cpu_s}
        summary[mode] = s
        within = all(
            s[k + "_median"] <= floor_scale * floor_med
            and s[k + "_max"] <= floor_scale * floor_max
            for k in ("vs_cpu_rel_l2", "vs_plain_rel_l2"))
        loss_rtol = 1e-2 if amp else 1e-4
        if abs(s["loss_card"] - s["loss_cpu"]) \
                > loss_rtol * abs(s["loss_cpu"]) \
                or not within or moved != len(params) or s["not_float32"]:
            bad.append(mode)
    log("resnet_amp_check" if amp else "resnet_check", summary)
    if bad:
        raise SystemExit("ResNet step disagrees (card vs CPU, or fused vs "
                         "plain): %s" % bad)
    return summary


def resnet_train_phase(steps=RESNET_STEPS, batch=RESNET_BATCH,
                       deterministic=True, amp=False):
    """bench.py's ResNet-50 at batch 128 (images ``rand`` in [0, 1) from
    ``RandomState(0)``, labels in [0, 1000)) on ``CUDAPlace(0)``: the three
    programs of ``RESNET_MODES``, each from one startup state in two arms,
    eager and captured, on two executors (the captured one holds the three
    programs' graphs in one memory pool), each program in a scope of its
    own per arm, all on the same batches.  Two untimed steps each (the
    captured arm's second is its capture), then ``steps`` timed steps
    taken in turns (plain, fused, NHWC, then the reverse; eager and
    captured flipping each step), each bracketed by zeroing the launch
    counters and reading them, then one profiled step each for the
    device's busy time, idle share and launches.

    With ``deterministic`` the phase runs with cuDNN's deterministic
    algorithms and PyTorch's deterministic mode
    (``use_deterministic_algorithms``, warning where an op has none; the
    warnings seen are logged), so two runs of one program sum in one
    order: the captured arm's losses at every step and every scope tensor
    after them (parameters, running statistics, velocities) must be the
    eager arm's bits.  Without it, cuDNN picks its default algorithms,
    whose backward sums with atomics in no fixed order, and the bits are
    only reported (``--resnet-default``: what determinism costs).

    With ``amp`` (``resnet_amp``) the three programs are built under
    ``decorate``: the trunk is bfloat16 after the first convolution, so the
    fused layers launch the bfloat16 #8-#11, and every float32 persistable
    (parameters, velocities, running statistics) must still be float32 in
    every scope at the end.
    Returns {mode: (summary, {arm: launch record})}."""
    import warnings

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    rng = np.random.RandomState(0)
    feeds = [resnet_feed(rng, batch) for _ in range(steps + 3)]
    # the captured arm first in the untimed steps: a capture empties the
    # allocator's cache, which the eager arm then refills
    arms = ("captured", "eager")
    exes = {arm: pt.Executor(pt.CUDAPlace(0), capture=arm == "captured")
            for arm in arms}
    runs = {}
    for mode in RESNET_MODES:
        main, startup, loss = build_resnet(mode, amp)
        fused = count_ops(main, "bn_act_conv2d")
        assert fused == count_ops(main, "bn_act_conv2d_grad") \
            == (RESNET_FUSED if mode != "plain" else 0), fused
        start = pt.Scope()
        # a fresh executor: every mode starts from the same weights
        pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
        for arm in arms:
            runs[mode, arm] = dict(main=main, loss=loss, exe=exes[arm],
                                   scope=copy_scope(start), fused=fused,
                                   times=[], losses=[], peak=0, launches={})
    torch.backends.cudnn.deterministic = deterministic
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            first = {key: [_step(r, r["main"], f, r["loss"])
                           for f in feeds[:2]]
                     for key, r in runs.items()}
            for i in range(steps):
                f = feeds[2 + i]
                for mode in (RESNET_MODES if i % 2 == 0
                             else RESNET_MODES[::-1]):
                    for arm in (arms[::-1] if i % 2 == 0 else arms):
                        r = runs[mode, arm]
                        cuda.reset_launch_counts()
                        r["times"].append(_step(r, r["main"], f, r["loss"]))
                        for k, n in cuda.launch_counts().items():
                            r["launches"][k] = r["launches"].get(k, 0) + n
            windows = {key: device_window(
                lambda r=r: _step(r, r["main"], feeds[-1], r["loss"]))
                for key, r in runs.items()}
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    nondeterministic = sorted({str(w.message)[:200] for w in seen
                               if "deterministic" in str(w.message)})
    nchw = "conv_bn_fwd", "conv_bn_bwd"
    nhwc = "conv_bn_fwd_nhwc", "conv_bn_bwd_nhwc"
    out, bad = {}, []
    for mode in RESNET_MODES:
        c, e = runs[mode, "captured"], runs[mode, "eager"]
        same_losses = c["losses"] == e["losses"]
        diff = state_rel_l2(c["scope"], e["scope"])
        on = nhwc if mode == "nhwc_fuse" else nchw if mode == "fuse" else ()
        per_step = {k: e["fused"] for k in on}
        not_f32 = {arm: float32_state_faults(r["main"], r["scope"])
                   for arm, r in (("eager", e), ("captured", c))}
        summary = {"mode": mode, "batch": batch, "steps": steps,
                   "deterministic": deterministic, "amp": amp,
                   "not_float32": not_f32,
                   "ops": len(e["main"].global_block().ops),
                   "fused_layers": e["fused"],
                   "launches_per_step": per_step,
                   "same_loss_bits": same_losses,
                   "state_not_bit_equal": diff,
                   "nondeterministic_ops_warned": nondeterministic,
                   "reserved_gb": torch.cuda.memory_reserved() / 1e9}
        records = {}
        for arm, r in (("eager", e), ("captured", c)):
            step_s = statistics.median(r["times"])
            summary[arm] = {
                "first_steps_ms": [t * 1e3 for t in first[mode, arm]],
                "losses": r["losses"],
                "step_ms": [t * 1e3 for t in r["times"]],
                "median_step_ms": step_s * 1e3,
                "images_per_s": batch / step_s,
                "peak_mem_gb": r["peak"] / 1e9,
                "profiled_step": windows[mode, arm],
                "launches": r["launches"]}
            assert all(np.isfinite(r["losses"])), r["losses"]
            records[arm] = launch_record(
                arm == "captured", r["launches"],
                {k: n * steps for k, n in per_step.items()},
                windows[mode, arm], per_step)
        if deterministic and (not same_losses or diff) \
                or any(not_f32.values()):
            bad.append(mode)
        out[mode] = summary, records
    if bad:
        for mode in bad:
            log("resnet_amp" if amp else "resnet_train", out[mode][0])
        raise SystemExit("captured ResNet-50 steps differ from the eager "
                         "ones, or a master left float32: %s" % bad)
    return out


# ---------------------------------------------------------------------------
# C1/C2: the AMP check, card against CPU, at the CPU tests' configurations
# ---------------------------------------------------------------------------

# the fixed band of the AMP checks (PERF.md §2, ``tests/test_torch_amp.py``):
# loss rtol 1e-2, parameter gradients within relative L2 2e-2 at the median
AMP_LOSS_RTOL, AMP_GRAD_BAND = 1e-2, 2e-2


def build_small_transformer():
    """``tests/test_torch_amp.py``'s 2+2-layer Transformer (d_model 64,
    d_inner 128, vocab 20, max_len 8, dropout 0, noam(64, 10) + Adam under
    ``decorate``) with one head of 64: the card's attention kernels take
    a head dim of 64 only (the test's two heads are 32 wide)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.program_guard(main, startup), pt.unique_name.guard("t_"):
        words = [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = transformer.transformer(
            *words, 8, 8, 20, 20, n_layer=2, n_head=1, d_model=64,
            d_inner=128, dropout_rate=0.0)
        opt = pt.optimizer.Adam(learning_rate=pt.layers.noam_decay(64, 10),
                                beta1=0.9, beta2=0.997, epsilon=1e-9)
        mixed_precision.decorate(opt).minimize(cost)
    rng = np.random.RandomState(0)
    lens = rng.randint(3, 9, 4).astype("int32")
    feed = {n: rng.randint(0, 20, (4, 8, 1)).astype("int64")
            for n in ("src_word", "tgt_word", "lbl_word")}
    feed.update({n + "@LEN": lens for n in ("src_word", "tgt_word",
                                            "lbl_word")})
    return main, startup, cost, feed


def build_stem_net(mode):
    """``tests/test_torch_amp.py``'s bf16-stem net (3x16x16 images, a 3x3
    conv into BN + ReLU, 1x1 -> 128, 1x1 -> 64, 3x3, a residual add,
    global pool, fc to 5 classes; BN momentum 1.0) under ``decorate``
    (Momentum(0.05, 0.9)), plain, fused or NHWC + fused: the fused layers
    take bfloat16 (#8-#11 in bf16).  Batch 8."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import mixed_precision

    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard("t_"):
        img = L.data("img", shape=[3, 16, 16])
        label = L.data("label", shape=[1], dtype="int64")
        c0 = L.conv2d(img, num_filters=64, filter_size=3, padding=1,
                      bias_attr=False)
        b0 = L.batch_norm(c0, act="relu", momentum=1.0)
        c1 = L.conv2d(b0, num_filters=128, filter_size=1, bias_attr=False)
        b1 = L.batch_norm(c1, act="relu", momentum=1.0)
        c2 = L.conv2d(b1, num_filters=64, filter_size=1, bias_attr=False)
        b2 = L.batch_norm(c2, act="relu", momentum=1.0)
        c3 = L.conv2d(b2, num_filters=64, filter_size=3, padding=1,
                      bias_attr=False)
        b3 = L.batch_norm(c3, act=None, momentum=1.0)
        res = L.elementwise_add(x=b3, y=b0, act="relu")
        pool = L.pool2d(res, pool_size=16, pool_type="avg",
                        global_pooling=True)
        pred = L.fc(pool, size=5, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        if "nhwc" in mode:
            assert pt.transpiler.convert_to_nhwc(main) > 0
        if "fuse" in mode:
            assert pt.transpiler.fuse_conv_bn(main) > 0
        mixed_precision.decorate(pt.optimizer.Momentum(
            learning_rate=0.05, momentum=0.9)).minimize(loss)
    rng = np.random.RandomState(3)
    feed = {"img": rng.rand(8, 3, 16, 16).astype("float32"),
            "label": rng.randint(0, 5, (8, 1)).astype("int64")}
    return main, startup, loss, feed


def amp_small_check(build, floor_scale=3.0):
    """One AMP step of a small program on the card and on the CPU from one
    startup state (the CPU tests' configuration): the fixed band (loss
    rtol 1e-2, gradients relative L2 2e-2 at the median) and, beside it,
    the floor a 1e-7 nudge of every weight gives on the card in the same
    call (median and maximum).  Returns the summary; ``band_met`` says
    whether the fixed band held."""
    import paddle_tpu_torch as pt

    main, startup, loss, feed = build()
    params = [p.name for p in main.all_parameters() if p.trainable]
    card = pt.Executor(pt.CUDAPlace(0))
    card_scope, cpu_scope, nudged_scope = pt.Scope(), pt.Scope(), pt.Scope()
    card.run(startup, scope=card_scope)
    g = torch.Generator().manual_seed(0)
    for n in card_scope.local_var_names():
        v = card_scope.var(n).cpu().clone()
        cpu_scope.set_var(n, v)
        if n in params:
            v = v * (1 + AMP_NUDGE * torch.randn(v.shape, generator=g))
        nudged_scope.set_var(n, v.cuda())
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    nudged = card.run(main, feed=feed, fetch_list=fetch, scope=nudged_scope)
    got = card.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                          scope=cpu_scope)
    assert all(np.isfinite(a).all() for a in got), "non-finite on the card"
    rel = _grad_rel_l2(params, got[1:], want[1:])
    floor = _grad_rel_l2(params, nudged[1:], got[1:])
    med, floor_med = statistics.median(rel.values()), \
        statistics.median(floor.values())
    loss_rel = abs(float(got[0][0]) - float(want[0][0])) \
        / abs(float(want[0][0]))
    ranked = sorted(rel, key=rel.get, reverse=True)
    return {"params": len(params), "loss_card": float(got[0][0]),
            "loss_cpu": float(want[0][0]), "loss_rel": loss_rel,
            "grad_rel_l2_median": med, "grad_rel_l2_max": rel[ranked[0]],
            "grad_rel_l2_top3": [[n, rel[n]] for n in ranked[:3]],
            "floor_rel_l2_median": floor_med,
            "floor_rel_l2_max": max(floor.values()),
            "band": {"loss_rtol": AMP_LOSS_RTOL,
                     "grad_median": AMP_GRAD_BAND},
            "band_met": loss_rel <= AMP_LOSS_RTOL and med <= AMP_GRAD_BAND,
            "within_3x_floor": med <= floor_scale * floor_med
            and rel[ranked[0]] <= floor_scale * max(floor.values()),
            "not_float32": float32_state_faults(main, card_scope)}


def amp_small_checks():
    """``resnet_amp_small_check`` (the stem net, plain / fused / NHWC +
    fused) must meet the fixed band.  ``train_amp_small_check`` (the
    2+2-layer Transformer) is held, as ``train_amp_check`` is, within 3x
    its same-call floor, and reports the fixed band beside it: on an
    NVIDIA H100 80GB HBM3 at 700 W the floor itself (a 1e-7 nudge, card
    against card) read 3.19e-2 at the median, above the band's 2e-2, so
    no two implementations that round in another order can meet the band
    there (ROADMAP Queue C1)."""
    t = amp_small_check(build_small_transformer)
    log("train_amp_small_check", t)
    r = {mode: amp_small_check(lambda m=mode: build_stem_net(m))
         for mode in RESNET_MODES}
    log("resnet_amp_small_check", r)
    bad = [mode for mode, s in r.items()
           if not s["band_met"] or s["not_float32"]]
    if not t["within_3x_floor"] or t["not_float32"]:
        bad.append("transformer")
    if bad:
        raise SystemExit("the AMP step, card against CPU, at the small "
                         "configurations: %s" % bad)


# ---------------------------------------------------------------------------
# the input pipeline and the high-level trainer
# ---------------------------------------------------------------------------

MLP_BATCH = 256


def synthetic_mnist(rng, n):
    """``tests/test_mnist_mlp.py``'s learnable rule: the class is the
    argmax of 10 fixed projections of 784 uniform pixels."""
    x = rng.rand(n, 784).astype("float32")
    proj = np.linspace(-1, 1, 7840).reshape(784, 10).astype("float32")
    return x, (x @ proj).argmax(axis=1).astype("int64").reshape(-1, 1)


def mlp_train_func():
    """bench.py's MLP (``bench.py:1408-1450``): 784-256-256-10, softmax,
    mean cross-entropy; returns [loss, accuracy]."""
    import paddle_tpu_torch as pt

    img = pt.layers.data("img", shape=[784])
    label = pt.layers.data("label", shape=[1], dtype="int64")
    h = pt.layers.fc(img, size=256, act="relu")
    h = pt.layers.fc(h, size=256, act="relu")
    pred = pt.layers.fc(h, size=10, act="softmax")
    return [pt.layers.mean(pt.layers.cross_entropy(pred, label)),
            pt.layers.accuracy(pred, label)]


def mlp_trainer_phase(steps=20, windows=3, window_steps=50,
                      trainer_epochs=6, trainer_batches=60):
    """The MNIST MLP (Adam 1e-3, batch 256) on ``CUDAPlace(0)``:

    * captured and eager from one startup state over ``steps`` steps on
      the same batches: the losses and accuracies and every scope tensor
      after them are the same bits;
    * bench.py's compute rung: ``Executor.run`` on one batch staged on the
      card, ``windows`` windows of ``window_steps`` replays, one loss read
      a window (images/s of the best and the median window), a profiled
      window for the idle share, and the executor's graph count (1);
    * the user path: ``Trainer.train`` over a ``reader.batch`` reader of
      256 sample rows a batch, the ``DataFeeder`` converting every batch
      and the loss and accuracy fetched every step (images/s of each
      epoch after the first: median, least and most), whose loss must
      fall as in
      ``test_mnist_mlp_trains`` (last < 0.8 x first, the last ten
      accuracies >= the first ten)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import Trainer

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, acc = mlp_train_func()
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    start = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
    rng = np.random.RandomState(42)
    feeds = [dict(zip(("img", "label"), synthetic_mnist(rng, MLP_BATCH)))
             for _ in range(steps)]
    runs = {arm: (pt.Executor(pt.CUDAPlace(0), capture=arm == "captured"),
                  copy_scope(start), []) for arm in ("captured", "eager")}
    for f in feeds:
        for arm, (exe, scope, out) in runs.items():
            out.append([a.tobytes() for a in exe.run(
                main, feed=f, fetch_list=[loss, acc], scope=scope)])
    same_bits = runs["captured"][2] == runs["eager"][2]
    diff = state_rel_l2(runs["captured"][1], runs["eager"][1])

    # the compute rung: one batch staged on the card, replays
    exe, scope, _ = runs["captured"]
    staged = {k: torch.from_numpy(v).cuda() for k, v in feeds[0].items()}

    def window(n):
        # the fetches of the steps above: the same entry, its one graph
        for _ in range(n):
            last = exe.run(main, feed=staged, fetch_list=[loss, acc],
                           scope=scope, return_numpy=False)
        float(last[0][0])

    window(3)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        window(window_steps)
        times.append(time.perf_counter() - t0)
    prof = device_window(lambda: window(window_steps))
    graphs = sum(st.graph is not None for st in exe._steps.values())

    # the user path: rows of (784 pixels, [label]), batched by the reader
    x, y = synthetic_mnist(np.random.RandomState(7),
                           MLP_BATCH * trainer_batches)
    rows = [(x[i], [int(y[i, 0])]) for i in range(len(x))]

    def reader():
        return iter(rows)

    losses, accs, epoch_s = [], [], []

    def handler(e):
        name = type(e).__name__
        if name == "BeginEpochEvent":
            epoch_s.append(time.perf_counter())
        elif name == "EndEpochEvent":
            epoch_s[-1] = time.perf_counter() - epoch_s[-1]
        elif name == "EndStepEvent":
            losses.append(float(e.metrics[0][0]))
            accs.append(float(e.metrics[1][0]))

    trainer = Trainer(mlp_train_func, lambda: pt.optimizer.Adam(1e-3),
                      place=pt.CUDAPlace(0))
    trainer.train(trainer_epochs, handler,
                  reader=pt.batch(reader, MLP_BATCH),
                  feed_order=["img", "label"])
    falls = bool(losses[-1] < 0.8 * losses[0]
                 and np.mean(accs[-10:]) >= np.mean(accs[:10]))
    summary = {
        "batch": MLP_BATCH, "same_bits_captured_eager": same_bits,
        "state_not_bit_equal": diff, "steps_compared": steps,
        "staged": {"window_steps": window_steps,
                   "window_s": times,
                   "images_per_s_best": MLP_BATCH * window_steps
                   / min(times),
                   "images_per_s_median": MLP_BATCH * window_steps
                   / statistics.median(times),
                   "step_ms": statistics.median(times) / window_steps * 1e3,
                   "profiled_window": {k: prof[k] for k in (
                       "wall_ms", "busy_ms", "idle_share",
                       "device_events")},
                   "graphs": graphs},
        "trainer": {"epochs": trainer_epochs, "steps": len(losses),
                    "epoch_s": epoch_s,
                    "images_per_s_median": MLP_BATCH * trainer_batches
                    / statistics.median(epoch_s[1:]),
                    "images_per_s_range": [
                        MLP_BATCH * trainer_batches / max(epoch_s[1:]),
                        MLP_BATCH * trainer_batches / min(epoch_s[1:])],
                    "first_loss": losses[0], "last_loss": losses[-1],
                    "first_acc10": float(np.mean(accs[:10])),
                    "last_acc10": float(np.mean(accs[-10:])),
                    "loss_falls": falls}}
    log("mlp_trainer", summary)
    if not (same_bits and not diff and falls and graphs == 1):
        raise SystemExit("mlp_trainer: captured differs from eager, the "
                         "loss did not fall, or the graphs are not 1: %s"
                         % {k: summary[k] for k in (
                             "same_bits_captured_eager",
                             "state_not_bit_equal")})
    return summary


def realdist_pools(amp=True):
    """bench.py's ``transformer_realdist`` (``bench.py:1932-2079``): the
    Transformer-base program (dropout 0.1, under ``decorate`` with
    ``amp``), its ``DataFeeder``, and the two feed pools drawn from one
    wmt16-like stream (``RandomState(0)``, lengths clip(lognormal(3.2,
    0.55), 4, 64), ids in [2, 32000)): 8 pad-to-max feeds of 128 rows,
    and 3 feeds of each bucket of ``bucket_by_length`` (bounds 16, 32,
    48, 64; sizes 512, 256, 170, 128; ``drop_last``) padded to its bound
    by ``DataFeeder.feed(samples, pad_to=bound)``, shuffled.  Each feed
    comes with its real tokens (the ``src_word@LEN`` sum)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.reader import decorator as dec

    main, startup, cost = build_train(0.1, amp)
    block = main.global_block()
    feeder = pt.DataFeeder(feed_list=[block.var(n) for n in (
        "src_word", "tgt_word", "lbl_word")], program=main)
    rng = np.random.RandomState(0)

    def sample_stream():
        while True:
            n = int(np.clip(rng.lognormal(3.2, 0.55), 4, TRAIN_SEQ))
            yield (rng.randint(2, TRAIN_VOCAB, (n, 1)).astype("int64"),)

    def make_feed(samples, pad_to):
        feed = feeder.feed([(s, s, s) for (s,) in samples], pad_to=pad_to)
        return feed, int(feed["src_word@LEN"].sum())

    stream = sample_stream()
    fixed = [make_feed([next(stream) for _ in range(128)], TRAIN_SEQ)
             for _ in range(8)]
    per_bound = {}
    for bound, samples in dec.bucket_by_length(
            lambda: sample_stream(), lambda s: len(s[0]),
            list(REALDIST_BOUNDS), list(REALDIST_SIZES), drop_last=True)():
        if len(per_bound.setdefault(bound, [])) < 3:
            per_bound[bound].append(make_feed(samples, bound))
        if len(per_bound) == len(REALDIST_BOUNDS) \
                and all(len(v) >= 3 for v in per_bound.values()):
            break
    bucketed = [f for b in REALDIST_BOUNDS for f in per_bound[b]]
    rng.shuffle(bucketed)
    return main, startup, cost, fixed, bucketed, per_bound


def realdist_phase(windows=3, window_steps=12):
    """bench.py's ``transformer_realdist`` rung on ``CUDAPlace(0)`` under
    AMP (``realdist_pools``): both pools' feeds staged on the card, one
    captured executor, each pool in a scope of its own from one startup
    state; every feed run once to warm (each signature: eager, then
    captured), then ``windows`` timed windows of ``window_steps`` steps,
    one loss read a window.  Real tokens/s (``src_word@LEN`` over wall)
    of the best and the median window for ``fixed_pad_max`` and
    ``bucketed``, and their ratio.  Gates:

    * the executor holds 5 captured graphs (1 pad-to-max + 4 buckets);
    * captured equals eager bit for bit: from one startup state, a
      captured and an eager executor run the four buckets three times
      over (each bucket eager, captured, replayed), the same loss bits at
      every step and every scope tensor after;
    * one replayed step of each bucket launches exactly what the program
      implies (#1 36, #2 18, #3 60, #4 30, #5 2, #6 1), from its device
      trace, and its wrappers none;
    * one float32 step of a whole batch of the smallest and the largest
      bucket (dropout 0) on the card against the CPU at ``train_check``'s
      bands, and the same check failing on each planted fault
      (``realdist_checks``).

    Returns (summary, {path: launch record})."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    main, startup, cost, fixed, bucketed, per_bound = realdist_pools()
    start = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)

    def staged(pool):
        return [({k: torch.from_numpy(v).cuda() for k, v in f.items()}, t)
                for f, t in pool]

    exe = pt.Executor(pt.CUDAPlace(0))
    arms = {}
    cuda.reset_launch_counts()
    for name, pool in (("fixed_pad_max", fixed), ("bucketed", bucketed)):
        scope, pool = copy_scope(start), staged(pool)
        t0 = time.perf_counter()
        for f, _ in pool:
            last = exe.run(main, feed=f, fetch_list=[cost], scope=scope,
                           return_numpy=False)
        float(last[0][0])
        warm_s = time.perf_counter() - t0
        cuda.reset_launch_counts()
        times, toks, losses = [], [], []
        for _ in range(windows):
            t0, tk = time.perf_counter(), 0
            for i in range(window_steps):
                f, t = pool[i % len(pool)]
                last = exe.run(main, feed=f, fetch_list=[cost], scope=scope,
                               return_numpy=False)
                losses.append(last[0])
                tk += t
            float(last[0][0])
            times.append(time.perf_counter() - t0)
            toks.append(tk)
        timed_launches = cuda.launch_counts()
        rates = [t / w for t, w in zip(toks, times)]
        arms[name] = {"scope": scope, "pool": pool, "summary": {
            "feeds": len(pool), "warm_s": warm_s,
            "real_tokens_per_s_best": max(rates),
            "real_tokens_per_s_median": statistics.median(rates),
            "window_s": times, "window_real_tokens": toks,
            "step_ms_median": statistics.median(times) / window_steps * 1e3,
            "slots_filled": sum(t for _, t in pool) / sum(
                f["src_word"].shape[0] * f["src_word"].shape[1]
                for f, _ in pool),
            "losses_finite": bool(torch.isfinite(
                torch.cat(losses)).all()),
            "timed_wrapper_launches": timed_launches}}
    graphs = sum(st.graph is not None for st in exe._steps.values())

    # one replayed step of each bucket under the profiler
    per_step = kernel_launches_per_step(main)
    records = {}
    bucket_pool = arms["bucketed"]["pool"]
    for bound in REALDIST_BOUNDS:
        f = next(f for f, _ in bucket_pool if f["src_word"].shape[1] == bound)
        win = device_window(lambda f=f: float(exe.run(
            main, feed=f, fetch_list=[cost], scope=arms["bucketed"]["scope"],
            return_numpy=False)[0][0]))
        records["realdist:b%d" % bound] = launch_record(
            True, arms["bucketed"]["summary"]["timed_wrapper_launches"], {},
            win, per_step)
    del exe, arms["fixed_pad_max"]["scope"], arms["bucketed"]["scope"]
    release_memory()

    # captured against eager over every bucket
    order = [f for _ in range(3) for b in REALDIST_BOUNDS
             for f in [next(f for f, _ in bucket_pool
                            if f["src_word"].shape[1] == b)]]
    pair = {arm: (pt.Executor(pt.CUDAPlace(0), capture=arm == "captured"),
                  copy_scope(start), []) for arm in ("captured", "eager")}
    for f in order:
        for arm, (e, scope, out) in pair.items():
            out.append(e.run(main, feed=f, fetch_list=[cost],
                             scope=scope)[0].tobytes())
    same_bits = pair["captured"][2] == pair["eager"][2]
    diff = state_rel_l2(pair["captured"][1], pair["eager"][1])
    del pair, start
    release_memory()

    summary = {"amp": True, "bounds": list(REALDIST_BOUNDS),
               "sizes": list(REALDIST_SIZES), "graphs": graphs,
               "same_bits_captured_eager": same_bits,
               "state_not_bit_equal": diff,
               "launches_per_step": per_step,
               "fixed_pad_max": arms["fixed_pad_max"]["summary"],
               "bucketed": arms["bucketed"]["summary"],
               "profiled_steps": {p: {k: r["window"][k] for k in (
                   "wall_ms", "busy_ms", "idle_share", "trace_launches",
                   "wrapper_launches")} for p, r in records.items()}}
    summary["bucketed_vs_fixed"] = (
        summary["bucketed"]["real_tokens_per_s_best"]
        / summary["fixed_pad_max"]["real_tokens_per_s_best"])
    log("realdist", summary)
    if graphs != 5 or not same_bits or diff or not all(
            summary[a]["losses_finite"] for a in ("fixed_pad_max",
                                                  "bucketed")):
        raise SystemExit("realdist: graphs %d (5 expected), captured equal "
                         "to eager %s, state differing %s"
                         % (graphs, same_bits, sorted(diff)[:5]))
    realdist_checks(per_bound)
    return summary, records


def realdist_checks(per_bound):
    """The float32 card-vs-CPU step (``train_check_phase``, the CPU taking
    the card's ReLU decisions, at ``train_check``'s fixed band) on a whole
    batch of the smallest and the largest bucket (512 x 16, 128 x 64),
    then each planted fault of ``TRAIN_CHECK_FAULTS`` on the card, which
    the same check must fail: TF32 products on the 64 bucket, key lengths
    one short on the 16 bucket."""
    first, last = REALDIST_BOUNDS[0], REALDIST_BOUNDS[-1]
    for bound in (first, last):
        train_check_phase(feed=per_bound[bound][0][0],
                          name="realdist_check_b%d" % bound)
        release_memory()
    passed = []
    for fault, bound in (("tf32", last), ("klen", first)):
        s = train_check_phase(feed=per_bound[bound][0][0], fault=fault,
                              name="realdist_fault_%s_b%d" % (fault, bound))
        if s["within"]:
            passed.append(fault)
        release_memory()
    if passed:
        raise SystemExit("realdist: the card-vs-CPU check passed a planted "
                         "fault: %s" % passed)


RESNET_FEED_POOL = 8


def resnet_feed_phase(windows=3, window_steps=20, batch=RESNET_BATCH):
    """ResNet-50 plain under AMP at batch 128 (the fastest of the three
    AMP programs at that batch), fed three ways from one pool of
    ``RESNET_FEED_POOL`` host batches built before timing (so the arms
    time feeding, not image synthesis),
    each arm a captured executor and a scope from one startup state,
    under cuDNN's deterministic algorithms:

    * ``staged``: the pool copied to the card once, CUDA tensors fed;
    * ``sync``: a host (numpy) batch every step, ``Executor.run`` with
      the loss fetched every step;
    * ``prefetch``: the same host batches through
      ``PyReader(capacity=2)`` (``DevicePrefetcher``: pinned copies on its
      side stream under the previous step), ``return_numpy=False`` and
      one loss read a window, as bench.py's ``with_reader`` path.

    Each with the float32 image feed and with bench.py's reader-included
    uint8 feed (cast and scale on the card).  Two untimed steps each
    (the second captures), then ``windows`` windows of ``window_steps``
    steps (wall a step: the median window's, and each window's), then
    one profiled window of as many steps (device busy a step, and wall
    minus busy within that window, where the profiler slows both alike).
    Gate: the prefetched arm's losses are the synchronous arm's bits,
    step for step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.reader import PyReader

    steps = 2 + windows * window_steps + window_steps
    out, bad = {}, []
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for uint8 in (False, True):
            feed_name = "uint8" if uint8 else "float32"
            main, startup, loss = build_resnet("plain", amp=True,
                                               uint8=uint8)
            start = pt.Scope()
            pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
            rng = np.random.RandomState(0)
            pool = []
            for _ in range(RESNET_FEED_POOL):
                img = rng.randint(0, 256, (batch, 3, 224, 224)).astype(
                    "uint8") if uint8 else rng.rand(
                        batch, 3, 224, 224).astype("float32")
                pool.append({"img": img, "label": rng.randint(
                    0, 1000, (batch, 1)).astype("int64")})
            batches = [pool[i % len(pool)] for i in range(steps)]
            arms = {}
            for arm in ("staged", "sync", "prefetch"):
                exe, scope = pt.Executor(pt.CUDAPlace(0)), copy_scope(start)
                if arm == "staged":
                    on_card = [{k: torch.from_numpy(v).cuda()
                                for k, v in f.items()} for f in pool]
                    it = iter([on_card[i % len(pool)] for i in range(steps)])
                elif arm == "sync":
                    it = iter(batches)
                else:
                    it = iter(PyReader(capacity=2).decorate_batch_reader(
                        lambda: iter(batches), None, pt.CUDAPlace(0)))
                sync = arm == "sync"
                losses = []

                def run(n):
                    for _ in range(n):
                        last = exe.run(main, feed=next(it),
                                       fetch_list=[loss], scope=scope,
                                       return_numpy=sync)
                        losses.append(last[0])
                    if not sync:
                        float(last[0][0])

                run(2)
                times = []
                for _ in range(windows):
                    t0 = time.perf_counter()
                    run(window_steps)
                    times.append(time.perf_counter() - t0)
                prof = device_window(lambda: run(window_steps))
                wall = statistics.median(times) / window_steps * 1e3
                busy = prof["busy_ms"] / window_steps
                profiled = prof["wall_ms"] / window_steps
                arms[arm] = {
                    "step_ms": wall, "busy_ms": busy,
                    "wall_minus_busy_ms": profiled - busy,
                    "images_per_s": batch / wall * 1e3,
                    "window_step_ms": [t / window_steps * 1e3
                                       for t in times],
                    "profiled_idle_share": prof["idle_share"],
                    "profiled_wall_ms": profiled,
                    "losses": [np.asarray(l.cpu() if isinstance(
                        l, torch.Tensor) else l, np.float32).tobytes()
                        for l in losses]}
                del exe, scope, it
                release_memory()
            same = arms["prefetch"]["losses"] == arms["sync"]["losses"]
            for a in arms.values():
                a["losses"] = [float(np.frombuffer(b, np.float32)[0])
                               for b in a.pop("losses")]
            out[feed_name] = dict(arms, prefetch_same_bits_as_sync=same,
                                  sync_minus_prefetch_ms=arms["sync"][
                                      "step_ms"] - arms["prefetch"][
                                      "step_ms"],
                                  feed_mb=sum(v.nbytes for v in pool[0]
                                              .values()) / 1e6)
            if not same or not all(np.isfinite(a["losses"]).all()
                                   for a in arms.values()):
                bad.append(feed_name)
            del start
            release_memory()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    summary = {"batch": batch, "amp": True, "program": "plain",
               "pool": RESNET_FEED_POOL, "steps_per_arm": steps, **out}
    log("resnet_feed", summary)
    if bad:
        raise SystemExit("resnet_feed: the prefetched losses are not the "
                         "synchronous ones' bits: %s" % bad)
    return summary


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


def _profile_report(prof, window):
    """Per ``dispatch/<kind>`` range: host wall time, device busy time
    (union of kernel intervals inside it) and the device's idle share; the
    kernels and host ops that take the most time."""
    from torch.autograd import DeviceType

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

    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # the port's own kernels (csrc/*.cu, all in anonymous namespaces),
    # whatever their rank
    port = {k: v for k, v in by_name.items()
            if k.startswith("void (anonymous namespace)::")
            and "at::" not in k}
    top_host = sorted(prof.key_averages(),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    log("profile", {
        "window": window, "kernel_events": len(kernels),
        "dispatch": per_kind,
        "top_device_us": [(k, us, n) for k, (us, n) in top_dev],
        "port_kernels_us": [(k, us, n) for k, (us, n) in sorted(
            port.items(), key=lambda kv: -kv[1][0])],
        "device_us": sum(us for us, _ in by_name.values()),
        "top_host_self_us": [(e.key[:70], e.self_cpu_time_total, e.count)
                             for e in top_host]})
    return per_kind


def profile_phase(place, model=MODEL, steps=20, prompt=400, bucket=512,
                  quantize=None):
    """torch.profiler over one prefill (every slot, ``prompt`` tokens in
    the ``bucket`` bucket) and ``steps`` decode steps of the serving
    slice (int8 weights with ``quantize``), each driven through
    ``Executor.run`` and fetched as the engine fetches it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import build_decoder_lm
    from torch.profiler import ProfilerActivity, profile, record_function

    spec = build_decoder_lm(**model)
    exe, scope = pt.Executor(place), pt.Scope()
    spec.init_scope(exe, scope)
    if quantize:
        spec = spec.quantize(scope, mode=quantize)
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
    _profile_report(prof, "1 prefill (%d x %d, bucket %d) + %d decode steps"
                    ", quantize=%s" % (s, prompt, bucket, steps, quantize))


def _profile_steps(place, program, startup, loss, feeds, warm, window):
    """torch.profiler over the steps of ``feeds[warm:]``, after ``warm``
    untimed steps (the second of which captures the step), each fetched
    as the train phases fetch it."""
    import paddle_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile, record_function

    exe, scope = pt.Executor(place), pt.Scope()
    exe.run(startup, scope=scope)
    for f in feeds[:warm]:
        exe.run(program, feed=f, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in feeds[warm:]:
            with record_function("dispatch/train_step"):
                exe.run(program, feed=f, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
    _profile_report(prof, window)


def train_profile_phase(place, steps=2, batch=TRAIN_BATCH, amp=False):
    """torch.profiler over ``steps`` replayed training steps of the train
    phase's program (under ``amp``, ``train_amp``'s)."""
    main, startup, cost = build_train(0.1, amp)
    rng = np.random.RandomState(2)
    feeds = [train_feed(rng, batch) for _ in range(steps + 2)]
    _profile_steps(place, main, startup, cost, feeds, 2,
                   "%d training steps%s, batch %d x %d" % (
                       steps, " (AMP)" if amp else "", batch, TRAIN_SEQ))


def resnet_profile_phase(place, steps=2, batch=RESNET_BATCH, amp=False):
    """torch.profiler over ``steps`` replayed steps of each ResNet-50
    program of ``resnet_train`` (under ``amp``: ``resnet_amp``'s), with
    cuDNN's deterministic algorithms as those phases run."""
    rng = np.random.RandomState(0)
    feeds = [resnet_feed(rng, batch) for _ in range(steps + 2)]
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in RESNET_MODES:
            main, startup, loss = build_resnet(mode, amp)
            _profile_steps(place, main, startup, loss, feeds, 2,
                           "%d ResNet-50 %s steps%s, batch %d" % (
                               steps, mode, " (AMP)" if amp else "", batch))
            release_memory()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)


# (kernel, source, the TPU kernel's pallas_call, the path whose launches
# the row's "launches" reports)
KERNEL_ROWS = (
    ("flash_attention_fwd", "csrc/flash_attention_fwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:328", "train"),
    ("flash_attention_bwd", "csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:364", "train"),
    ("layer_norm_fwd", "csrc/layer_norm_fwd.cu",
     "paddle_tpu/ops/pallas/layer_norm.py:59", "train"),
    ("layer_norm_bwd", "csrc/layer_norm_bwd.cu",
     "paddle_tpu/ops/pallas/layer_norm.py:94", "train"),
    ("softmax_xent_fwd", "csrc/softmax_xent.cu",
     "paddle_tpu/ops/pallas/softmax_xent.py:89", "train"),
    ("softmax_xent_bwd", "csrc/softmax_xent.cu",
     "paddle_tpu/ops/pallas/softmax_xent.py:111", "train"),
    ("dequant_matmul", "csrc/quant_matmul.cu",
     "paddle_tpu/ops/pallas/quant_matmul.py:121", "serve_int8:weight_only"),
    ("conv_bn_fwd", "csrc/conv_bn.cu",
     "paddle_tpu/ops/pallas/conv_bn.py:156", "resnet_train:fuse"),
    ("conv_bn_bwd", "csrc/conv_bn.cu",
     "paddle_tpu/ops/pallas/conv_bn.py:248", "resnet_train:fuse"),
    ("conv_bn_fwd_nhwc", "csrc/conv_bn_nhwc.cu",
     "paddle_tpu/ops/pallas/conv_bn.py:332", "resnet_train:nhwc_fuse"),
    ("conv_bn_bwd_nhwc", "csrc/conv_bn_nhwc.cu",
     "paddle_tpu/ops/pallas/conv_bn.py:417", "resnet_train:nhwc_fuse"),
)


# each kernel's AMP path and the kernels-phase check at its dtype and shape
# there (#7 serves int8 and has none): #1/#2 in bfloat16 with dropout, #3-#6
# in float32 (the residual stream and the black-listed loss), #8-#11 in
# bfloat16 at stage 3
AMP_ROWS = {
    "flash_attention_fwd": ("train_amp", "train_causal_dropout_bfloat16"),
    "flash_attention_bwd": ("train_amp", "train_causal_dropout_bfloat16"),
    "layer_norm_fwd": ("train_amp", "layer_norm_16384x512"),
    "layer_norm_bwd": ("train_amp", "layer_norm_bwd_16384x512"),
    "softmax_xent_fwd": ("train_amp", "softmax_xent_fwd_16384x32000_float32"),
    "softmax_xent_bwd": ("train_amp", "softmax_xent_bwd_16384x32000_float32"),
    "dequant_matmul": (None, None),
    "conv_bn_fwd": ("resnet_amp:fuse", "nchw_stage3_bn_relu_bfloat16"),
    "conv_bn_bwd": ("resnet_amp:fuse", "nchw_stage3_bn_relu_stats_bfloat16"),
    "conv_bn_fwd_nhwc": ("resnet_amp:nhwc_fuse",
                         "nhwc_stage3_bn_relu_bfloat16"),
    "conv_bn_bwd_nhwc": ("resnet_amp:nhwc_fuse",
                         "nhwc_stage3_bn_relu_stats_bfloat16"),
}


def release_memory():
    """Free what the last phase's executors, graphs and scopes held."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def count_sass(lib, opcode):
    """How many instructions of ``opcode`` the library's SASS holds
    (``cuobjdump --dump-sass``): HGMMA is wgmma on the tensor cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def main():
    t_start = time.perf_counter()
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
                   "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                   # the port turns it off: bf16 products sum in float32
                   "matmul.allow_bf16_reduced_precision_reduction":
                       torch.backends.cuda.matmul
                       .allow_bf16_reduced_precision_reduction})

    t0 = time.perf_counter()
    built = build.build()
    ptxas = {n: [ln.split("info    : ")[-1] for ln in
                 build.build_log.get(n, "").splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in built}
    # tensor-core instructions in the SASS: wgmma (HGMMA) in #8-#11,
    # mma.sync (HMMA: TF32 / bf16 / f16; IMMA: int8) in #1, #2 and #7
    hgmma = {n: count_sass(built[n], "HGMMA")
             for n in ("conv_bn", "conv_bn_nhwc")}
    hmma = {n: count_sass(built[n], "HMMA") for n in (
        "flash_attention_fwd", "flash_attention_bwd", "quant_matmul")}
    imma = {"quant_matmul": count_sass(built["quant_matmul"], "IMMA")}
    log("build", {"seconds": time.perf_counter() - t0,
                  "kernels": sorted(built), "ptxas": ptxas,
                  "hgmma": hgmma,
                  "hmma": hmma, "imma": imma})
    if not all(hgmma.values()) or not all(hmma.values()) \
            or not all(imma.values()):
        raise SystemExit("a tensor-core kernel holds no tensor-core "
                         "instruction: %s %s %s" % (hgmma, hmma, imma))
    if "--conv-bn" in sys.argv[1:]:
        from paddle_tpu_torch.ops.cuda import conv_bn as cb
        log_checks(conv_bn_cases(cb, Timer()))
        return 0
    if "--train-kernels" in sys.argv[1:]:
        log_checks(train_kernel_cases(Timer()))
        return 0
    if "--serve-kernels" in sys.argv[1:]:
        log_checks(serve_kernel_cases(Timer()))
        return 0
    if "--profile" in sys.argv[1:]:
        for quantize in (None, "weight_only", "dynamic"):
            profile_phase(pt.CUDAPlace(0), quantize=quantize)
        for amp in (False, True):
            train_profile_phase(pt.CUDAPlace(0), amp=amp)
            release_memory()
            resnet_profile_phase(pt.CUDAPlace(0), amp=amp)
        return 0
    if "--resnet-default" in sys.argv[1:]:
        for r, _ in resnet_train_phase(deterministic=False).values():
            log("resnet_train", r)
        return 0
    if "--serve-ab" in sys.argv[1:]:
        # fp and int8 serving in turns (fp, weight_only, dynamic, then the
        # reverse), so host load drifting within the call shows as spread
        for quantize in (None, "weight_only", "dynamic", "dynamic",
                         "weight_only", None):
            summary = serve_phase(pt.CUDAPlace(0), quantize=quantize)[0]
            log("serve_ab", summary)
        return 0

    checks = kernels_phase()
    # the AMP check, card against CPU, at the CPU tests' configurations
    amp_small_checks()
    release_memory()
    # each path with the counters zeroed just before it and read just
    # after: fp serving (kernels #1 and #3), int8 serving in both modes and
    # one-shot int8 inference (#1, #3 and #7), the bf16 score program (#1,
    # #3), Transformer training in float32 and under AMP (#1-#6), then
    # ResNet-50 training in float32 and under AMP: plain (none), fused
    # (#8, #9) and NHWC + fused (#10, #11)
    short, path_launches = {}, {}

    def check_path(path, record):
        # the kernel table reports each path's launches in its profiled
        # window's device trace
        path_launches[path] = record["window"]["trace_launches"]
        short.update({"%s:%s" % (path, k): v
                      for k, v in launch_faults(record).items()})

    # every path runs captured (the main path, whose counts the kernel
    # table reports) and eager (``:eager``), in turns
    for path, (summary, record) in serve_phases(pt.CUDAPlace(0)).items():
        check_path(path, record)
    infer, paths = infer_phase(pt.CUDAPlace(0))
    log("infer", infer)
    if not infer["same_bits_as_eager"]:
        raise SystemExit("captured one-shot serving differs from eager")
    for path, record in paths.items():
        check_path(path, record)
    for path, record in infer_bf16_phase(pt.CUDAPlace(0))[1].items():
        check_path(path, record)
    for amp in (False, True):
        train_check_phase(amp=amp)
        _, paths = train_phase(pt.CUDAPlace(0), amp=amp)
        for path, record in paths.items():
            check_path(path, record)
        release_memory()
    for amp, name in ((False, "resnet_train"), (True, "resnet_amp")):
        resnet_check_phase(amp=amp)
        release_memory()
        for mode, (r, records) in resnet_train_phase(amp=amp).items():
            log(name, r)
            check_path("%s:%s" % (name, mode), records["captured"])
            check_path("%s:%s:eager" % (name, mode), records["eager"])
        release_memory()
    # the input pipeline and the high-level trainer: the MLP through
    # Trainer, bench.py's realdist rung (#1-#6 at the bucket shapes) and
    # ResNet-50 AMP fed three ways
    mlp_trainer_phase()
    release_memory()
    for path, record in realdist_phase()[1].items():
        check_path(path, record)
    resnet_feed_phase()
    release_memory()
    if short:
        raise SystemExit("a path did not launch its kernels as its program "
                         "implies (counted, implied): %s" % short)

    rows = []
    for name, src, tpu, main_path in KERNEL_ROWS:
        # the float32 check at the main path's shape (training for #1-#6,
        # the decode logits projection for #7, ResNet-50's stage-3 layer
        # for #8-#11)
        head = checks[name][0]
        row = {"name": name, "route": "cuda",
               "source": "paddle_tpu_torch/" + src, "replaces": tpu,
               "launches": path_launches[main_path][name],
               "max_abs_err": head["max_abs_err"],
               "ms": head["kernel_ms"], "device_ms": head["device_ms"],
               "plain_ms": head["plain_ms"],
               "bound_ms": head["bound_ms"],
               "bound_by": head["bound_by"].split(" ")[0],
               "library_ms": head["library_ms"],
               "library_device_ms": head.get("library_device_ms"),
               "at": head["check"],
               "launches_path": main_path}
        if "bound_simt_ms" in head:  # #1, #7, #8-#11: the tensor cores'
            # TF32 bound, and the float32 units' beside it
            row.update(bound_rate=head.get("bound_rate", "3xTF32"),
                       bound_simt_ms=head["bound_simt_ms"])
        row.update({"launches_" + p: path_launches[p][name]
                    for p in path_launches})
        # the kernel on its AMP path: the check at that path's dtype and
        # shape, and the path's launches
        amp_path, amp_check = AMP_ROWS[name]
        row["amp"] = None
        if amp_path:
            amp = next(c for c in checks[name] if c["check"] == amp_check)
            row["amp"] = {
                "path": amp_path, "dtype": amp["dtype"],
                "launches": path_launches[amp_path][name], "at": amp_check,
                "max_abs_err": amp["max_abs_err"], "ms": amp["kernel_ms"],
                "device_ms": amp["device_ms"], "plain_ms": amp["plain_ms"],
                "bound_ms": amp["bound_ms"],
                "bound_by": amp["bound_by"].split(" ")[0],
                "library_ms": amp["library_ms"]}
        rows.append(row)
    log("total", {"seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
