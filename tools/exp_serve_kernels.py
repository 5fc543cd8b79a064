"""Where the serving kernels spend their time on the card: #1
(flash-attention forward, ``paddle_tpu_torch/csrc/flash_attention_fwd.cu``)
and #7 (dequant-matmul, ``csrc/quant_matmul.cu``).

Builds variants of a kernel source with parts switched off (by exact
statement text: it raises if the source no longer has them) and times each
through the op's wrapper (``flash_attention_fwd`` /
``dequant_matmul_kernel``): device time of one call (the sum of its
kernels, ``torch.profiler``, as ``chip_smoke.py`` reads the library rows)
and ``chip_smoke.py``'s event timer (L2 flushed before each launch).  A
variant's output is wrong; only its time is read.

  #1 at train causal [256,8,64,64] float32 and bfloat16, prefill causal
     [8,8,1024,64] float32, decode [8,8,1,64] over a 1024-key cache
  full         the kernel as it is
  no_loads     no Q, K or V tile copied in
  no_products  no product (mma, or the decode row's float32 ones)
  no_combine   the decode split's ranks not combined (no output written)
  skeleton     none of the three
  one_rank     the decode shape without the key split (cluster of 1)
  #7 at decode [8,512] x [512,32000] and [8,512] x [512,512], prefill
     [4096,512] x [512,32000], weight_only and dynamic, float32 x
  full, no_loads (no x or weight tile copied in), no_products (no mma),
  no_combine (the K split's partial sums not added), skeleton, ring4 /
  ring2 (the decode kernel with 4 or 2 weight stages in flight, not 8),
  gemm_one_block (the prefill kernel at one block an SM, not two)

Run from the repo root on a machine with an H100 and nvcc:

    python3 tools/exp_serve_kernels.py [attention] [dequant] \
        [--variants full,no_loads,...]   # default: every variant
    python3 tools/exp_serve_kernels.py --root DIR   # the kernels of the
        # checkout at DIR as they are, through its wrappers: one process a
        # tree, so that two trees can be timed in turns in one call

Prints the card's name and power limit, then one JSON line a kernel and
shape: {variant: [[device ms, event ms], ...]}, every variant timed twice
in turns (the list, then the list reversed), with the library call's
device time beside it.  With ``--root`` one line a kernel and shape:
device ms twice, event ms, the device kernels one call ran, and the
library's device ms.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import exp_train_kernels as etk  # noqa: E402

qm = None  # the dequant-matmul wrapper module of the tree timed

_off = etk._off

ATT_LOADS = _off(
    "  load_tile<T, kThreads>(sK, k, w.ks + i * kBT, w.ke, 1.f);\n",
    "  load_tile<T, kThreads, true>(sK + kTile, v, w.ks + i * kBT, w.ke, 1.f);"
    "\n",
    "    load_tile<T, kThreads>(sQ, q + qoff, q0, Tq, qround);\n")
ATT_PRODUCTS = _off(
    "      for (int c = 0; c < kD; c += kStep<T>) mma_step<T, true>(s, aQ, bK, c);"
    "\n",
    "          mma_frags<T>(oacc, ah, al, bh_, bl_);\n",
    "          mma_frags<T>(oacc, a, a, bh_, bl_);\n",
    # the one-row decode path's float32-unit products
    "      sj = fmaf(q4.x, k4.x, sj);\n", "      sj = fmaf(q4.y, k4.y, sj);\n",
    "      sj = fmaf(q4.z, k4.z, sj);\n", "      sj = fmaf(q4.w, k4.w, sj);\n",
    "      pv = fmaf(sP[r], sV[sidx(pr, d)], pv);\n")
ATT_COMBINE = _off(
    "  for (int e = rank * kThreads + threadIdx.x; e < rows * kD;\n")
ATTENTION = ("flash_attention_fwd", {
    "full": [],
    "no_loads": ATT_LOADS,
    "no_products": ATT_PRODUCTS,
    "no_combine": ATT_COMBINE,
    "skeleton": ATT_LOADS + ATT_PRODUCTS + ATT_COMBINE,
    "one_rank": [("  while (c < kMaxCluster && (long)blocks * c * 2 <= kWave "
                  "&& c * 2 * kBT <= Tk)\n    c *= 2;\n", "")],
})

DQ_LOADS = _off(
    "    copy16(xs + r * xld + col, xb + (size_t)min(r, M - 1) * xrow + ks * "
    "sizeof(T),\n",
    "        copy16(tile + wchunk(r, c & 7) * 16,\n",
    "        copy16(xt + swz(r, j), xb + (size_t)min(gm, M - 1) * arow,\n",
    "        copy16(wt + wchunk(r, c & 7) * 16,\n")
DQ_PRODUCTS = _off(
    "      kstep_t<MODE, T, MB>(acc, word, (st * kWBK + k) / PW, tile, k, 8 * wc);"
    "\n",
    "      kstep<MODE, T, MT, NJ>(acc, word, s * KS / PW, xt + G::BM * 128, "
    "s * KS,\n")
DQ_COMBINE = _off("  for (int e = rank * kDecodeThreads + tid; e < M * kBN;\n")
DEQUANT = ("quant_matmul", {
    "full": [],
    "no_loads": DQ_LOADS,
    "no_products": DQ_PRODUCTS,
    "no_combine": DQ_COMBINE,
    "skeleton": DQ_LOADS + DQ_PRODUCTS + DQ_COMBINE,
    # the decode kernel's ring: at most 4 or 2 stages of 64 weight rows in
    # flight a block, not 8
    "ring4": [("constexpr int kDecodeStages = 8;", "constexpr int kDecodeStages = 4;")],
    "ring2": [("constexpr int kDecodeStages = 8;", "constexpr int kDecodeStages = 2;")],
    # the prefill kernel held to one block an SM (up to 255 registers a
    # thread: the dynamic instantiations spill at two)
    "gemm_one_block": [("__launch_bounds__(kGemmThreads, 2)",
                        "__launch_bounds__(kGemmThreads, 1)")],
})
KERNELS = {"attention": ATTENTION, "dequant": DEQUANT}

# chip_smoke.py's key lengths at the prefill and decode shapes
PREFILL_KLEN = [1024, 700, 513, 64, 1, 0, 300, 999]
DECODE_KLEN = [1024, 65, 700, 1, 333, 512, 1000, 2]


def attention_case(shape, dtype):
    """(kernel call, library call) at one of #1's shapes; the library is
    ``scaled_dot_product_attention`` under the same boolean mask."""
    if shape == "train":
        b, tq, tk = cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.TRAIN_SEQ
        klen = cs._train_klen()[0]
    elif shape == "prefill":
        b, tq, tk, klen = 8, 1024, 1024, PREFILL_KLEN
    else:
        b, tq, tk, klen = 8, 1, 1024, DECODE_KLEN
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((b, 8, t, 64), generator=g, device="cuda")
               .to(dtype) for t in (tq, tk, tk))
    kl = torch.tensor(klen, dtype=torch.int32, device="cuda")
    valid = cs._pairs_and_keys(b, 8, tq, tk, True, kl)[0]
    fa = etk.fa
    return (lambda: fa.flash_attention_fwd(q, k, v, kl, None, True),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=valid, scale=0.125))


def dequant_case(shape, mode):
    """(kernel call, library call) at one of #7's shapes: the library is a
    matmul on the weight dequantized beforehand (weight_only) or
    ``torch._int_mm`` where it takes the shape (dynamic, prefill)."""
    m, k, n = {"decode_logits": (8, 512, 32000),
               "decode_proj": (8, 512, 512),
               "prefill": (4096, 512, 32000)}[shape]
    g = torch.Generator(device="cuda").manual_seed(m + n)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") * 0.05
    scale = torch.clamp(w.abs().amax(dim=0), min=1e-12) / 127.0
    qw = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    lib = None
    if mode == "weight_only":
        w_deq = qw.float() * scale

        def lib():
            torch.matmul(x, w_deq)
    elif m > 16:
        qx = qm.quantize_rows_reference(x)[0]

        def lib():
            torch._int_mm(qx, qw)
    return lambda: qm.dequant_matmul_kernel(x, qw, scale, mode), lib


def cases(which):
    """(kernel key, case name, builder) for the kernels asked for."""
    out = []
    if "attention" in which:
        out += [("attention", "train_causal_float32",
                 lambda: attention_case("train", torch.float32)),
                ("attention", "train_causal_bfloat16",
                 lambda: attention_case("train", torch.bfloat16)),
                ("attention", "prefill_float32",
                 lambda: attention_case("prefill", torch.float32)),
                ("attention", "decode_float32",
                 lambda: attention_case("decode", torch.float32))]
    if "dequant" in which:
        for mode in ("weight_only", "dynamic"):
            for shape in ("decode_logits", "decode_proj", "prefill"):
                out.append(("dequant", "%s_%s" % (mode, shape),
                            lambda s=shape, md=mode: dequant_case(s, md)))
    return out


def _import(root):
    global qm
    etk._import(root)
    from paddle_tpu_torch.ops.cuda import quant_matmul  # noqa: F811
    qm = quant_matmul


def _lib_device_ms(lib):
    return None if lib is None else cs.device_ms(cs.library_kernels(lib))


def time_tree(root, which, timer):
    """The kernels of the tree at ``root`` as they are, through its
    wrappers (whose signatures have not changed since they were ported).
    Both libraries are built and loaded first: a profile taken around a
    call that ran nvcc or loaded its library read no device time."""
    for key in which:
        etk.build.library(KERNELS[key][0])
    for key, name, make in cases(which):
        kern, lib = make()
        kern()
        kernels = [cs.library_kernels(kern) for _ in range(2)]
        print(json.dumps({
            "root": root, "kernel": KERNELS[key][0], "case": name,
            "device_ms": [cs.device_ms(k) for k in kernels],
            "device_kernels": kernels, "event_ms": timer(kern),
            "library_device_ms": _lib_device_ms(lib)}), flush=True)
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("exp_serve_kernels: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    root = REPO
    if "--root" in args:
        root = os.path.abspath(args[args.index("--root") + 1])
    _import(root)
    which = [a for a in args if a in KERNELS] or list(KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    timer = cs.Timer()
    if "--root" in args:
        time_tree(root, which, timer)
        return 0
    build = etk.build
    keep = (args[args.index("--variants") + 1].split(",")
            if "--variants" in args else None)
    built = {}
    for w in which:
        name, variants = KERNELS[w]
        variants = {v: s for v, s in variants.items()
                    if keep is None or v in keep}
        built[w] = etk.build_variants(name, variants)
        for var in variants:  # registers and spills of each instantiation
            log = etk.variant_logs[name, var].splitlines()
            print(json.dumps({"kernel": name, "variant": var, "ptxas": [
                ln.split("info    : ")[-1] for ln in log
                if "Compiling entry" in ln or "registers" in ln
                or "spill" in ln]}), flush=True)
    library = build.library
    try:
        for key, name, make in cases(which):
            kname, libs = KERNELS[key][0], built[key]
            kern, lib = make()
            row = {var: [] for var in libs}
            for var in list(libs) + list(libs)[::-1]:
                build.library = (lambda n, var=var, kname=kname: libs[var]
                                 if n == kname else library(n))
                row[var].append([cs.device_ms(cs.library_kernels(kern)),
                                 timer(kern)])
            build.library = library
            print(json.dumps({"kernel": kname, "case": name, "ms": row,
                              "library_device_ms": _lib_device_ms(lib)}),
                  flush=True)
            torch.cuda.empty_cache()
    finally:
        build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
