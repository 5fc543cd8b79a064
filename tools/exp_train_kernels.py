"""Where the Transformer-training backward kernels spend their time on the
card: #2 (flash-attention backward, ``paddle_tpu_torch/csrc/
flash_attention_bwd.cu``) and #4 (layer-norm backward, ``csrc/
layer_norm_bwd.cu``).

Builds variants of a kernel source with parts switched off (or changed)
and times each through the op's wrapper (``flash_attention_bwd`` /
``layer_norm_bwd``) at the training shapes: device time of one call (the
sum of its kernels, ``torch.profiler``, as ``chip_smoke.py`` reads the
library rows) and ``chip_smoke.py``'s event timer (L2 flushed before each
launch).  A variant's output is wrong; only its time is read.

  #2 (train causal [256,8,64,64], float32 and bfloat16)
  full            the kernel as it is
  no_loads        no Q, dO, K, V tile is copied in and no row of O read
  no_products     none of the five mma products
  no_elementwise  no P / dS step (exp, masks, dropout hash)
  skeleton        none of the three: launch, delta, barriers, stores
  no_split        float32 operands not split into hi/lo (still 3 passes)
  one_pass        one TF32 pass, not three
  one_block_sm    __launch_bounds__ for one block an SM (255 registers)
  #4 ([16384,512] float32 and bfloat16)
  full, no_loads (no row of x or dy read), no_stores (no dx written),
  no_columns (no column pass), skeleton (none of the three)

Run from the repo root on a machine with an H100 and nvcc:

    python3 tools/exp_train_kernels.py [attention] [layer_norm]
    python3 tools/exp_train_kernels.py --root DIR   # the kernels of the
        # checkout at DIR as they are, through its wrappers: one process a
        # tree, so that two trees can be timed in turns in one call; #2's
        # rows carry a digest of its outputs on inputs from the plain
        # forward, equal in two trees whose #2 gives the same bits

Prints the card's name and power limit, then one JSON line a kernel and
type: {variant: [[device ms, event ms], ...]}, every variant timed twice
in turns (the list, then the list reversed), the library call's device
time, and the bytes the kernel moves through L2 against the distinct bytes
of its inputs and outputs (arithmetic from the grid).  The variants are
the only libraries of their kernel loaded in the process: the profiler
reads no device time for a kernel whose name two loaded libraries share.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# the package's kernel modules, imported by main() from the tree timed
build = fa = ln = None


def _off(*stmts):
    """Substitutions that guard each statement (its first line) with
    ``if (0)``."""
    out = []
    for s in stmts:
        indent = s[:len(s) - len(s.lstrip())]
        out.append((s, indent + "if (0) " + s.lstrip()))
    return out


ATT_LOADS = _off("    load_tile<T, kThreads>(sK, k + koff, k0, Tk, 1.f);\n",
                 "    load_tile<T, kThreads>(sV, v + koff, k0, Tk, 1.f);\n",
                 "    load_tile<T, kThreads>(sQ, q + qoff, q0, Tq, qround);\n",
                 "    load_tile<T, kThreads>(sdO, dout + qoff, q0, Tq, 1.f);\n") + [
    ("    if (gq < Tq) load16<T>(", "    if (0) load16<T>(")]
ATT_PRODUCTS = _off(
    "      for (int c = 0; c < kD; c += kStep<T>) "
    "mma_step<T>(sg, aSG, bSG, c);\n",
    "      mma_step<T>(acc, aXY, bXY, c);\n",
    "      mma_step<T>(aq, aQ, bQ, c);\n")
ATT_ELEMENTWISE = _off(
    "    p_ds<T>(sP, sS, sL, sDl, q0, k0, kl, Tq, Tk, causal, seed, "
    "(uint32_t)bh,\n")
ATTENTION = ("flash_attention_bwd", {
    "full": [],
    "no_loads": ATT_LOADS,
    "no_products": ATT_PRODUCTS,
    "no_elementwise": ATT_ELEMENTWISE,
    "skeleton": ATT_LOADS + ATT_PRODUCTS + ATT_ELEMENTWISE,
    "no_split": [("attention.cuh",
                  "    hi = tf32(x);\n    lo = tf32(x - __uint_as_float(hi));\n",
                  "    hi = __float_as_uint(x);\n    lo = hi;\n")],
    "one_pass": [("attention.cuh", "mma_tf32(acc[i][j], al[i], bh[j]);", "{}"),
                 ("attention.cuh", "mma_tf32(acc[i][j], ah[i], bl[j]);",
                  "{}")],
    "one_block_sm": [("__launch_bounds__(kThreads, 2)",
                      "__launch_bounds__(kThreads, 1)")],
})

LN_LOADS = _off("  if (row < N) load_row(row, cx, cd, cmu, crs);\n",
                "    if (row + stride < N) "
                "load_row(row + stride, nx, nd, nmu, nrs);\n")
LN_STORES = _off(
    "      *reinterpret_cast<R*>(dxr + c) = from_floats<T, EPV>(out);\n")
LN_COLUMNS = _off("  layer_norm_bwd_columns<T><<<dim3((unsigned)cdiv(D, "
                  "kColWidth), 2), kColThreads,\n")
LAYER_NORM = ("layer_norm_bwd", {
    "full": [],
    "no_loads": LN_LOADS,
    "no_stores": LN_STORES,
    "no_columns": LN_COLUMNS,
    "skeleton": LN_LOADS + LN_STORES + LN_COLUMNS,
})
KERNELS = {"attention": ATTENTION, "layer_norm": LAYER_NORM}


def variant_source(src, subs):
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError("the kernel source changed: %r" % old)
        src = src.replace(old, new)
    return src


# (kernel, variant) -> the compiler's output (ptxas registers and spills)
variant_logs = {}


def build_variants(name, variants):
    """Compile every variant of csrc/<name>.cu in parallel; {variant:
    ctypes library}.  A substitution is (old, new) in the kernel's source
    or (header, old, new) in a header it includes: the variant's directory
    then holds its own copy of that header, which the include finds
    first."""
    out_dir = os.path.join(build.BUILD_DIR, "exp_" + name)
    procs = {}
    for var, subs in variants.items():
        vdir = os.path.join(out_dir, var)
        os.makedirs(vdir, exist_ok=True)
        by_file = {name + ".cu": []}
        for sub in subs:
            path, old, new = sub if len(sub) == 3 else (name + ".cu",) + sub
            by_file.setdefault(path, []).append((old, new))
        for path, file_subs in by_file.items():
            with open(os.path.join(build.CSRC, path)) as f:
                text = f.read()
            with open(os.path.join(vdir, path), "w") as f:
                f.write(variant_source(text, file_subs))
        cu, so = (os.path.join(vdir, name + ext) for ext in (".cu", ".so"))
        procs[var] = (so, subprocess.Popen(
            [build._nvcc()] + build.NVCC_FLAGS + ["-I", build.CSRC, "-o", so,
                                                  cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for var, (so, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s %s:\n%s"
                               % (name, var, log[-3000:]))
        variant_logs[name, var] = log
        libs[var] = ctypes.CDLL(so)
    return libs


def attention_inputs(dtype):
    """The train phase's shape: [256, 8, 64, 64], causal, klen in [16, 64]
    drawn as ``chip_smoke.py`` draws it."""
    import numpy as np
    b, h, t, d = cs.TRAIN_BATCH, 8, cs.TRAIN_SEQ, 64
    klen = np.random.RandomState(3).randint(16, t + 1, b).tolist()
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, dout = (torch.randn((b, h, t, d), generator=g, device="cuda")
                     .to(dtype) for _ in range(4))
    kl = torch.tensor(klen, dtype=torch.int32, device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, kl, None, True)
    args = (q, k, v, kl, None, True, 0.0, None, out, lse, dout)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    valid = cs._pairs_and_keys(b, h, t, t, True, kl)[0]
    o = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=valid, scale=1.0 / d ** 0.5)
    item = q.element_size()
    # one key tile and one query tile a (b, h): every block reads its Q,
    # dO, O, K and V tiles once and writes dQ, dK and dV once
    l2 = {"read": 5 * q.numel() * item, "written": 3 * q.numel() * item}
    return (lambda: fa.flash_attention_bwd(*args),
            lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
            lambda: l2, dict(l2))


def layer_norm_inputs(dtype):
    n, d = cs.TRAIN_BATCH * cs.TRAIN_SEQ, cs.TRAIN["d_model"]
    g = torch.Generator(device="cuda").manual_seed(n + 1)
    x = (torch.randn((n, d), generator=g, device="cuda") * 3 + 1).to(dtype)
    gamma, beta = (torch.randn((d,), generator=g, device="cuda").to(dtype)
                   for _ in range(2))
    dy = torch.randn((n, d), generator=g, device="cuda").to(dtype)
    _, mean, var = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    rstd = torch.rsqrt(var + 1e-5)
    args = (x, gamma, mean, rstd, dy)
    leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    y = torch.nn.functional.layer_norm(leaves[0], (d,), leaves[1], leaves[2],
                                       1e-5)
    item = x.element_size()
    distinct = {"read": 2 * x.numel() * item + d * item + 2 * n * 4,
                "written": x.numel() * item + 2 * d * item}

    def l2():
        # after a launch (the wrapper caches the grid): the partial sums
        # are written by the row pass and read by the column pass, and
        # every block reads gamma
        blocks = ln._row_blocks(n, ln._resident[
            (x.device.index, ln._DTYPE_CODE[dtype], d, 1)])
        part = 2 * blocks * d * 4
        return {"read": distinct["read"] + part + blocks * d * item,
                "written": distinct["written"] + part, "row_blocks": blocks}
    return (lambda: ln.layer_norm_bwd(*args),
            lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
            l2, distinct)


INPUTS = {"attention": attention_inputs, "layer_norm": layer_norm_inputs}


def _import(root):
    global build, fa, ln
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops.cuda import build  # noqa: F811
    from paddle_tpu_torch.ops.cuda import flash_attention as fa  # noqa: F811
    from paddle_tpu_torch.ops.cuda import layer_norm as ln  # noqa: F811


def attention_bits(dtype):
    """sha256 of #2's dQ, dK, dV at the training shape from inputs that do
    not depend on the tree's #1: O and LSE from the plain forward.  Equal
    digests from two trees: #2 gives the same bits in both."""
    import hashlib
    b, h, t, d = cs.TRAIN_BATCH, 8, cs.TRAIN_SEQ, 64
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, dout = (torch.randn((b, h, t, d), generator=g, device="cuda")
                     .to(dtype) for _ in range(4))
    kl = torch.tensor(cs._train_klen()[0], dtype=torch.int32, device="cuda")
    out, lse = fa.reference_attention_lse(q, k, v, kl, None, True)
    grads = fa.flash_attention_bwd(q, k, v, kl, None, True, 0.0, None, out,
                                   lse.contiguous(), dout)
    digest = hashlib.sha256()
    for x in grads:
        digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def time_tree(root, which, timer):
    """The kernels of the tree at ``root`` as they are, through its
    wrappers (whose signatures have not changed since they were ported);
    for #2 also the digest of its outputs (``attention_bits``)."""
    for w in which:
        for dtype in (torch.float32, torch.bfloat16):
            kern, lib, _, _ = INPUTS[w](dtype)
            kern()
            kernels = [cs.library_kernels(kern) for _ in range(2)]
            row = {"root": root, "kernel": KERNELS[w][0],
                   "dtype": str(dtype).replace("torch.", ""),
                   "device_ms": [cs.device_ms(k) for k in kernels],
                   "device_kernels": kernels,
                   "event_ms": timer(kern),
                   "library_device_ms": cs.device_ms(
                       cs.library_kernels(lib))}
            if w == "attention":
                row["bits_sha256"] = attention_bits(dtype)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("exp_train_kernels: no CUDA device", file=sys.stderr)
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
    built = {w: build_variants(*KERNELS[w]) for w in which}
    library = build.library
    try:
        for w in which:
            name = KERNELS[w][0]
            libs = built[w]
            for dtype in (torch.float32, torch.bfloat16):
                kern, lib, l2, distinct = INPUTS[w](dtype)
                row = {var: [] for var in libs}
                for var in list(libs) + list(libs)[::-1]:
                    build.library = (lambda n, var=var, name=name: libs[var]
                                     if n == name else library(n))
                    row[var].append([cs.device_ms(cs.library_kernels(kern)),
                                     timer(kern)])
                build.library = library
                print(json.dumps({
                    "kernel": name, "dtype": str(dtype).replace("torch.", ""),
                    "ms": row,
                    "library_device_ms": cs.device_ms(
                        cs.library_kernels(lib)),
                    "l2_bytes": l2(), "distinct_bytes": distinct}),
                    flush=True)
                torch.cuda.empty_cache()
    finally:
        build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
