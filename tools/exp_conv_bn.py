"""Where the tensor-core conv+BN kernels spend their time on the card: #8/#9
(NCHW, ``paddle_tpu_torch/csrc/conv_bn.cu``) and #10/#11 (NHWC,
``csrc/conv_bn_nhwc.cu``).

Builds variants of a kernel source with stages of the main loop switched
off and times each through the op's wrappers (``conv_bn_fwd`` /
``conv_bn_bwd``, ``conv_bn_fwd_nhwc`` / ``conv_bn_bwd_nhwc``) with
``chip_smoke.py``'s timer (CUDA events, L2 flushed before each launch), at
ResNet-50's shapes.  A variant's output is wrong; only its time is read.

  full          the kernel as it is
  no_wgmma      the main loop issues no wgmma
  no_transform  no transform step (the swizzled tiles keep stale data)
  no_loads      no tile is copied in
  loads_only    neither wgmma nor transform
  skeleton      none of the three: launch, barriers and epilogue

Run from the repo root on a machine with an H100 and nvcc:

    python3 tools/exp_conv_bn.py [nchw] [nhwc]     # default: both

Prints the card's name and power limit, then one JSON line a layout and
shape: {variant: [[forward ms, backward ms], ...]} with every variant
timed twice, in turns (the list, then the list reversed), the library
calls' times (``F.conv2d`` / ``torch.matmul`` on operands prepared
beforehand), and, for NCHW, the bytes the blocks read through L2 against
the distinct bytes of the inputs (arithmetic from the grid: each block
reads its A and B tiles once a k tile).
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
from paddle_tpu_torch.ops.cuda import build  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn as cb  # noqa: E402

# per layout: the source, and the statements of its main loop that each
# stage switches off by guarding them with if (0)
LAYOUTS = {
    "nchw": ("conv_bn", {
        "wgmma": ["    mma_tiles<T>(aop, KA == kPre ? op : op + L::OPB, acc);\n"],
        "transform": ["  xform(0);\n", "      xform(t + 1);\n"],
        "loads": ["    if (t < nt) {\n"],
    }),
    "nhwc": ("conv_bn_nhwc", {
        "wgmma": ["    mma<T>(sm + (t & 1) * OPB, acc);\n"],
        "transform": ["  xform(0);\n", "      xform(t + 1);\n"],
        "loads": ["    if (t < nt) {\n"],
    }),
}
VARIANTS = {"full": (), "no_wgmma": ("wgmma",),
            "no_transform": ("transform",), "no_loads": ("loads",),
            "loads_only": ("wgmma", "transform"),
            "skeleton": ("wgmma", "transform", "loads")}
SHAPES = (("stage3", torch.float32, True), ("stage3", torch.bfloat16, True),
          ("stage1", torch.float32, False), ("stage4", torch.float32, True))


def variant_source(src, stages, off):
    for stage in off:
        for stmt in stages[stage]:
            if src.count(stmt) != 1:
                raise RuntimeError("the kernel source changed: %r" % stmt)
            indent = stmt[:len(stmt) - len(stmt.lstrip())]
            if stmt.rstrip().endswith("{"):
                guarded = indent + "if (0) {\n"
            else:
                guarded = indent + "if (0) " + stmt.lstrip()
            src = src.replace(stmt, guarded)
    return src


def build_variants(layout):
    name, stages = LAYOUTS[layout]
    with open(os.path.join(build.CSRC, name + ".cu")) as f:
        src = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "exp_" + name)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for var, off in VARIANTS.items():
        cu, so = (os.path.join(out_dir, var + ext) for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(variant_source(src, stages, off))
        procs[var] = (so, subprocess.Popen(
            [build._nvcc()] + build.NVCC_FLAGS + ["-I", build.CSRC, "-o", so,
                                                  cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for var, (so, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s %s:\n%s"
                               % (layout, var, log[-3000:]))
        libs[var] = ctypes.CDLL(so)
    return name, libs


def l2_bytes(b, c, o, hw, dtype, fold):
    """(bytes the NCHW blocks read through L2, distinct input bytes), for
    the forward and the backward: each block reads its A and B tiles once
    a k tile, W as its split tiles (float32: hi and lo)."""
    item, tile = (4, 128) if dtype == torch.float32 else (2, 128)
    bk = 128 // item
    n = b * hw
    cdiv = lambda a, d: -(-a // d)  # noqa: E731
    w_tile = tile * bk * item * (2 if item == 4 else 1)
    act_tile = tile * bk * item
    fwd = cdiv(o, tile) * cdiv(n, tile) * cdiv(c, bk) * (w_tile + act_tile)
    dx = cdiv(c, tile) * cdiv(n, tile) * cdiv(o, bk) \
        * (w_tile + act_tile * (2 if fold else 1))
    splits, chunk = cb._dw_splits(b, hw, c, o)
    dw = cdiv(c, tile) * cdiv(o, tile) * splits * cdiv(chunk, bk) \
        * act_tile * (3 if fold else 2)
    return ({"fwd": fwd, "bwd": dx + dw},
            {"fwd": (n * c + o * c) * item,
             "bwd": (n * c + n * o * (2 if fold else 1) + o * c) * item})


def main():
    if not torch.cuda.is_available():
        print("exp_conv_bn: no CUDA device", file=sys.stderr)
        return 2
    layouts = [a for a in sys.argv[1:] if a in LAYOUTS] or list(LAYOUTS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    built = {lay: build_variants(lay) for lay in layouts}
    library, timer = build.library, cs.Timer()
    try:
        for layout in layouts:
            name, libs = built[layout]
            nhwc = layout == "nhwc"
            kf = cb.conv_bn_fwd_nhwc if nhwc else cb.conv_bn_fwd
            kb = cb.conv_bn_bwd_nhwc if nhwc else cb.conv_bn_bwd
            for stage, dtype, apply_bn in SHAPES:
                b, c, o, hw = cs.CONV_BN_STAGES[stage]
                g, x, w, mean, rstd, gamma, beta, shift = \
                    cs._conv_bn_inputs(b, c, o, hw, nhwc, dtype, 1)
                act = "relu" if apply_bn else ""
                fa = (x, w, mean, rstd, gamma, beta, shift, act, apply_bn,
                      True)
                z = cb.bn_act_matmul_reference(*fa[:-1], False,
                                               nhwc=nhwc)[0]
                dz = torch.randn(z.shape, generator=g,
                                 device="cuda").to(dtype)
                ds = torch.randn(o, generator=g, device="cuda")
                dss = torch.randn(o, generator=g, device="cuda") * 1e-2
                ba = (x, w, z, dz, ds, dss) + fa[2:]
                row = {var: [] for var in libs}
                for var in list(libs) + list(libs)[::-1]:
                    build.library = (lambda n, var=var, name=name: libs[var]
                                     if n == name else library(n))
                    row[var].append([timer(lambda: kf(*fa)),
                                     timer(lambda: kb(*ba))])
                build.library = library
                xn, _ = cs._conv_bn_prologue(cb, x, mean, rstd, gamma, beta,
                                             apply_bn, nhwc)
                if nhwc:
                    wt = w.t()
                    lib = [timer(lambda: torch.matmul(xn, wt)),
                           timer(lambda: (torch.matmul(dz, w),
                                          torch.matmul(dz.t(), x)))]
                else:
                    from torch.nn.functional import conv2d
                    xn4, w4 = xn.reshape(b, c, hw, 1), w.reshape(o, c, 1, 1)
                    wt, xt = w.t(), x.transpose(1, 2)
                    lib = [timer(lambda: conv2d(xn4, w4)),
                           timer(lambda: (torch.matmul(wt, dz),
                                          torch.matmul(dz, xt).sum(dim=0)))]
                line = {"layout": layout, "shape": stage,
                        "bcoh": [b, c, o, hw],
                        "dtype": str(dtype).replace("torch.", ""),
                        "ms": row, "library_ms": lib}
                if not nhwc:
                    line["l2_bytes"], line["distinct_bytes"] = l2_bytes(
                        b, c, o, hw, dtype, True)
                print(json.dumps(line), flush=True)
                del x, w, z, dz, xn
                torch.cuda.empty_cache()
    finally:
        build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
