"""Where kernels #10/#11 (``paddle_tpu_torch/csrc/conv_bn_nhwc.cu``) spend
their time on the card.

Builds variants of the kernel source with stages of the main loop switched
off and times each through the op's wrappers (``conv_bn_fwd_nhwc``,
``conv_bn_bwd_nhwc``) with ``chip_smoke.py``'s timer (CUDA events, L2
flushed before each launch), at ResNet-50's NHWC shapes.  A variant's
output is wrong; only its time is read.

  full          the kernel as it is
  no_wgmma      the main loop issues no wgmma
  no_transform  no transform step (the swizzled tiles keep stale data)
  no_loads      no raw tile is copied in
  loads_only    neither wgmma nor transform
  skeleton      none of the three: launch, barriers and epilogue

Run from the repo root on a machine with an H100 and nvcc:

    python3 tools/exp_conv_bn_nhwc.py

Prints the card's name and power limit, then one JSON line a shape:
{variant: [forward ms, backward ms], ...} with every variant timed twice,
in turns (the list, then the list reversed), and the library calls'
times (``torch.matmul`` on operands prepared beforehand).
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

# statements of the main loop, each switched off by guarding it with if (0)
STAGES = {
    "wgmma": ["    mma<T>(sm + (t & 1) * OPB, acc);\n"],
    "transform": ["  xform(0);\n", "      xform(t + 1);\n"],
    "loads": ["    if (t < nt) {\n"],
}
VARIANTS = {"full": (), "no_wgmma": ("wgmma",),
            "no_transform": ("transform",), "no_loads": ("loads",),
            "loads_only": ("wgmma", "transform"),
            "skeleton": ("wgmma", "transform", "loads")}
SHAPES = (("stage3", torch.float32, True), ("stage3", torch.bfloat16, True),
          ("stage1", torch.float32, False), ("stage4", torch.float32, True))


def variant_source(src, off):
    for stage in off:
        for stmt in STAGES[stage]:
            if src.count(stmt) != 1:
                raise RuntimeError("the kernel source changed: %r" % stmt)
            indent = stmt[:len(stmt) - len(stmt.lstrip())]
            if stmt.rstrip().endswith("{"):
                guarded = indent + "if (0) {\n"
            else:
                guarded = indent + "if (0) " + stmt.lstrip()
            src = src.replace(stmt, guarded)
    return src


def build_variants():
    with open(os.path.join(build.CSRC, "conv_bn_nhwc.cu")) as f:
        src = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "exp_conv_bn_nhwc")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, off in VARIANTS.items():
        cu, so = (os.path.join(out_dir, name + ext) for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(variant_source(src, off))
        procs[name] = (so, subprocess.Popen(
            [build._nvcc()] + build.NVCC_FLAGS + ["-I", build.CSRC, "-o", so,
                                                  cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log[-3000:]))
        libs[name] = ctypes.CDLL(so)
    return libs


def main():
    if not torch.cuda.is_available():
        print("exp_conv_bn_nhwc: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    libs = build_variants()
    library, timer = build.library, cs.Timer()
    try:
        for stage, dtype, apply_bn in SHAPES:
            b, c, o, hw = cs.CONV_BN_STAGES[stage]
            g, x, w, mean, rstd, gamma, beta, shift = cs._conv_bn_inputs(
                b, c, o, hw, True, dtype, 1)
            act = "relu" if apply_bn else ""
            fa = (x, w, mean, rstd, gamma, beta, shift, act, apply_bn, True)
            z = cb.bn_act_matmul_reference(*fa[:-1], False, nhwc=True)[0]
            dz = torch.randn(z.shape, generator=g, device="cuda").to(dtype)
            ds = torch.randn(o, generator=g, device="cuda")
            dss = torch.randn(o, generator=g, device="cuda") * 1e-2
            ba = (x, w, z, dz, ds, dss) + fa[2:]
            row = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                build.library = (lambda n, name=name: libs[name]
                                 if n == "conv_bn_nhwc" else library(n))
                row[name].append([timer(lambda: cb.conv_bn_fwd_nhwc(*fa)),
                                  timer(lambda: cb.conv_bn_bwd_nhwc(*ba))])
            build.library = library
            xn = cb._act_norm(x, mean, rstd, gamma, beta, act, apply_bn,
                              (1, -1)).to(dtype)
            wt = w.t()
            lib = [timer(lambda: torch.matmul(xn, wt)),
                   timer(lambda: (torch.matmul(dz, w),
                                  torch.matmul(dz.t(), x)))]
            print(json.dumps({"shape": stage, "bcoh": [b, c, o, hw],
                              "dtype": str(dtype).replace("torch.", ""),
                              "ms": row, "library_ms": lib}), flush=True)
            del x, w, z, dz, xn
            torch.cuda.empty_cache()
    finally:
        build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
