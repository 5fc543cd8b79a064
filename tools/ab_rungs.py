"""Time two earlier card paths of ``chip_smoke.py`` in the checkout this
runs from, for a same-call comparison of two commits on one GPU.

    cd <checkout> && python3 <path to>/tools/ab_rungs.py <label>

Imports ``chip_smoke`` from the current directory (so one copy of this
script times any checkout that has ``chip_smoke.py`` with ``_zoo_rung``,
``build_resnet``, ``resnet_feed``, ``started`` and ``two_arm_run``) and
runs, captured and eager in turns: bench.py's SE-ResNeXt-50 rung under
AMP (5 timed steps) and ResNet-50 plain under AMP at batch 128 (5 timed
steps).  Prints one line ``AB {...}``: each path's captured and eager
median ms and the captured steps.  Run the parent and the change in
turns (parent, change, change, parent) in one call and compare the
medians against the parent's own spread.
"""

import json
import os
import sys

import numpy as np
import torch


def main():
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else ""}
    s, _ = cs._zoo_rung("se_resnext50", True, 5)
    out["se_resnext50_amp"] = [s["captured"]["median_step_ms"],
                               s["eager"]["median_step_ms"],
                               s["captured"]["step_ms"]]
    main_prog, startup, loss = cs.build_resnet("plain", amp=True)
    rng = np.random.RandomState(0)
    feeds = [cs.resnet_feed(rng, 128) for _ in range(8)]
    s, _, _ = cs.two_arm_run(main_prog, cs.started(startup), [loss], feeds,
                             5, 128)
    out["resnet50_plain_amp"] = [s["captured"]["median_step_ms"],
                                 s["eager"]["median_step_ms"],
                                 s["captured"]["step_ms"]]
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
