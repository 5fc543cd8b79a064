"""Time earlier card paths of ``chip_smoke.py`` in the checkout this runs
from, for a same-call comparison of two commits on one GPU.

    cd <checkout> && python3 <path to>/tools/ab_rungs.py <label>

Imports ``chip_smoke`` from the current directory (so one copy of this
script times any checkout that has ``chip_smoke.py`` with ``_zoo_rung``,
``build_resnet``, ``resnet_feed``, ``started``, ``two_arm_run``,
``train_phase``, ``build_rnn``, ``rnn_feeds`` and ``serve_phase``) and
runs, captured and eager in turns: bench.py's SE-ResNeXt-50 rung under
AMP (5 timed steps), ResNet-50 plain under AMP at batch 128 (5 timed
steps), the Transformer-base float32 step (``train_phase``: 256 x 64,
dropout 0.1, 5 timed steps), machine translation's float32 step (64 x 30,
``RNN_STEPS`` timed steps), and serving's 16 requests (captured:
``serve_phase``'s p50 decode step, prefill and request).  Prints one line
``AB {...}``: each training path's captured and eager median ms and the
captured steps, and the serving percentiles.  Run the parent and the
change in turns (parent, change, change, parent) in one call and compare
the medians against the parent's own spread.
"""

import json
import os
import sys

import numpy as np
import torch


def main():
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import paddle_tpu_torch as pt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else ""}

    def arms(s):
        return [s["captured"]["median_step_ms"],
                s["eager"]["median_step_ms"], s["captured"]["step_ms"]]

    s, _ = cs._zoo_rung("se_resnext50", True, 5)
    out["se_resnext50_amp"] = arms(s)
    main_prog, startup, loss = cs.build_resnet("plain", amp=True)
    rng = np.random.RandomState(0)
    feeds = [cs.resnet_feed(rng, 128) for _ in range(8)]
    s, _, _ = cs.two_arm_run(main_prog, cs.started(startup), [loss], feeds,
                             5, 128)
    out["resnet50_plain_amp"] = arms(s)
    cs.release_memory()
    s, _ = cs.train_phase(pt.CUDAPlace(0))
    out["transformer_f32"] = arms(s)
    cs.release_memory()
    name = "machine_translation"
    main_prog, startup, fetch = cs.build_rnn(name)
    s, _, _ = cs.two_arm_run(main_prog, cs.started(startup), fetch,
                             cs.rnn_feeds(name, cs.RNN_STEPS + 3),
                             cs.RNN_STEPS, cs.RNN[name][0],
                             deterministic=False)
    out["machine_translation_f32"] = arms(s)
    cs.release_memory()
    s = cs.serve_phase(pt.CUDAPlace(0))[0]
    out["serve"] = {k: s[k] for k in ("p50_decode_step_ms", "p50_prefill_ms",
                                      "p50_request_ms")}
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
