"""Kernel #5 at machine translation's loss, [1920, 30000] float32, timed
several ways in one process, to tell the card's time from the host's.

    python3 tools/exp_xent_timer.py [--rounds 3]

Run from the root of a checkout, on one GPU.  Each round times 15 launches
(after 2 warm-up launches) with CUDA events around each, in turns:

- ``flushed``: ``chip_smoke.py``'s ``Timer``: the 256 MB L2 flush before
  every launch, the host free to run ahead;
- ``queued``: as ``flushed``, with a spin kernel of ~60 us after the flush,
  so that the launch is queued before the card reaches it;
- ``synced``: as ``flushed``, with the host waiting for the flush before it
  records the start and calls the wrapper (the whole host path inside);
- ``warm``: no flush, launches back to back;
- ``flush_only``: the flush itself.

It also prints the host microseconds a wrapper call takes to return and
the device time of one call from ``torch.profiler``.  Prints one line
``XENT_TIMER {...}`` with every round's median and each mode's 15
readings of the last round.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

N, C = 64 * 30, 30000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.ops.cuda import softmax_xent as sx

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(C)
    logits = torch.randn((N, C), generator=g, device="cuda") * 2
    label = torch.randint(0, C, (N,), generator=g, device="cuda")

    def call():
        return sx.softmax_xent_fwd(logits, label, 0.0)

    def timed(mode, iters=15):
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            if mode != "warm":
                if mode == "flush_only":
                    start.record()
                flush.zero_()
            if mode == "queued":
                torch.cuda._sleep(100_000)
            elif mode == "synced":
                torch.cuda.synchronize()
            if mode != "flush_only":
                start.record()
                call()
            end.record()
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in events]

    modes = ("flushed", "queued", "synced", "warm", "flush_only")
    rounds, last = [], {}
    for _ in range(args.rounds):
        r = {}
        for mode in modes:
            last[mode] = timed(mode)
            r[mode] = statistics.median(last[mode])
        rounds.append(r)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_ms = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print("XENT_TIMER " + json.dumps({
        "shape": [N, C], "card": torch.cuda.get_device_name(0),
        "rounds": rounds, "last_round": last, "host_us": host_us,
        "device_ms": device_ms}), flush=True)


if __name__ == "__main__":
    main()
