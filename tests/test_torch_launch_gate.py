"""``chip_smoke.py``'s launch gate, on the CPU: ``trace_lost`` tells the
kernel records a profiler lost from kernels a serving path did not run,
and ``device_window`` profiles a serving pass again only for the former,
so that ``launch_faults`` still fails a path whose kernels did not run."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

NEED = {"flash_attention_fwd": 414, "layer_norm_fwd": 828,
        "dequant_matmul": 2553}


def window(trace, wrapper):
    return {"trace_launches": dict(trace), "wrapper_launches": dict(wrapper)}


@pytest.mark.parametrize("captured, trace, wrapper, want", [
    # eager: every launch made from the host, the trace short of them
    (False, dict(NEED, layer_norm_fwd=825), NEED,
     {"layer_norm_fwd": (825, 828)}),
    # eager: the host launched fewer than implied: a fault, not a loss
    (False, dict(NEED, dequant_matmul=2546),
     dict(NEED, dequant_matmul=2546), {}),
    # captured: replays run the kernels, the wrappers none
    (True, dict(NEED, flash_attention_fwd=409), {},
     {"flash_attention_fwd": (409, 414)}),
    # captured, but a dispatch ran eagerly: a fault, not a loss
    (True, dict(NEED, flash_attention_fwd=409),
     {"flash_attention_fwd": 6}, {}),
    # more launches than implied are never a loss
    (False, dict(NEED, layer_norm_fwd=830), NEED, {}),
    (True, NEED, {}, {}),
])
def test_trace_lost_names_only_lost_records(captured, trace, wrapper, want):
    assert cs.trace_lost(window(trace, wrapper), NEED, captured) == want


def _windows(monkeypatch, traces):
    """``device_window`` over eager windows whose traces are ``traces``,
    one per profiled run; returns (the window, the runs of ``fn``)."""
    runs = []
    shown = iter(traces)

    def profiled(fn):
        fn()
        return window(next(shown), NEED)

    monkeypatch.setattr(cs, "_profiled", profiled)
    out = cs.device_window(lambda: runs.append(1),
                           lambda w: cs.trace_lost(w, NEED, False))
    return out, len(runs)


def test_device_window_profiles_again_after_a_loss(monkeypatch):
    short = dict(NEED, flash_attention_fwd=413)
    out, runs = _windows(monkeypatch, [short, NEED])
    assert runs == 2
    assert out["trace_launches"] == NEED
    assert out["trace_losses"] == [{"flash_attention_fwd": (413, 414)}]
    rec = cs.launch_record(False, NEED, NEED, out, NEED)
    assert cs.launch_faults(rec) == {}


def test_device_window_gives_up_and_the_gate_fails(monkeypatch):
    short = dict(NEED, layer_norm_fwd=820)
    out, runs = _windows(monkeypatch, [short] * (cs.TRACE_TRIES + 1))
    assert runs == cs.TRACE_TRIES
    assert len(out["trace_losses"]) == cs.TRACE_TRIES
    rec = cs.launch_record(False, NEED, NEED, out, NEED)
    assert cs.launch_faults(rec) == {
        "window_trace:layer_norm_fwd": (820, 828)}


def test_device_window_without_a_loss_test_profiles_once(monkeypatch):
    runs = []

    def profiled(fn):
        fn()
        return window(dict(NEED, layer_norm_fwd=1), NEED)

    monkeypatch.setattr(cs, "_profiled", profiled)
    out = cs.device_window(lambda: runs.append(1))
    assert len(runs) == 1 and out["trace_losses"] == []
