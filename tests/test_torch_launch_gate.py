"""``chip_smoke.py``'s launch gate, on the CPU: ``trace_lost`` tells the
kernel records a profiler lost from kernels a serving path did not run,
and ``device_window`` profiles a serving pass again only for the former,
so that ``launch_faults`` still fails a path whose kernels did not run;
a window whose trace holds no device event is profiled again where the
caller allows it and fails the gate if it stays so."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch import profiler  # noqa: E402

NEED = {"flash_attention_fwd": 414, "layer_norm_fwd": 828,
        "dequant_matmul": 2553}


def window(trace, wrapper, events=100):
    return {"trace_launches": dict(trace), "wrapper_launches": dict(wrapper),
            "device_events": events, "pads_traced": profiler.TRACE_PADS}


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


def _empty_then(monkeypatch, events, **kw):
    """``device_window(fn, **kw)`` over windows holding ``events`` device
    events, one per profiled run; returns (the window, the runs of
    ``fn``)."""
    runs = []
    shown = iter(events)

    def profiled(fn):
        fn()
        return window({}, {}, events=next(shown))

    monkeypatch.setattr(cs, "_profiled", profiled)
    out = cs.device_window(lambda: runs.append(1), **kw)
    return out, len(runs)


@pytest.mark.parametrize("kw", [{"again": True},
                                {"lost": lambda w: {}}])
def test_device_window_profiles_an_empty_trace_again(monkeypatch, kw):
    out, runs = _empty_then(monkeypatch, [0, 0, 7], **kw)
    assert runs == 3 and out["empty_windows"] == 2
    assert out["device_events"] == 7
    assert cs.launch_faults(cs.launch_record(True, {}, {}, out, {})) == {}


def test_device_window_left_empty_fails_the_gate(monkeypatch):
    out, runs = _empty_then(monkeypatch, [0] * cs.TRACE_TRIES, again=True)
    assert runs == cs.TRACE_TRIES
    assert out["empty_windows"] == cs.TRACE_TRIES
    assert cs.launch_faults(cs.launch_record(True, {}, {}, out, {})) == {
        "window_trace:device_events": (0, "at least 1")}


def test_device_window_profiles_once_unless_asked(monkeypatch):
    # a training step's window: another run would change the state a
    # later comparison reads, so an empty one is not profiled again
    out, runs = _empty_then(monkeypatch, [0, 7])
    assert runs == 1 and out["empty_windows"] == 1

