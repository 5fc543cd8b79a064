"""A world of ``paddle_tpu_torch`` ranks on the CPU for the mesh runtime's
tests: each rank a ``python tests/test_torch_<x>.py --rank R ...``
subprocess that joins a gloo world through a ``FileStore`` under the
test's tmp dir (no port to race for between parallel test workers), runs
the named cases of its test module and writes each case's arrays to
``<out>/<case>.<rank>.npz``.

The parent (``run_world``) writes each case's inputs first (the JAX
startup state, the batches) to ``<out>/<case>.in.npz``; a case function
``fn(inputs, rank, world)`` returns {name: array}.  A case that raises
records ``__error__`` (the exception's type and message) so a test can
check a refusal on every rank.
"""

import os
import subprocess
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(test_file, world, cases, tmp_path, inputs=None,
              timeout=300):
    """Run ``cases`` (names) of ``test_file`` in a world of ``world``
    ranks; returns {case: [rank 0's arrays, rank 1's, ...]}."""
    procs, out = start_world(test_file, world, cases, tmp_path, inputs)
    return finish_world(procs, out, cases, timeout)[0]


def start_world(test_file, world, cases, tmp_path, inputs=None):
    """Start ``run_world``'s ranks and return (their processes, the output
    directory), for a test that reads a rank's stdout or signals the
    ranks while they run; ``finish_world`` waits for them."""
    out = os.path.join(str(tmp_path), "world%d" % world)
    os.makedirs(out, exist_ok=True)
    for case, arrays in (inputs or {}).items():
        np.savez(os.path.join(out, case + ".in.npz"), **arrays)
    store = os.path.join(out, "store")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, test_file, "--rank", str(r), "--world", str(world),
         "--store", store, "--out", out, "--cases", ",".join(cases)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    return procs, out


def finish_world(procs, out, cases, timeout=300):
    """Wait for ``start_world``'s ranks: ({case: [each rank's arrays]}, as
    ``run_world`` returns; [each rank's stdout not read yet])."""
    stdout = []
    try:
        for r, p in enumerate(procs):
            so, se = p.communicate(timeout=timeout)
            assert p.returncode == 0, "rank %d failed:\n%s\n%s" % (
                r, so[-3000:], se[-6000:])
            stdout.append(so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = {}
    for case in cases:
        results[case] = []
        for r in range(len(procs)):
            with np.load(os.path.join(out, "%s.%d.npz" % (case, r)),
                         allow_pickle=False) as z:
                results[case].append({k: z[k] for k in z.files})
    return results, stdout


def error_of(result):
    """The recorded exception of a case's rank ("" when it ran)."""
    return str(result["__error__"]) if "__error__" in result else ""


def worker(cases):
    """The rank's body: join the world, run the named ``cases`` (a dict
    of case functions), one fresh set of programs each."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--store")
    ap.add_argument("--out")
    ap.add_argument("--cases")
    a = ap.parse_args()
    torch.set_num_threads(1)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, unique_name
    from paddle_tpu_torch.parallel import distributed

    distributed.init_distributed("file://" + a.store, a.world, a.rank,
                                 place=pt.CPUPlace())
    for name in a.cases.split(","):
        path = os.path.join(a.out, name + ".in.npz")
        inputs = {}
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                inputs = {k: z[k] for k in z.files}
        framework.switch_main_program(pt.Program())
        framework.switch_startup_program(pt.Program())
        unique_name.switch()
        pt.compile_cache.clear()
        try:
            with pt.scope_guard(pt.Scope()):
                res = cases[name](inputs, a.rank, a.world)
        except Exception as e:  # noqa: BLE001 — recorded for the test
            res = {"__error__": np.array("%s: %s" % (type(e).__name__, e)),
                   "__trace__": np.array(traceback.format_exc())}
        np.savez(os.path.join(a.out, "%s.%d.npz" % (name, a.rank)),
                 **{k: np.asarray(v) for k, v in res.items()})
        distributed.barrier()
