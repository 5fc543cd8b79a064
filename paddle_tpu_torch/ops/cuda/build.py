"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface,
``paddle_tpu_torch/_build/<name>-<digest>.so`` (or under
``FLAGS_compile_cache_dir``, kept across processes:
``compile_cache.enable_persistent_cache``), loaded with ``ctypes``.
The digest covers the source, the shared headers and the flags, so an
edited kernel never loads a stale library.  Building happens at first use
(or when ``build()`` is called up front); every missing library's
``nvcc`` is started at once and they compile in parallel.  Nothing here
runs at import time: machines without a CUDA toolchain import the package
and run the plain versions on the CPU.
"""

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
# kernel name -> the compiler's output (ptxas registers / shared memory)
build_log = {}
# libraries compiled by this process (the monitor's ``capture_stats``)
build_count = [0]
# kernel name -> seconds from the start of its build until its nvcc ended
build_seconds = {}


def kernel_names():
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of paddle_tpu_torch build only where the CUDA toolkit is "
            "installed")
    return path


def _target(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), "%s-%s.so" % (name, h.hexdigest()[:16]))


def build_dir():
    """Where the libraries are built: the persistent compile-cache
    directory when one is set, else ``BUILD_DIR``."""
    from ... import compile_cache

    return compile_cache.persistent_dir() or BUILD_DIR


def _build_locked(names):
    todo = [(n, _target(n)) for n in names if not os.path.exists(_target(n))]
    if not todo:
        return
    from ...profiler import RecordEvent

    # a build is compile time in the goodput ledger (``cuda/build``)
    with RecordEvent("cuda/build", args={"kernels": [n for n, _ in todo]}):
        _compile(todo)


def _compile(todo):
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name, out in todo:
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp,
                                     os.path.join(CSRC, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))

    def wait(proc):
        text = proc.communicate()[0].decode(errors="replace")
        return text, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        ended = list(pool.map(wait, [p for _, _, _, p in procs]))
    failed = []
    for (name, out, tmp, proc), (text, seconds) in zip(procs, ended):
        build_log[name] = text
        build_seconds[name] = seconds
        if proc.returncode:
            failed.append("nvcc failed on %s.cu:\n%s" % (name, text))
        else:
            os.replace(tmp, out)
            build_count[0] += 1
    if failed:
        raise RuntimeError("\n".join(failed))


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet,
    in parallel; returns {name: library path}."""
    names = kernel_names() if names is None else list(names)
    with _lock:
        _build_locked(names)
    return {n: _target(n) for n in names}


def library(name):
    """The loaded ``ctypes`` library of kernel ``name``, built on first
    use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = _libs[name] = ctypes.CDLL(_target(name))
        return lib


def check(err, what):
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError("%s: CUDA error %d at launch" % (what, err))
