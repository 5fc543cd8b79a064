"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor any module of the JAX package ``paddle_tpu`` (which shares
its name's prefix)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def _forbidden(module):
    return (module == "jax" or module.startswith("jax.")
            or module == "paddle_tpu" or module.startswith("paddle_tpu."))


def test_import_leaves_jax_and_paddle_tpu_unloaded():
    # a fresh interpreter: this test process has both loaded (conftest)
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.serving, paddle_tpu_torch.ops.cuda\n"
        "import paddle_tpu_torch.io, paddle_tpu_torch.transpiler\n"
        "import paddle_tpu_torch.contrib.mixed_precision\n"
        "import paddle_tpu_torch.contrib.float16\n"
        "import paddle_tpu_torch.reader, paddle_tpu_torch.data_feeder\n"
        "import paddle_tpu_torch.nets\n"
        "import paddle_tpu_torch.contrib.trainer\n"
        "import paddle_tpu_torch.contrib.inferencer\n"
        "import paddle_tpu_torch.models.ctr_dnn, paddle_tpu_torch.clip\n"
        "import paddle_tpu_torch.ops.selected_rows\n"
        "import paddle_tpu_torch.lod_tensor, paddle_tpu_torch.metrics\n"
        "import paddle_tpu_torch.op, paddle_tpu_torch.default_scope_funcs\n"
        "import paddle_tpu_torch.compat, paddle_tpu_torch.annotations\n"
        "import paddle_tpu_torch.models.mnist\n"
        "import paddle_tpu_torch.layers.math_op_patch\n"
        "import paddle_tpu_torch.layers.layer_function_generator\n"
        "import paddle_tpu_torch.parallel.plan\n"
        "import paddle_tpu_torch.parallel.parallel_executor\n"
        "import paddle_tpu_torch.parallel.collective\n"
        "import paddle_tpu_torch.parallel.distributed\n"
        "import paddle_tpu_torch.parallel.embedding\n"
        "import paddle_tpu_torch.parallel.spec_layout\n"
        "import paddle_tpu_torch.parallel.ring_attention\n"
        "import paddle_tpu_torch.parallel.pipeline\n"
        "import paddle_tpu_torch.ops.pipeline_region\n"
        "import paddle_tpu_torch.layers.pipeline\n"
        "import paddle_tpu_torch.transpiler.distribute_transpiler\n"
        "import paddle_tpu_torch.transpiler.ps_dispatcher\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _py_files():
    """Every module of the port, and ``chip_smoke.py``, which drives it on
    the card."""
    yield os.path.join(ROOT, "chip_smoke.py")
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_paddle_tpu_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, "%s imports %s" % (path, bad)
