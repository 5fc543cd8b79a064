"""How far bf16 inference moves an untrained ResNet-50's softmax, in the JAX
package and in the port, on the CPU.

Each package builds bench.py's ResNet-50 inference program (``is_test``,
1000 classes) at ``--size`` pixels; the JAX package runs its startup
program and the port takes that state (``convert.load_numpy_state``), so
both start from the same weights; each then sets every batch norm's
running statistics to one batch's (``chip_smoke.py``'s
``calibrate_batch_norms``), then runs the float32 program and the program
after its ``Bfloat16Transpiler`` on that batch.  It prints the float32
softmax's largest value, the relative L1 distance of the two softmaxes,
the images whose top class agrees, and the distance between two images'
float32 softmaxes.
At the initial statistics (mean 0, variance 1) the softmax saturates to
exact 0s and 1s and the distance reads 0, which is why the statistics are
calibrated first.

    JAX_PLATFORMS=cpu python tools/resnet50_bf16_drift.py [--size 112]
        [--batch 4]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import calibrate_batch_norms  # noqa: E402


def _drift(pkg, resnet, bf16, size, feed, state=None):
    """(the readings, the startup state as numpy)."""
    def build():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed, startup.random_seed = 2, 1
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            img = pkg.layers.data("img", shape=[3, size, size])
            pred = resnet.resnet_imagenet(img, class_dim=1000, depth=50,
                                          is_test=True)
        return main, startup, pred

    main, startup, pred = build()
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    if state is None:
        exe.run(startup, scope=scope)
        state = {v.name: np.array(scope.find_var(v.name), copy=True)
                 for v in startup.list_vars() if v.persistable}
    else:
        from paddle_tpu_torch.convert import load_numpy_state

        load_numpy_state(scope, startup, state, "cpu")
    calibrate_batch_norms(exe, main, scope, feed)
    f32 = np.asarray(exe.run(main, feed=feed, fetch_list=[pred],
                             scope=scope)[0], np.float64)
    main16, _, pred16 = build()
    bf16.Bfloat16Transpiler().transpile(main16, pkg.CPUPlace(), scope=scope,
                                        fetch_targets=[pred16])
    b16 = np.asarray(exe.run(main16, feed=feed, fetch_list=[pred16.name],
                             scope=scope)[0], np.float64)
    return {"float32_softmax_max": float(f32.max()),
            "bf16_rel_l1": float(np.abs(b16 - f32).sum()
                                 / np.abs(f32).sum()),
            "top1_agree": int((b16.argmax(1) == f32.argmax(1)).sum()),
            # two images' float32 softmaxes: what an answer to another
            # image would read
            "other_image_rel_l1": float(
                np.abs(np.roll(f32, 1, axis=0) - f32).sum()
                / np.abs(f32).sum()),
            "images": int(f32.shape[0])}, state


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=112)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    feed = {"img": np.random.RandomState(0).rand(
        args.batch, 3, args.size, args.size).astype("float32")}

    import paddle_tpu as fluid
    from paddle_tpu.contrib import float16 as j_bf16
    from paddle_tpu.models import resnet as j_resnet

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import float16 as p_bf16
    from paddle_tpu_torch.models import resnet as p_resnet

    state = None
    for name, pkg, resnet, bf16 in (("jax", fluid, j_resnet, j_bf16),
                                    ("torch", pt, p_resnet, p_bf16)):
        res, state = _drift(pkg, resnet, bf16, args.size, feed, state)
        print(name, res, flush=True)


if __name__ == "__main__":
    main()
