"""Inference companion to the Trainer (counterpart of
``paddle_tpu/contrib/inferencer.py``): rebuilds the network from
``infer_func`` under a fresh name generator, loads the parameters that
``Trainer.save_params`` wrote, and runs forward steps.  Repeated
``infer`` calls at one batch shape reuse one executor entry (a captured
CUDA graph from the second call on the card).  The place is
``CUDAPlace(0)`` unless the caller passes one.
"""

import os

from .. import io as fluid_io
from .. import unique_name
from ..executor import Executor
from ..framework import Parameter, Program, program_guard
from ..scope import Scope, scope_guard
from .trainer import _default_place

__all__ = ["Inferencer"]


class Inferencer:
    """``infer_func`` builds the forward network and returns the
    prediction Variable (or a list of them); ``param_path`` is a
    directory written by ``Trainer.save_params`` /
    ``io.save_persistables``."""

    def __init__(self, infer_func, param_path, place=None, parallel=False):
        self.param_path = param_path
        self.scope = Scope()
        if parallel:
            raise NotImplementedError(
                "parallel inference is served by the mesh ParallelExecutor "
                "(paddle_tpu_torch.parallel); pass the program to it "
                "directly")
        self.place = _default_place(place)

        if not os.path.isdir(param_path):
            raise ValueError("param_path %r is not a directory" % param_path)

        self.startup_program = Program()
        self.inference_program = Program()
        # a fresh name generator: the rebuilt net gets the parameter names
        # the Trainer saved, whatever this process built before
        with unique_name.guard():
            with program_guard(self.inference_program, self.startup_program):
                outs = infer_func()
                self.predict_vars = outs if isinstance(outs, list) else [outs]

        with scope_guard(self.scope):
            self.exe = Executor(self.place)
            self.exe.run(self.startup_program)
            fluid_io.load_params(self.exe, param_path,
                                 main_program=self.inference_program)
        missing = [
            v.name for v in self.inference_program.list_vars()
            if isinstance(v, Parameter) and not os.path.exists(
                os.path.join(param_path, v.name + ".npy"))]
        if missing:
            raise RuntimeError(
                "param_path %r has no saved tensor for parameter(s) %s — "
                "was the model saved with Trainer.save_params/io.save_params "
                "(per-var layout, no filename=) from the same network "
                "definition?" % (param_path, missing))

    def infer(self, inputs, return_numpy=True):
        """One forward pass; ``inputs`` maps var names to arrays."""
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        with scope_guard(self.scope):
            return self.exe.run(
                self.inference_program, feed=inputs,
                fetch_list=[v.name for v in self.predict_vars],
                return_numpy=return_numpy)
