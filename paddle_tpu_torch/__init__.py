"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``, for an
NVIDIA H100.

The layout mirrors the JAX package (``framework``, ``registry``,
``backward``, ``optimizer``, ``executor``, ``io``, ``layers``, ``ops``,
``nets``, ``models``, ``reader``, ``data_feeder``, ``serving``,
``transpiler``, ``inference``, ``debugger``, ``net_drawer``, ``contrib``)
so each module's
counterpart is easy to find; the programs it builds serialize to the
same schema, and ``io`` writes the JAX package's file format.  Op
computes are plain functions on tensors; the hand-written Hopper kernels
live in ``ops/cuda`` (sources in ``csrc/``), each beside its plain
PyTorch version, which runs only for tensors on the CPU.

This package imports neither JAX nor any module of ``paddle_tpu``.
Entry points run on the card (``CUDAPlace(0)``) unless the caller passes
``CPUPlace()``.
"""

from . import core, unique_name
from .framework import (Block, Operator, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        program_guard)
from . import ops  # registers the op computes
from . import layers
from . import initializer
from .executor import CPUPlace, CUDAPlace, Executor
from .scope import Scope, global_scope, scope_guard
from .param_attr import ParamAttr
from . import backward, clip, optimizer, regularizer
from . import average, learning_rate_decay
from . import convert
from . import io
from . import nets
from . import reader
from .data_feeder import DataFeeder
from .reader import batch
from . import models
from . import transpiler
from .transpiler import InferenceTranspiler, memory_optimize, release_memory
from . import serving
from . import contrib
from . import inference
from . import debugger
from . import net_drawer

__version__ = "0.1.0"

__all__ = [
    "core", "unique_name", "Program", "Block", "Operator", "Variable",
    "Parameter", "default_main_program", "default_startup_program",
    "program_guard", "ops", "layers", "initializer", "Executor", "CPUPlace",
    "CUDAPlace", "Scope", "global_scope", "scope_guard", "ParamAttr",
    "backward", "clip", "optimizer", "regularizer", "average",
    "learning_rate_decay", "convert", "io",
    "nets", "reader", "DataFeeder", "batch", "models", "transpiler",
    "InferenceTranspiler", "memory_optimize", "release_memory", "serving",
    "contrib", "inference", "debugger", "net_drawer",
]
