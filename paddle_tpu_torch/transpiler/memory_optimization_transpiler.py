"""``memory_optimize`` / ``release_memory`` (counterpart of
``paddle_tpu/transpiler/memory_optimization_transpiler.py``).

Neither rewrites the program.  The port's ``Executor`` already frees each
temporary right after its last reader (and a captured step's graph holds
that release), which is the saving the reference's liveness-based variable
reuse buys; so ``memory_optimize`` returns the JAX package's estimate of
the temporaries' bytes and ``release_memory`` returns 0."""

import numpy as np

from ..framework import default_main_program

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program=None, skip_opt_set=None, print_log=False,
                    level=0):
    """The bytes of the program's non-persistable temporaries, 4 a value,
    a dynamic (batch) dim counted as 1 (so the estimate is a sample's);
    the program is left as it is."""
    program = input_program or default_main_program()
    skip = set(skip_opt_set or ())
    total = 0
    for v in program.list_vars():
        if v.persistable or v.name in skip or not v.shape:
            continue
        dims = [d for d in v.shape if d is not None and d > 0]
        if dims:
            total += int(np.prod(dims)) * 4
    if print_log:
        print("memory_optimize: ~%d bytes of temporaries, each freed after "
              "its last reader by the executor (no program rewrite)" % total)
    return total


def release_memory(input_program=None, skip_opt_set=None):
    """Nothing to do: the executor frees temporaries as it runs."""
    return 0
