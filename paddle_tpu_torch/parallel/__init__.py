"""The multi-device runtime (counterpart of ``paddle_tpu/parallel``).

Only the single-process half is ported: ``checkpoint``'s TrainState
checkpoints.  The mesh, the parallel executor, the collectives and the
sharded checkpoints wait for ROADMAP A7 (``torch.distributed``).
"""

from . import checkpoint  # noqa: F401
