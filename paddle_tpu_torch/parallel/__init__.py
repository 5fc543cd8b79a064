"""The mesh runtime (counterpart of ``paddle_tpu/parallel``): the
reference's multi-device stack (ParallelExecutor, the NCCL op handles,
DistributeTranspiler) on ``torch.distributed``, one process a device.

* ``mesh``: the named mesh (``make_mesh``, ``PartitionSpec``), a plain
  description a process reads without a world, whose process groups are
  made once a world exists;
* ``distributed``: ``init_distributed`` (NCCL on the card, gloo on the CPU
  when asked), the world's rank and size, ``barrier`` and the preemption
  vote ``any_process_flagged``;
* ``strategy``, ``spec_layout``: where each var lives (the JAX package's
  ``BuildStrategy`` and ``SpecLayout``, copied);
* ``plan``, ``collective``: the rank's copy of a program with its
  collectives, and the collective ops;
* ``parallel_executor``: ``ParallelExecutor``, which runs the plan;
* ``embedding``: row-sharded embedding tables;
* ``checkpoint``: TrainState checkpoints, full (a ``ParallelExecutor``'s
  state gathered to one writer) or sharded (each rank writing the blocks
  it owns), and ``save_sharded`` / ``load_sharded`` /
  ``ShardedCheckpointManager`` over the sharded format;
* ``ring_attention``: sequence parallelism over ``sp`` (``ring_attention``,
  ``ring_attention_shard``);
* ``pipeline``: pipeline schedules over ``pp`` (``pipeline``,
  ``schedule_stats``, ``SCHEDULES``).

The cluster runtime and the fleet are ROADMAP A7c (part 2).
"""

from . import checkpoint  # noqa: F401
from . import distributed  # noqa: F401
from .embedding import distributed_embedding_sharding_fn  # noqa: F401
from .mesh import Mesh, PartitionSpec, make_mesh  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401
from .pipeline import SCHEDULES, pipeline, schedule_stats  # noqa: F401
from .ring_attention import ring_attention, ring_attention_shard  # noqa
from .spec_layout import SpecLayout  # noqa: F401
from .strategy import BuildStrategy, ExecutionStrategy  # noqa: F401
