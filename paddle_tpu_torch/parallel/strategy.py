"""Execution and build strategies (counterpart of
``paddle_tpu/parallel/strategy.py``; the reference's
``framework/details/build_strategy.h:55`` and ``execution_strategy.h``).

The reference's BuildStrategy selects how gradients combine across
devices: kAllReduce replicates the optimizer everywhere, kReduce shards
its work per device and broadcasts the parameters.  Here, as in the JAX
package:

* kAllReduce -> parameters and optimizer state replicated; the gradients
  summed over the data axes;
* kReduce    -> parameters and optimizer state dim-0 sharded over the
  mesh's ``fsdp`` axis when it has a populated one, else ``dp``
  (ZeRO-style): gathered before use, their gradients reduce-scattered.

``sharding_rules`` (``spec_layout.SpecLayout``, or True for the default
table) places every persistable var by its parameter class over the
``(dp, fsdp, tp)`` axes; ``param_sharding_fn`` wins over it per var.
``ParallelExecutor`` turns the placement into the collectives of its plan
(``parallel/plan.py``).

``sequence_parallel`` lets ``fused_attention`` lower to ring attention
over a populated ``sp`` axis; ``pipeline_schedule`` (``gpipe``, ``1f1b``
or ``interleaved``; None is ``gpipe``) and ``pipeline_microbatches``
(overriding each region's ``microbatches``) say how ``pipeline_region``
ops run over a populated ``pp`` axis.
"""

__all__ = ["BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0   # scale loss grad by 1/num_devices
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        # kept for the API: the state is updated in place (the JAX
        # package's buffer donation) and nothing is rematerialized
        self.donate_state = True
        self.remat = False
        # sharding-policy hooks: param_sharding_fn(name, shape) ->
        # PartitionSpec or None (None falls through to sharding_rules,
        # then the reduce-strategy rule); feed_sharding_fn(name, shape) ->
        # PartitionSpec or None (None: the batch dim over the data axes)
        self.param_sharding_fn = None
        self.feed_sharding_fn = None
        # declarative model parallelism: a SpecLayout, or True for the
        # default table (spec_layout.py)
        self.sharding_rules = None
        # ring attention over a populated sp axis, and the pipeline
        # schedule and microbatches of pipeline_region ops
        self.sequence_parallel = True
        self.pipeline_schedule = None
        self.pipeline_microbatches = None
        # a global batch the data axes do not divide is replicated whole,
        # r = dp / gcd(B, dp) times, which is exact for mean-normalized
        # losses and batch-norm statistics; False raises instead
        self.pad_uneven_batches = True


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 0              # kept for the API
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100
        self.use_experimental_executor = False
