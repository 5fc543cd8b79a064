"""Automatic mixed precision in bfloat16 (counterpart of
``paddle_tpu/contrib/mixed_precision.py``).

The policy is applied as each op runs, not by rewriting the program:
``registry.compute_op`` hands an op's gathered inputs to
``AMPPolicy.cast_inputs`` before the compute.  Ops on the white list (the
matmuls and convolutions, and ``fused_attention``) get their float32
inputs cast to bfloat16; ops on the black list (losses, reductions,
softmax, the optimizer updates and the gradient ``sum``) get their
bfloat16 inputs cast to float32; every other op computes in whatever its
inputs promote to.  A ``<type>_grad`` op takes its forward op's colour,
so the generic grad's recompute runs in the forward's dtype and its
autograd leaves are the cast tensors: a white op's gradient with respect
to a float32 parameter comes back in bfloat16, and the black-listed
optimizer op casts it up to update the float32 master weight in the
scope.

bfloat16 keeps float32's exponent range, so there is no loss scaling:
``decorate`` accepts ``init_loss_scaling`` and
``use_dynamic_loss_scaling`` and ignores them, as the JAX package does.
"""

import torch

__all__ = ["AutoMixedPrecisionLists", "AMPPolicy", "decorate",
           "bf16_program_guard", "cast_parameters_to_bf16"]


class AutoMixedPrecisionLists:
    """The white and black op lists (the JAX package's, copied)."""

    # matmul-bound: float32 inputs are cast to bfloat16
    WHITE = {
        "matmul", "mul", "conv2d", "conv3d", "depthwise_conv2d",
        "conv2d_transpose", "bilinear_tensor_product", "fused_attention",
    }
    # numerically sensitive: bfloat16 inputs are cast to float32.
    # batch_norm and layer_norm are not here: they keep their statistics
    # in float32 and pass the activation through in its own dtype
    BLACK = {
        "softmax_with_cross_entropy", "cross_entropy", "mean",
        "reduce_sum", "reduce_mean",
        "group_norm", "lrn", "norm", "exp", "log", "softmax",
        "log_softmax", "sigmoid_cross_entropy_with_logits",
        # the optimizer updates read and write float32 master weights
        "sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
        "rmsprop", "ftrl", "decayed_adagrad", "proximal_gd",
        "proximal_adagrad", "sum", "clip_by_norm", "squared_l2_norm",
        "isfinite",
    }

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = (set(self.WHITE) | set(custom_white_list or ())) \
            - set(custom_black_list or ())
        self.black_list = (set(self.BLACK) | set(custom_black_list or ())) \
            - set(custom_white_list or ())


class AMPPolicy:
    """The dtype policy ``registry.compute_op`` consults for every op.
    Policies with the same lists are equal: the executor keys its entries
    on the policy, so every ``bf16_program_guard`` of a program, each with
    a policy of its own, shares one entry (and one captured graph)."""

    def __init__(self, amp_lists=None):
        self.lists = amp_lists or AutoMixedPrecisionLists()

    def _key(self):
        return (frozenset(self.lists.white_list),
                frozenset(self.lists.black_list))

    def __eq__(self, other):
        return isinstance(other, AMPPolicy) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        # stable across processes: the program fingerprint hashes it
        return "AMPPolicy(white=%s, black=%s)" % (
            sorted(self.lists.white_list), sorted(self.lists.black_list))

    def cast_inputs(self, op_type, ins):
        """``ins`` with float32 <-> bfloat16 casts applied as the lists
        say; a ``<type>_grad`` op follows ``<type>``."""
        base = op_type[:-5] if op_type.endswith("_grad") else op_type
        if base in self.lists.white_list:
            target, source = torch.bfloat16, torch.float32
        elif base in self.lists.black_list:
            target, source = torch.float32, torch.bfloat16
        else:
            return ins
        return {slot: [v.to(target) if isinstance(v, torch.Tensor)
                       and v.dtype == source else v for v in vals]
                for slot, vals in ins.items()}


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             use_dynamic_loss_scaling=False):
    """Wrap ``optimizer`` so that ``minimize(loss)`` marks the loss's
    program for bfloat16 mixed precision.  The loss-scaling arguments are
    accepted and ignored."""

    class _AMPOptimizer:
        def __init__(self, inner):
            self._inner = inner
            self._amp_policy = AMPPolicy(amp_lists)

        def minimize(self, loss, startup_program=None, **kw):
            result = self._inner.minimize(
                loss, startup_program=startup_program, **kw)
            loss.block.program._amp_policy = self._amp_policy
            return result

        def __getattr__(self, name):
            return getattr(self._inner, name)

    return _AMPOptimizer(optimizer)


class bf16_program_guard:
    """Mark ``program`` for bfloat16 mixed precision inside the block, and
    restore its earlier policy after it."""

    def __init__(self, program, amp_lists=None):
        self.program = program
        self.policy = AMPPolicy(amp_lists)
        self._prior = None

    def __enter__(self):
        self._prior = self.program._amp_policy
        self.program._amp_policy = self.policy
        return self.program

    def __exit__(self, *exc):
        self.program._amp_policy = self._prior
        return False


def cast_parameters_to_bf16(program, scope):
    """Cast every float32 persistable of ``program``'s global block that
    ``scope`` holds to bfloat16, in place in the scope."""
    for var in program.global_block().vars.values():
        if not var.persistable:
            continue
        val = scope.find_var(var.name)
        if val is None:
            continue
        if not isinstance(val, torch.Tensor):
            val = torch.as_tensor(val)
        if val.dtype == torch.float32:
            scope.set_var(var.name, val.to(torch.bfloat16))
