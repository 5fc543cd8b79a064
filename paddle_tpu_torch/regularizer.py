"""Weight-decay hook of the optimizer (counterpart of
``paddle_tpu/regularizer.py``), on the path with no regularizer: the
``L1Decay``/``L2Decay`` classes are not ported yet, so a regularizer raises
instead of being dropped."""

__all__ = ["append_regularization_ops"]


def append_regularization_ops(parameters_and_grads, regularization=None):
    """The (param, grad) pairs unchanged: neither ``regularization`` nor a
    parameter's own regularizer may be set."""
    for param, grad in parameters_and_grads:
        if grad is None:
            continue
        if regularization is not None or param.regularizer is not None:
            raise NotImplementedError(
                "regularizer on %r: weight decay is not ported to "
                "paddle_tpu_torch yet (ROADMAP Queue A)" % param.name)
    return list(parameters_and_grads)
