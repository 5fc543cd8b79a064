"""Weight-decay regularizers appended onto gradients (counterpart of
``paddle_tpu/regularizer.py``): ``L1Decay`` and ``L2Decay``, per
parameter (``ParamAttr(regularizer=...)``, which wins) or for a whole
optimizer.  A dense gradient gets ``sum(grad, scale(param))`` (L1: of
``sign(param)``); a SELECTED_ROWS gradient gets ``sparse_weight_decay``,
which decays the touched rows only and keeps the gradient sparse, as the
JAX package does (the dense leg would decay every row)."""

from .core import VarType
from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff})
        return decay


_SPARSE_DECAY_MODES = {L2DecayRegularizer: "l2", L1DecayRegularizer: "l1"}


def _append_sparse_decay(param, grad, block, reg):
    """The SELECTED_ROWS leg: ``sparse_weight_decay`` of the touched
    rows."""
    mode = _SPARSE_DECAY_MODES.get(type(reg))
    if mode is None:
        raise TypeError(
            "regularizer %r has no SelectedRows (sparse-gradient) "
            "lowering; use L1Decay/L2Decay on is_sparse embedding "
            "params, or set is_sparse=False" % type(reg).__name__)
    helper = LayerHelper("sparse_regularized_grad")
    new_grad = helper.create_variable_for_type_inference(dtype=grad.dtype)
    new_grad.type = VarType.SELECTED_ROWS
    block.append_op(type="sparse_weight_decay",
                    inputs={"Grad": [grad], "Param": [param]},
                    outputs={"Out": [new_grad]},
                    attrs={"coeff": reg._regularization_coeff, "mode": mode})
    return new_grad


def append_regularization_ops(parameters_and_grads, regularization=None):
    """The (param, grad) pairs with each parameter's decay term added into
    its gradient."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        reg = param.regularizer if param.regularizer is not None \
            else regularization
        if reg is None:
            params_and_grads.append((param, grad))
            continue
        if getattr(grad, "type", None) == VarType.SELECTED_ROWS:
            params_and_grads.append(
                (param, _append_sparse_decay(param, grad, grad.block, reg)))
            continue
        regularization_term = reg(param, grad, grad.block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        helper = LayerHelper("regularized_grad")
        new_grad = helper.create_variable_for_type_inference(dtype=grad.dtype)
        grad.block.append_op(type="sum",
                             inputs={"X": [grad, regularization_term]},
                             outputs={"Out": [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
