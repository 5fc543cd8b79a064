"""Metric layers (counterpart of ``paddle_tpu/layers/metric_op.py``):
``accuracy``, a ``top_k`` and an ``accuracy`` op as the JAX package
appends them.  ``auc`` waits for ROADMAP Queue A4a and raises."""

from ..layer_helper import LayerHelper

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of ``input`` [N, C] against ``label`` [N, 1]."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    topk_indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype="int32")
    if total is None:
        total = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1):
    raise NotImplementedError(
        "layers.auc: the streaming AUC op is not ported to paddle_tpu_torch "
        "yet (ROADMAP Queue A4a)")
