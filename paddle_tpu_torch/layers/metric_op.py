"""Metric layers (counterpart of ``paddle_tpu/layers/metric_op.py``):
``accuracy``, a ``top_k`` and an ``accuracy`` op as the JAX package
appends them, and ``auc``, the streaming AUC over persistable histograms
(``<name>.stat_pos`` / ``<name>.stat_neg``)."""

from ..initializer import ConstantInitializer
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
    """Streaming AUC of ``input`` [N, 2] (the positive class's probability)
    against ``label`` [N, 1]: (the AUC so far, (stat_pos, stat_neg)), the
    histograms int64 and persistable, the AUC float64."""
    helper = LayerHelper("auc")
    bins = num_thresholds + 1
    stat_pos = helper.create_global_variable(
        name=helper.name + ".stat_pos", persistable=True, shape=[bins],
        dtype="int64")
    stat_neg = helper.create_global_variable(
        name=helper.name + ".stat_neg", persistable=True, shape=[bins],
        dtype="int64")
    for var in [stat_pos, stat_neg]:
        helper.set_variable_initializer(var, ConstantInitializer(0))
    auc_out = helper.create_variable_for_type_inference(dtype="float64")
    # unused, but declared by the JAX builder and so part of the program
    pos_out = helper.create_variable_for_type_inference(dtype="int64")
    neg_out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, (stat_pos, stat_neg)
