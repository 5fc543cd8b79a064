"""CTR DNN, the click-through-rate model (counterpart of
``paddle_tpu/models/ctr_dnn.py``).

Two sparse id paths over large vocabularies:

* the DNN path: embeddings summed per sample, then an MLP tower;
* the LR ("wide") path: one-wide embeddings summed per sample;

concatenated into a 2-class click predictor.  Both tables are
``is_sparse`` (SelectedRows gradients, lazy updates).  ``is_distributed``
builds the same program as the JAX package; on one device the tables
train unsharded, and over a mesh ``DistributeTranspiler``'s plan
row-shards them (``parallel/embedding.py``).
"""

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["ctr_dnn"]


def ctr_dnn(dnn_data, lr_data, label, dnn_dict_size, lr_dict_size,
            embedding_size=16, tower=(128, 128, 128),
            is_distributed=False):
    """Build the CTR model; returns (avg_cost, predict, auc_var).

    ``dnn_data`` / ``lr_data`` are int64 ``lod_level=1`` id sequences;
    ``label`` is the [B, 1] click label."""
    dnn_emb = layers.embedding(
        dnn_data, size=[dnn_dict_size, embedding_size], is_sparse=True,
        is_distributed=is_distributed,
        param_attr=ParamAttr(name="deep_embedding"))
    x = layers.sequence_pool(dnn_emb, pool_type="sum")
    for i, width in enumerate(tower):
        x = layers.fc(x, size=width, act="relu", name="dnn_fc_%d" % i)

    lr_emb = layers.embedding(
        lr_data, size=[lr_dict_size, 1], is_sparse=True,
        is_distributed=is_distributed)
    lr_pool = layers.sequence_pool(lr_emb, pool_type="sum")

    merge = layers.concat([x, lr_pool], axis=1)
    predict = layers.fc(merge, size=2, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    auc_var, _states = layers.auc(input=predict, label=label)
    return avg_cost, predict, auc_var
