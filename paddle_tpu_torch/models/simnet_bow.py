"""SimNet-BOW, a pairwise text-similarity ranker (counterpart of
``paddle_tpu/models/simnet_bow.py``).

Query and title towers share one embedding table (``is_sparse``, the
SelectedRows gradient path); each tower sum-pools its word embeddings
and projects through a shared fc; the score is the cosine similarity.
Training ranks a positive title above a negative one with
``margin_rank_loss``.
"""

from .. import layers
from ..param_attr import ParamAttr


def _tower(ids, dict_size, emb_dim, hid_dim):
    emb = layers.embedding(ids, size=[dict_size, emb_dim], is_sparse=True,
                           param_attr=ParamAttr(name="simnet_emb"))
    pool = layers.sequence_pool(emb, pool_type="sum")
    return layers.fc(pool, size=hid_dim, act="softsign",
                     param_attr=ParamAttr(name="simnet_fc_w"),
                     bias_attr=ParamAttr(name="simnet_fc_b"))


def simnet_bow(query, pos_title, neg_title, dict_size, emb_dim=128,
               hid_dim=128, margin=0.1):
    """Returns (avg_cost, pos_score, neg_score).  All three inputs are
    int64 ``lod_level=1`` word-id sequences; the towers share every
    parameter (twin-tower weight tying, as the reference builds it)."""
    q = _tower(query, dict_size, emb_dim, hid_dim)
    pt = _tower(pos_title, dict_size, emb_dim, hid_dim)
    nt = _tower(neg_title, dict_size, emb_dim, hid_dim)
    pos_score = layers.cos_sim(q, pt)
    neg_score = layers.cos_sim(q, nt)
    label = layers.fill_constant_batch_size_like(
        input=pos_score, shape=[-1, 1], dtype="float32", value=1.0)
    loss = layers.margin_rank_loss(label, pos_score, neg_score,
                                   margin=margin)
    return layers.mean(loss), pos_score, neg_score
