"""The recurrent ops ``lstm``, ``lstmp``, ``gru``, ``lstm_unit`` and
``gru_unit`` (counterpart of ``paddle_tpu/ops/rnn.py``).

The JAX package writes each sequence op as one ``lax.scan`` over the time
axis of the padded batch and has no Pallas kernel for it; the port writes
the same recurrence as a Python loop of plain torch over the steps (on the
card the loop is unrolled into the step's CUDA graph).  A row whose length
is at most t keeps its carry at step t and emits zeros.

Layouts are the JAX package's: an LSTM's pre-projected input is
[B, T, 4H] with gate order (c, i, f, o), its recurrent weight [H, 4H] and
its bias [1, 4H], or [1, 7H] with the peephole weights (i, f, o) after the
gate biases; a GRU's input is [B, T, 3H] with (u, r, c), its weight
[H, 3H].  The recurrence computes in its input's dtype: under AMP the
float32 weight is cast to a bfloat16 input's dtype.

The sequence ops are ``keep_graph`` (``registry``): the generic grad pulls
back through the forward's autograd graph rather than running the T steps
again.
"""

import torch

from ..registry import in_var, register_op, set_output

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda v: v,
}


def _steps(t, reverse):
    return reversed(range(t)) if reverse else range(t)


def _peepholes(bias, h, use_peep, dt):
    """The gate bias [4H] and, with peepholes, (w_ic, w_fc, w_oc), each
    [H], in dtype ``dt``."""
    gb = bias[..., :4 * h].reshape(4 * h).to(dt)
    if not use_peep:
        return gb, None
    return gb, tuple(bias[..., k * h:(k + 1) * h].reshape(h).to(dt)
                     for k in (4, 5, 6))


def _lstm_cell(gates, c_prev, peep, gate_act, cell_act, cand_act):
    """One LSTM step from its gate pre-activations: (hidden, cell)."""
    gc, gi, gf, go = torch.chunk(gates, 4, dim=-1)
    if peep is not None:
        w_ic, w_fc, w_oc = peep
        i = gate_act(gi + c_prev * w_ic)
        f = gate_act(gf + c_prev * w_fc)
    else:
        i, f = gate_act(gi), gate_act(gf)
    c = f * c_prev + i * cand_act(gc)
    o = gate_act(go + c * w_oc) if peep is not None else gate_act(go)
    return o * cell_act(c), c


def _acts(attrs):
    return (_ACT[attrs.get("gate_activation", "sigmoid")],
            _ACT[attrs.get("cell_activation", "tanh")],
            _ACT[attrs.get("candidate_activation", "tanh")])


def _lstm_infer(op, block):
    x = in_var(op, block, "Input")     # [B, T, 4H]
    h = x.shape[2] // 4
    set_output(op, block, "Hidden", (x.shape[0], x.shape[1], h), x.dtype)
    set_output(op, block, "Cell", (x.shape[0], x.shape[1], h), x.dtype)


def _lstm_compute(ins, attrs, ctx, op_index):
    x = ins["Input"][0]                      # [B, T, 4H] (x @ W_x + b_x)
    bias = ins["Bias"][0]                    # [1, 4H] or [1, 7H]
    length = ins["Length"][0]
    h0 = (ins.get("H0") or [None])[0]
    c0 = (ins.get("C0") or [None])[0]
    b, t, h4 = x.shape
    h = h4 // 4
    dt = x.dtype
    use_peep = attrs.get("use_peepholes", True) and bias.shape[-1] == 7 * h
    acts = _acts(attrs)
    w = ins["Weight"][0].to(dt)              # [H, 4H] recurrent
    gb, peep = _peepholes(bias, h, use_peep, dt)
    h_prev = h0.to(dt) if h0 is not None else x.new_zeros((b, h))
    c_prev = c0.to(dt) if c0 is not None else x.new_zeros((b, h))
    hs, cs = [None] * t, [None] * t
    for step in _steps(t, attrs.get("is_reverse", False)):
        gates = (x[:, step] + h_prev @ w + gb).to(dt)
        hh, c = _lstm_cell(gates, c_prev, peep, *acts)
        valid = (length > step)[:, None]
        c = torch.where(valid, c, c_prev)
        hs[step] = torch.where(valid, hh, 0)
        cs[step] = torch.where(valid, c, 0)
        h_prev = torch.where(valid, hh, h_prev)
        c_prev = c
    return {"Hidden": torch.stack(hs, dim=1), "Cell": torch.stack(cs, dim=1)}


register_op(
    "lstm", ["Input", "Weight", "Bias", "Length", "H0", "C0"],
    ["Hidden", "Cell"], infer=_lstm_infer, compute=_lstm_compute,
    no_grad_inputs=("Length",), keep_graph=True)


def _lstmp_infer(op, block):
    x = in_var(op, block, "Input")
    p = in_var(op, block, "ProjWeight").shape[1]   # [H, P]
    h = x.shape[2] // 4
    set_output(op, block, "Projection", (x.shape[0], x.shape[1], p), x.dtype)
    set_output(op, block, "Cell", (x.shape[0], x.shape[1], h), x.dtype)


def _lstmp_compute(ins, attrs, ctx, op_index):
    """An LSTM whose recurrent state is the projection
    r = proj_act(h @ ProjWeight) [B, P]; Weight is [P, 4H]."""
    x = ins["Input"][0]
    bias = ins["Bias"][0]
    length = ins["Length"][0]
    b, t, h4 = x.shape
    h = h4 // 4
    dt = x.dtype
    w = ins["Weight"][0].to(dt)
    w_proj = ins["ProjWeight"][0].to(dt)
    p = w_proj.shape[1]
    use_peep = attrs.get("use_peepholes", True) and bias.shape[-1] == 7 * h
    acts = _acts(attrs)
    proj_act = _ACT[attrs.get("proj_activation", "tanh")]
    gb, peep = _peepholes(bias, h, use_peep, dt)
    r_prev, c_prev = x.new_zeros((b, p)), x.new_zeros((b, h))
    rs, cs = [None] * t, [None] * t
    for step in _steps(t, attrs.get("is_reverse", False)):
        gates = (x[:, step] + r_prev @ w + gb).to(dt)
        hh, c = _lstm_cell(gates, c_prev, peep, *acts)
        r = proj_act(hh @ w_proj)
        valid = (length > step)[:, None]
        c = torch.where(valid, c, c_prev)
        rs[step] = torch.where(valid, r, 0)
        cs[step] = torch.where(valid, c, 0)
        r_prev = torch.where(valid, r, r_prev)
        c_prev = c
    return {"Projection": torch.stack(rs, dim=1),
            "Cell": torch.stack(cs, dim=1)}


register_op(
    "lstmp", ["Input", "Weight", "ProjWeight", "Bias", "Length"],
    ["Projection", "Cell"], infer=_lstmp_infer, compute=_lstmp_compute,
    no_grad_inputs=("Length",), keep_graph=True)


def _gru_infer(op, block):
    x = in_var(op, block, "Input")     # [B, T, 3H]
    h = x.shape[2] // 3
    set_output(op, block, "Hidden", (x.shape[0], x.shape[1], h), x.dtype)


def _gru_compute(ins, attrs, ctx, op_index):
    x = ins["Input"][0]                     # [B, T, 3H] = x @ W_x + b
    length = ins["Length"][0]
    h0 = (ins.get("H0") or [None])[0]
    b, t, h3 = x.shape
    h = h3 // 3
    dt = x.dtype
    w = ins["Weight"][0].to(dt)             # [H, 3H]: [W_u, W_r | W_c]
    w_g, w_c = w[:, :2 * h], w[:, 2 * h:]
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    h_prev = h0.to(dt) if h0 is not None else x.new_zeros((b, h))
    hs = [None] * t
    for step in _steps(t, attrs.get("is_reverse", False)):
        xt = x[:, step]
        g = gate_act(xt[:, :2 * h] + h_prev @ w_g)
        u, r = g[:, :h], g[:, h:]
        c = cand_act(xt[:, 2 * h:] + (r * h_prev) @ w_c)
        hh = ((1.0 - u) * h_prev + u * c).to(dt)
        valid = (length > step)[:, None]
        hs[step] = torch.where(valid, hh, 0)
        h_prev = torch.where(valid, hh, h_prev)
    return {"Hidden": torch.stack(hs, dim=1)}


register_op(
    "gru", ["Input", "Weight", "Length", "H0"], ["Hidden"],
    infer=_gru_infer, compute=_gru_compute, no_grad_inputs=("Length",),
    keep_graph=True)


def _lstm_unit_infer(op, block):
    x = in_var(op, block, "X")         # [B, 4H]
    h = x.shape[-1] // 4
    set_output(op, block, "H", (x.shape[0], h), x.dtype)
    set_output(op, block, "C", (x.shape[0], h), x.dtype)


def _lstm_unit_compute(ins, attrs, ctx, op_index):
    """One LSTM step over gate pre-activations in the order (i, c, f, o)."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    gi, gc, gf, go = torch.chunk(x, 4, dim=-1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf + attrs.get("forget_bias", 0.0))
    c = f * c_prev + i * torch.tanh(gc)
    return {"H": torch.sigmoid(go) * torch.tanh(c), "C": c}


register_op("lstm_unit", ["X", "C_prev"], ["H", "C"],
            infer=_lstm_unit_infer, compute=_lstm_unit_compute)


def _gru_unit_infer(op, block):
    x = in_var(op, block, "Input")     # [B, 3H]
    h = x.shape[-1] // 3
    set_output(op, block, "Hidden", (x.shape[0], h), x.dtype)
    set_output(op, block, "Gate", (x.shape[0], 3 * h), x.dtype)
    set_output(op, block, "ResetHiddenPrev", (x.shape[0], h), x.dtype)


def _gru_unit_compute(ins, attrs, ctx, op_index):
    x, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    bias = (ins.get("Bias") or [None])[0]
    h = x.shape[-1] // 3
    if bias is not None:
        x = x + bias.reshape(-1)
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    g = gate_act(x[:, :2 * h] + h_prev @ w[:, :2 * h])
    u, r = g[:, :h], g[:, h:]
    rhp = r * h_prev
    c = cand_act(x[:, 2 * h:] + rhp @ w[:, 2 * h:])
    return {"Hidden": (1.0 - u) * h_prev + u * c,
            "Gate": torch.cat([g, c], dim=-1), "ResetHiddenPrev": rhp}


register_op("gru_unit", ["Input", "HiddenPrev", "Weight", "Bias"],
            ["Hidden", "Gate", "ResetHiddenPrev"],
            infer=_gru_unit_infer, compute=_gru_unit_compute)
