"""Op specs built from registry metadata (counterpart of
``paddle_tpu/op.py``): ``Operator("scale", X="x", Out="y", scale=2.0)``
checks the keywords against the op's ``OpDef`` in the port's registry
and returns the op-spec dict ``{"type", "inputs", "outputs", "attrs"}``
that ``Block.append_op`` takes; ``get_all_op_protos`` lists every
registered ``OpDef``.
"""

from . import registry

__all__ = ["get_all_op_protos", "Operator", "OpDescCreationMethod"]


def get_all_op_protos():
    """All registered OpDefs (reference op.py get_all_op_protos)."""
    return [registry.OPS[t] for t in sorted(registry.OPS)]


class OpDescCreationMethod(object):
    """kwargs -> op-spec dict for one op type (reference op.py
    OpDescCreationMethod; validation semantics preserved: unknown
    keywords are rejected, every kwarg must name an input slot, an
    output slot, or an attribute)."""

    def __init__(self, op_def):
        if not isinstance(op_def, registry.OpDef):
            raise TypeError("expected a registry.OpDef, got %r" % (op_def,))
        self.op_def = op_def

    def __call__(self, *args, **kwargs):
        if args:
            raise ValueError("Only keyword arguments are supported.")
        d = self.op_def
        spec = {"type": d.type, "inputs": {}, "outputs": {}, "attrs": {}}
        consumed = set()
        for slot in d.input_slots:
            if slot in kwargs:
                spec["inputs"][slot] = self._names(kwargs[slot])
                consumed.add(slot)
        for slot in d.output_slots:
            if slot in kwargs:
                spec["outputs"][slot] = self._names(kwargs[slot])
                consumed.add(slot)
        for key, value in kwargs.items():
            if key in consumed:
                continue
            # anything that is not an input/output slot is an attribute
            # (the OpDef does not enumerate attrs; kernels read them)
            spec["attrs"][key] = value
        return spec

    @staticmethod
    def _names(v):
        if isinstance(v, str):
            return [v]
        if isinstance(v, (list, tuple)):
            return list(v)
        return [v]


class OperatorFactory(object):
    """``Operator(type, **kwargs)`` entry point (reference op.py
    OperatorFactory)."""

    def __call__(self, op_type, *args, **kwargs):
        return OpDescCreationMethod(registry.get_op_def(op_type))(
            *args, **kwargs)

    def get_op_def(self, op_type):
        return registry.get_op_def(op_type)

    def types(self):
        return sorted(registry.OPS)


Operator = OperatorFactory()
