"""ParamAttr: per-parameter configuration (counterpart of
``paddle_tpu/param_attr.py``).  The serving slice needs the name, the
initializer and trainability; the training-only fields (learning rate,
regularizer, gradient clip) come with the training slice."""

from .initializer import Initializer

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, trainable=True):
        self.name = name
        self.initializer = initializer
        self.trainable = trainable

    def set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr(trainable=False) if not arg else ParamAttr()
        raise TypeError("cannot interpret %r as ParamAttr" % (arg,))

    def to_kwargs(self):
        return {"name": self.name, "trainable": self.trainable}
