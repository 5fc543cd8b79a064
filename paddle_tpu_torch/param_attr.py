"""ParamAttr: per-parameter configuration (counterpart of
``paddle_tpu/param_attr.py``): name, initializer, learning-rate
multiplier, regularizer (``regularizer.L1Decay`` / ``L2Decay``),
trainability, gradient clip (the ``clip`` classes)."""

from .initializer import Initializer

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

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
        return {"name": self.name,
                "optimize_attr": {"learning_rate": self.learning_rate},
                "regularizer": self.regularizer,
                "trainable": self.trainable,
                "gradient_clip_attr": self.gradient_clip}
