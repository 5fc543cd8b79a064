"""LayerHelper: shared machinery for layer functions (counterpart of
``paddle_tpu/layer_helper.py``) — parameter creation (a var in the main
program plus an init op in the startup program), temporaries, and the
bias/activation tails."""

import copy

from . import unique_name
from .framework import default_main_program, default_startup_program
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if kwargs.get("name") is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr", None))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr", None))

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attr = self.param_attr
        attrs = attr if isinstance(attr, list) else [attr]
        if len(attrs) == 1 and len(inputs) != 1:
            # one attr for several inputs: a copy each, one parameter each
            attrs = attrs + [copy.deepcopy(attrs[0])
                             for _ in range(len(inputs) - 1)]
        if len(attrs) != len(inputs):
            raise ValueError("parameter number mismatch")
        yield from zip(inputs, attrs)

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for v in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = v.dtype
            elif dtype != v.dtype:
                raise ValueError("mismatched input dtypes")
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr.to_attr(attr)
        if default_initializer is None:
            default_initializer = (
                ConstantInitializer(0.0) if is_bias else XavierInitializer())
        attr.set_default_initializer(default_initializer)
        name = attr.name or unique_name.generate(
            ".".join([self.name, "b" if is_bias else "w"]))
        attr.name = name
        param = self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())
        # mirror + init op in the startup program
        startup_blk = self.startup_program.global_block()
        if not startup_blk.has_var(name):
            sp = startup_blk.create_parameter(
                shape=shape, dtype=dtype, **attr.to_kwargs())
            attr.initializer(sp, startup_blk)
        return param

    def create_variable_for_type_inference(self, dtype=None, name=None):
        return self.main_program.current_block().create_var(
            name=name or unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            persistable=False,
        )

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(
            attr=self.bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act", None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [tmp]},
            attrs=act,
        )
        return tmp
