"""In-program evaluators (counterpart of ``paddle_tpu/evaluator.py``):
metric counters accumulated ACROSS mini-batches inside the training
program, with small side programs to reset and read them.

States are persistable [1]-shaped vars that the main program's ``sums``
ops update in place, so they live on the device beside the parameters
and a captured step accumulates them with no host read; ``reset`` runs a
cached program of ``fill_constant`` ops over them, ``eval`` fetches them
once and computes the metric on the host.  ``ChunkEvaluator`` counts
chunks, ``EditDistance`` distances and errors.  ``DetectionMAP`` computes
each batch's mAP in the graph (``detection_map``) and averages the
fetched values on the host, as the JAX package does: the reference's
streaming state is variable-length.
"""

import numpy as np

from . import layers
from .core import dtype_name
from .framework import Program, program_guard
from .layer_helper import LayerHelper

__all__ = ["Evaluator", "ChunkEvaluator", "EditDistance", "DetectionMAP"]


class Evaluator:
    """Base: name scoping, state creation, reset."""

    def __init__(self, name, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states = []
        self.metrics = []
        # reset/eval side programs are built once and reused: the
        # executor's compile cache keys on program identity, so a fresh
        # Program per call would retrace+rejit every epoch
        self._reset_program = None
        self._eval_program = None

    def reset(self, executor, reset_program=None):
        """Zero every state var (runs a small fill program whose outputs
        write back to the shared persistable state)."""
        if reset_program is None:
            if self._reset_program is None:
                self._reset_program = self._build_reset_program()
            reset_program = self._reset_program
        executor.run(reset_program)

    def _build_reset_program(self):
        prog = Program()
        with program_guard(main_program=prog):
            block = prog.global_block()
            for state in self.states:
                var = block.create_var(name=state.name, shape=state.shape,
                                       dtype=state.dtype, persistable=True)
                block.append_op(
                    type="fill_constant", inputs={},
                    outputs={"Out": [var.name]},
                    attrs={"shape": list(state.shape), "value": 0.0,
                           "dtype": dtype_name(state.dtype), "force_cpu": False})
        return prog

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def _create_state(self, suffix, dtype, shape):
        from . import unique_name

        block = self.helper.main_program.global_block()
        state = block.create_var(
            name=unique_name.generate("_".join([self.helper.name, suffix])),
            persistable=True, dtype=dtype, shape=tuple(shape))
        self.states.append(state)
        return state

    def _fetch_states(self, executor, eval_program=None):
        if eval_program is None:
            if self._eval_program is None:
                prog = Program()
                with program_guard(main_program=prog):
                    block = prog.global_block()
                    for state in self.states:
                        block.create_var(name=state.name,
                                         shape=state.shape,
                                         dtype=state.dtype,
                                         persistable=True)
                self._eval_program = prog
            eval_program = self._eval_program
        else:
            block = eval_program.global_block()
            for state in self.states:
                block.create_var(name=state.name, shape=state.shape,
                                 dtype=state.dtype, persistable=True)
        return executor.run(eval_program,
                            fetch_list=[s.name for s in self.states])


class ChunkEvaluator(Evaluator):
    """Accumulates chunk_eval counters; eval() -> (precision, recall,
    f1) over every batch since the last reset."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, seq_length=None):
        super().__init__("chunk_eval")
        self.num_infer_chunks = self._create_state(
            suffix="num_infer_chunks", dtype="int64", shape=[1])
        self.num_label_chunks = self._create_state(
            suffix="num_label_chunks", dtype="int64", shape=[1])
        self.num_correct_chunks = self._create_state(
            suffix="num_correct_chunks", dtype="int64", shape=[1])
        (precision, recall, f1, num_infer, num_label, num_correct) = \
            layers.chunk_eval(
                input=input, label=label, chunk_scheme=chunk_scheme,
                num_chunk_types=num_chunk_types,
                excluded_chunk_types=excluded_chunk_types,
                length=seq_length)
        layers.sums(input=[self.num_infer_chunks, num_infer],
                    out=self.num_infer_chunks)
        layers.sums(input=[self.num_label_chunks, num_label],
                    out=self.num_label_chunks)
        layers.sums(input=[self.num_correct_chunks, num_correct],
                    out=self.num_correct_chunks)
        self.metrics.extend([precision, recall, f1])

    def eval(self, executor, eval_program=None):
        num_infer, num_label, num_correct = [
            int(np.asarray(v).ravel()[0])
            for v in self._fetch_states(executor, eval_program)]
        precision = float(num_correct) / num_infer if num_infer else 0.0
        recall = float(num_correct) / num_label if num_label else 0.0
        f1 = 2.0 * precision * recall / (precision + recall) \
            if num_correct else 0.0
        return (np.array([precision], "float32"),
                np.array([recall], "float32"),
                np.array([f1], "float32"))


class EditDistance(Evaluator):
    """Accumulates edit distances; eval() -> (avg_distance,
    avg_instance_error) over every batch since the last reset."""

    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super().__init__("edit_distance", **kwargs)
        self.total_distance = self._create_state(
            suffix="total_distance", dtype="float32", shape=[1])
        self.seq_num = self._create_state(
            suffix="seq_num", dtype="int64", shape=[1])
        self.instance_error = self._create_state(
            suffix="instance_error", dtype="int64", shape=[1])
        distances, seq_num = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)
        zero = layers.fill_constant(shape=[1], value=0.0, dtype="float32")
        right = layers.reduce_sum(
            layers.cast(layers.equal(distances, zero), "int64"))
        errors = layers.elementwise_sub(seq_num, right)
        total = layers.reduce_sum(distances)
        layers.sums(input=[self.total_distance, total],
                    out=self.total_distance)
        layers.sums(input=[self.seq_num, seq_num], out=self.seq_num)
        layers.sums(input=[self.instance_error, errors],
                    out=self.instance_error)
        self.metrics.extend([total, errors])

    def eval(self, executor, eval_program=None):
        total, seq_num, errors = [
            float(np.asarray(v).ravel()[0])
            for v in self._fetch_states(executor, eval_program)]
        if not seq_num:
            return np.array([0.0], "float32"), np.array([0.0], "float32")
        return (np.array([total / seq_num], "float32"),
                np.array([errors / seq_num], "float32"))


class DetectionMAP(Evaluator):
    """Per-batch mAP in-graph; multi-batch accumulation host-side (the
    deliberate XLA redesign — see the module docstring).

    ``get_map_var()`` returns ``(cur_map, accum_map)`` where both name
    the per-batch mAP var; fetch it each step and pass it to ``update``
    for the running accumulation, then ``eval_accumulated()``.
    """

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral", **kwargs):
        super().__init__("map_eval")
        gt_label = layers.cast(gt_label, gt_box.dtype)
        parts = [gt_label]
        if gt_difficult is not None:
            parts.append(layers.cast(gt_difficult, gt_box.dtype))
        parts.append(gt_box)
        label = layers.concat(parts, axis=-1)
        self.cur_map = layers.detection_map(
            input, label, class_num, background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version,
            **kwargs)
        self._maps = []

    def get_map_var(self):
        return self.cur_map, self.cur_map

    def reset(self, executor=None, reset_program=None):
        self._maps = []

    def update(self, batch_map):
        self._maps.append(float(np.asarray(batch_map).ravel()[0]))

    def eval_accumulated(self):
        if not self._maps:
            return np.array([0.0], "float32")
        return np.array([float(np.mean(self._maps))], "float32")

    def eval(self, executor=None, eval_program=None):
        return self.eval_accumulated()
