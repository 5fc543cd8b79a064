"""High-level Trainer (counterpart of ``paddle_tpu/contrib/trainer.py``):
builds the train, startup and test programs from ``train_func`` and
``optimizer_func`` under a fresh name generator, runs the startup
program, and trains through an event-driven epoch and step loop
(``BeginEpochEvent``, ``BeginStepEvent``, ``EndStepEvent``,
``EndEpochEvent``), converting each reader batch with a ``DataFeeder``
and fetching the ``train_func`` outputs every step (``fetch_metrics``).

The place is ``CUDAPlace(0)`` unless the caller passes one; there is no
fallback to the CPU.  On the card ``Executor.run`` captures the step as a
CUDA graph at its second run and replays it after (``executor.py``).

Each step runs inside a ``trainer/step`` span and ``save_params`` inside
a ``trainer/checkpoint`` one; with the monitor on, the end of ``train``
(also by an exception) stamps the run's goodput summary and the last
health snapshot into the JSONL log, as the JAX Trainer does.

Not ported, and refused by name: ``CheckpointConfig`` (the JAX Trainer's
checkpoints are ``TrainState`` artifacts, ROADMAP Queue A6), the
guardian, autotune and the preemption flush on SIGTERM (A6), and
``parallel=True``, ``mesh`` and ``cluster_member`` (A7).
"""

import os

import numpy as np

from .. import io as fluid_io
from .. import monitor
from .. import unique_name
from ..data_feeder import DataFeeder
from ..executor import CUDAPlace, Executor
from ..framework import Program, program_guard
from ..optimizer import Optimizer
from ..profiler import RecordEvent
from ..scope import Scope, scope_guard

__all__ = [
    "Trainer", "CheckpointConfig",
    "BeginEpochEvent", "EndEpochEvent", "BeginStepEvent", "EndStepEvent",
]


def _default_place(place=None):
    """The caller's place, else the first card (shared by Trainer and
    Inferencer)."""
    return place if place is not None else CUDAPlace(0)


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """The JAX Trainer's exact-resume checkpoint config; its checkpoints
    are ``TrainState`` artifacts, which the port does not write yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CheckpointConfig: the Trainer's TrainState checkpoints are not "
            "ported to paddle_tpu_torch yet (ROADMAP Queue A6); save with "
            "Trainer.save_params or io.save_checkpoint")


_REFUSED = (("mesh", "A7"), ("guardian_config", "A6"), ("autotune", "A6"),
            ("cluster_member", "A7"))


class Trainer:
    """``train_func`` builds the model and returns the loss Variable (or a
    list whose first element is the loss); ``optimizer_func`` returns an
    Optimizer.  ``param_path`` loads persistables saved by
    ``save_params`` / ``io.save_persistables`` after the startup run."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None,
                 mesh=None, guardian_config=None, autotune=None,
                 cluster_member=None):
        given = dict(mesh=mesh, guardian_config=guardian_config,
                     autotune=autotune, cluster_member=cluster_member)
        for arg, item in _REFUSED:
            if given[arg] is not None:
                raise NotImplementedError(
                    "Trainer(%s=...) is not ported to paddle_tpu_torch yet "
                    "(ROADMAP Queue %s)" % (arg, item))
        if parallel:
            raise NotImplementedError(
                "Trainer(parallel=True): the parallel executor is not "
                "ported to paddle_tpu_torch yet (ROADMAP Queue A7)")
        if checkpoint_config is not None:
            raise NotImplementedError(
                "Trainer(checkpoint_config=...): TrainState checkpoints "
                "are not ported to paddle_tpu_torch yet (ROADMAP Queue A6)")
        self.__stop = False
        self.place = _default_place(place)

        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()

        # a fresh name generator: parameter names (fc_0.w_0, ...) do not
        # depend on what this process built before, so an Inferencer that
        # rebuilds the net under the same guard finds the saved files
        with unique_name.guard(), \
                program_guard(self.train_program, self.startup_program):
            program_func_outs = train_func()
            self.train_func_outputs = (
                program_func_outs if isinstance(program_func_outs, list)
                else [program_func_outs])
            # the test program: forward only, before the optimizer's ops
            self.test_program = self.train_program.clone(for_test=True)
            if not callable(optimizer_func):
                raise TypeError("optimizer_func must be callable")
            optimizer = optimizer_func()
            if not isinstance(optimizer, Optimizer):
                raise TypeError(
                    "optimizer_func must return a paddle_tpu_torch "
                    "Optimizer")
            loss = self.train_func_outputs[0]
            optimizer.minimize(loss)

        self._dist_transpile_if_necessary()

        with scope_guard(self.scope):
            exe = Executor(self.place)
            exe.run(self.startup_program)
            if param_path is not None:
                fluid_io.load_persistables(exe, param_path,
                                           main_program=self.startup_program)

    def _dist_transpile_if_necessary(self):
        role = os.getenv("PADDLE_TRAINING_ROLE")
        if role is None or role == "TRAINER":
            return
        if role == "PSERVER":
            raise RuntimeError(
                "parameter-server roles do not exist in paddle_tpu_torch: "
                "parameters are not served from a pserver")
        raise ValueError("unknown PADDLE_TRAINING_ROLE %r" % role)

    def stop(self):
        self.__stop = True

    def train(self, num_epochs, event_handler, reader=None, feed_order=None):
        """``num_epochs`` passes over ``reader`` (a creator of batches of
        sample rows); ``event_handler`` receives the four events, and a
        ``BeginStepEvent`` with ``fetch_metrics`` False fetches nothing
        that step."""
        try:
            self._train(num_epochs, event_handler, reader, feed_order)
        finally:
            if monitor._enabled:
                # the run's wall-clock attribution and final per-layer
                # health at the boundary every post-mortem starts from;
                # in the finally, because the runs that need one are the
                # ones that do not return cleanly
                try:
                    monitor.goodput_stamp()
                    monitor.health.stamp()
                except Exception:  # noqa: BLE001 — telemetry must not
                    pass           # mask the real exit

    def _train(self, num_epochs, event_handler, reader, feed_order):
        with scope_guard(self.scope):
            executor = Executor(self.place)
            feeder = self._feeder(feed_order)
            fetch_all = [v.name for v in self.train_func_outputs]
            for epoch_id in range(num_epochs):
                if self.__stop:
                    break
                event_handler(BeginEpochEvent(epoch_id))
                for step_id, data in enumerate(reader()):
                    if self.__stop:
                        break
                    begin = BeginStepEvent(epoch_id, step_id)
                    event_handler(begin)
                    fetch = fetch_all if begin.fetch_metrics else []
                    with RecordEvent("trainer/step"):
                        metrics = executor.run(self.train_program,
                                               feed=feeder.feed(data),
                                               fetch_list=fetch)
                    event_handler(EndStepEvent(epoch_id, step_id, metrics))
                event_handler(EndEpochEvent(epoch_id))

    def test(self, reader, feed_order=None):
        """The ``train_func`` outputs averaged over the test reader."""
        with scope_guard(self.scope):
            executor = Executor(self.place)
            feeder = self._feeder(feed_order, program=self.test_program)
            accumulated = None
            count = 0
            for data in reader():
                outs = executor.run(
                    self.test_program, feed=feeder.feed(data),
                    fetch_list=[v.name for v in self.train_func_outputs])
                outs = [float(np.asarray(o).mean()) for o in outs]
                accumulated = outs if accumulated is None else [
                    a + o for a, o in zip(accumulated, outs)]
                count += 1
            if count == 0:
                return accumulated
            return [a / count for a in accumulated]

    def save_params(self, param_path):
        with RecordEvent("trainer/checkpoint"), scope_guard(self.scope):
            fluid_io.save_persistables(
                Executor(self.place), param_path,
                main_program=self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        with scope_guard(self.scope):
            fluid_io.save_inference_model(
                param_path, feeded_var_names,
                [self.train_func_outputs[i] for i in target_var_indexes],
                Executor(self.place), main_program=self.train_program)

    def _feeder(self, feed_order, program=None):
        program = program or self.train_program
        if feed_order is None:
            feed_order = [
                v.name for v in program.global_block().vars.values()
                if getattr(v, "is_data", False)
                and not v.name.endswith("@LEN")
            ]
        feed_list = [program.global_block().var(name) for name in feed_order]
        return DataFeeder(feed_list=feed_list, place=self.place,
                          program=program)
