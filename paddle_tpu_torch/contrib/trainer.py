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

**Checkpoints.**  With a ``CheckpointConfig`` the Trainer keeps exact-
resume ``TrainState`` artifacts (``parallel.checkpoint``): every
``step_interval`` global steps (and epochs that are a multiple of
``epoch_interval``) it snapshots the persistables, the executor's run
counter and generators and a ``reader.checkpointable`` reader's position,
and writes them asynchronously (``async_save``).  At construction it
restores the newest artifact that loads (``load_serial`` holds its step)
and ``train`` resumes from it: the same epoch, the same batch, the same
dropout masks.  A directory holding only the older serial checkpoints
(``io.save_checkpoint``) resumes their persistables, with a warning.
While ``train`` runs, SIGTERM and SIGINT finish the current step, flush a
synchronous checkpoint and re-raise the signal with its previous handler.

**The guardian.**  ``guardian_config`` (a ``Guardian`` or its keyword
arguments), or ``FLAGS_guardian``, installs a guardian for ``train``:
steps carry the in-graph skip guard when ``skip`` is on its ladder, and a
``GuardianRollback`` restores the newest clean checkpoint, rewinds the
executor and the reader, fast-forwards past poisoned batches and
re-enters the loop (``_rollback_recover``); the rollback budget turns a
fault that persists into ``GuardianAbortError``.  Quarantined batches go
to ``<checkpoint_dir>/quarantine`` unless configured elsewhere.

Each step runs inside a ``trainer/step`` span, each checkpoint and
``save_params`` inside a ``trainer/checkpoint`` one; with the monitor on,
the end of ``train`` (also by an exception) stamps the run's goodput
summary and the last health snapshot into the JSONL log, as the JAX
Trainer does.

**Autotune.**  ``autotune`` (a ``TunedConfig`` or its JSON path) is
applied at construction: its kernel rulings go into the process tables
(``TunedConfig.apply``), and its ``checkpoint_interval`` decision becomes
the ``CheckpointConfig``'s ``step_interval``, unless the caller set that
interval (``step_interval_pinned``); each outcome is an
``autotune_applied`` event, as in the JAX Trainer.

**The mesh.**  ``parallel=True`` or ``mesh=`` trains through a
``parallel.ParallelExecutor`` over the mesh (default ``make_mesh()``: the
world's ranks on ``dp``, one rank without ``init_distributed``), on the
Trainer's place: the card over NCCL, or ``CPUPlace()`` over gloo.  Every
rank reads the same reader and keeps its rows of each batch.  In a world
of several processes the preemption signal is a vote
(``distributed.any_process_flagged``), taken after every step: all ranks
stop after the same step and flush the same checkpoint.  The manager
follows the world (``TrainStateCheckpointManager(sharded=None)``): in a
world of several processes each rank writes the blocks it owns and rank
0 commits the sharded artifact.

Not ported, and refused by name: ``cluster_member`` (ROADMAP A7c).
"""

import contextlib
import os
import signal as _signal
import warnings

import numpy as np

from .. import flags as _flags
from .. import guardian as _guardian
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
    """Where and how often the Trainer keeps ``TrainState`` artifacts
    (``parallel.checkpoint.TrainStateCheckpointManager``).
    ``step_interval`` counts global steps across epochs; ``incremental``
    (``'auto'``/``True`` or var names) writes the ``is_sparse`` tables as
    row deltas; after an auto-resume ``load_serial`` holds the restored
    step."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=None, async_save=True,
                 incremental=None, incremental_full_every=8):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            os.getcwd(), "checkpoints")
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(int(epoch_interval), 1)
        # a tuned interval (Trainer(autotune=)) never overrides one the
        # caller chose; None is the default of 10, which it may
        self.step_interval_pinned = step_interval is not None
        self.step_interval = max(int(step_interval), 1) \
            if step_interval is not None else 10
        self.async_save = bool(async_save)
        self.incremental = incremental
        self.incremental_full_every = int(incremental_full_every)
        self.load_serial = None


_REFUSED = (("cluster_member", "A7c"),)


class _MeshRun:
    """A ``ParallelExecutor`` behind the ``Executor`` signature the train
    loop calls (``run(program, feed=, fetch_list=)``, ``sync``,
    ``state_dict``)."""

    def __init__(self, pe):
        self.pe = pe

    def run(self, program=None, feed=None, fetch_list=None, **kwargs):
        return self.pe.run(fetch_list or [], feed=feed, **kwargs)

    def __getattr__(self, name):
        return getattr(self.pe, name)


class Trainer:
    """``train_func`` builds the model and returns the loss Variable (or a
    list whose first element is the loss); ``optimizer_func`` returns an
    Optimizer.  ``param_path`` loads persistables saved by
    ``save_params`` / ``io.save_persistables`` after the startup run;
    ``checkpoint_config`` and ``guardian_config`` are set out in the
    module's docstring."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None,
                 mesh=None, guardian_config=None, autotune=None,
                 cluster_member=None):
        given = dict(cluster_member=cluster_member)
        for arg, item in _REFUSED:
            if given[arg] is not None:
                raise NotImplementedError(
                    "Trainer(%s=...) is not ported to paddle_tpu_torch yet "
                    "(ROADMAP Queue %s)" % (arg, item))
        self.parallel = bool(parallel) or mesh is not None
        self._mesh = mesh
        if checkpoint_config is not None and not isinstance(
                checkpoint_config, CheckpointConfig):
            raise TypeError(
                "checkpoint_config must be a CheckpointConfig instance")
        self.__stop = False
        self.__preempted = None
        self._peer_preempted = False
        self.place = _default_place(place)
        self.checkpoint_cfg = checkpoint_config
        self._guardian_config = guardian_config
        self._set_guardian_flag = False
        self._current_epoch = 0

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
        self._autotune = None
        if autotune is not None:
            self._apply_autotune(autotune)
        self._ckpt_mgr = None
        self._global_step = 0
        self._resume_epoch = 0
        self._pending_resume = None
        if self.checkpoint_cfg is not None:
            self._auto_resume(exe)

    def _apply_autotune(self, autotune):
        """Apply a ``TunedConfig`` (or its path): the kernel rulings, then
        its checkpoint interval unless the caller pinned one."""
        from .. import autotune as _at

        self._autotune = autotune if isinstance(
            autotune, _at.TunedConfig) else _at.TunedConfig.load(autotune)
        self._autotune.apply()
        interval = self._autotune.value("checkpoint_interval")
        cfg = self.checkpoint_cfg
        if not interval or cfg is None:
            return
        if cfg.step_interval_pinned:
            monitor.log_event({"event": "autotune_applied",
                               "knob": "checkpoint_interval",
                               "outcome": "pinned",
                               "pinned_interval": cfg.step_interval})
        else:
            cfg.step_interval = max(1, int(interval))
            monitor.log_event({"event": "autotune_applied",
                               "knob": "checkpoint_interval",
                               "outcome": "applied",
                               "interval": cfg.step_interval})

    def _auto_resume(self, exe):
        """Open the checkpoint directory and restore its newest artifact
        into the scope; its executor and reader states wait for
        ``train``."""
        from ..parallel.checkpoint import TrainStateCheckpointManager

        cfg = self.checkpoint_cfg
        self._ckpt_mgr = TrainStateCheckpointManager(
            cfg.checkpoint_dir, max_to_keep=cfg.max_num_checkpoints,
            save_interval_steps=cfg.step_interval,
            async_save=cfg.async_save, incremental=cfg.incremental,
            incremental_full_every=cfg.incremental_full_every)
        restored = self._ckpt_mgr.restore(scope=self.scope,
                                          program=self.train_program)
        if restored is not None:
            cfg.load_serial = restored
            self._global_step = restored
            self._pending_resume = self._ckpt_mgr.last_restored.host
            self._resume_epoch = int(
                self._pending_resume.get("extra", {}).get("epoch", 0))
            return
        # a directory of the older serial checkpoints resumes their
        # persistables (no executor or reader state) and says so
        serial = fluid_io.get_latest_checkpoint_serial(cfg.checkpoint_dir)
        if serial >= 0:
            warnings.warn(
                "resuming a LEGACY (serial-based, params-only) checkpoint "
                "from %s; future saves use the TrainState format"
                % cfg.checkpoint_dir)
            cfg.load_serial = serial
            with scope_guard(self.scope):
                fluid_io.load_checkpoint(exe, cfg.checkpoint_dir,
                                         main_program=self.train_program)

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
        sample rows; wrap it in ``reader.checkpointable`` for an exact
        resume); ``event_handler`` receives the four events, and a
        ``BeginStepEvent`` with ``fetch_metrics`` False fetches nothing
        that step."""
        try:
            with scope_guard(self.scope):
                self._train(num_epochs, event_handler, reader, feed_order)
        finally:
            if self._set_guardian_flag:
                # the flag this train() set: a later plain executor must
                # not run guarded with nobody deciding
                self._set_guardian_flag = False
                _flags.set_flags({"guardian": False})
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
        if self._ckpt_mgr is not None:
            # a trailing async write lands before train() returns
            self._ckpt_mgr.wait_until_finished()

    def _executor(self):
        """The train executor: a ``ParallelExecutor`` over the mesh with
        ``parallel`` (its ``run`` given the ``Executor``'s signature), else
        an ``Executor`` on the Trainer's place."""
        if not self.parallel:
            return Executor(self.place)
        from ..parallel import ParallelExecutor

        pe = ParallelExecutor(
            use_cuda=self.place.device.type == "cuda",
            loss_name=self.train_func_outputs[0].name,
            main_program=self.train_program,
            scope=self.scope, mesh=self._mesh)
        return _MeshRun(pe)

    def _train(self, num_epochs, event_handler, reader, feed_order):
        executor = self._executor()
        feeder = self._feeder(feed_order)
        epoch_id = self._apply_resume_state(executor, reader)
        # inside train()'s try: a Guardian that refuses its config must
        # still restore the flag
        g = self._make_guardian()
        with self._signal_guard(), _guardian.installed(g):
            # detect -> decide -> recover: a GuardianRollback raised from
            # executor.run restores the newest clean TrainState and
            # re-enters the loop from the restored position
            while True:
                try:
                    self._run_epochs(epoch_id, num_epochs, event_handler,
                                     reader, feeder, executor)
                    break
                except _guardian.GuardianRollback as rb:
                    epoch_id = self._rollback_recover(rb, executor, reader)
                    if self.__stop or self.__preempted:
                        break
            if (self.__preempted or self._peer_preempted) \
                    and self._ckpt_mgr is not None \
                    and self._global_step > 0:
                # the step finished: flush a synchronous checkpoint, then
                # the signal proceeds (a step-0 artifact would restore as
                # load_serial 0, false under `if cfg.load_serial:`)
                self._flush_checkpoint(executor, reader, self._current_epoch)

    def _run_epochs(self, epoch_id, num_epochs, event_handler, reader,
                    feeder, executor):
        g = _guardian.active()
        fetch_all = [v.name for v in self.train_func_outputs]
        for epoch_id in range(epoch_id, num_epochs):
            self._current_epoch = epoch_id
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
                self._global_step += 1
                event_handler(EndStepEvent(epoch_id, step_id, metrics))
                if self._ckpt_mgr is not None:
                    with RecordEvent("trainer/checkpoint"):
                        self._maybe_save_checkpoint(executor, reader,
                                                    epoch_id)
                if self.parallel and self._vote():
                    break
                if self.__preempted:
                    break
            if g is not None:
                # the epoch's deferred observations through the ladder
                # while the recovery loop can still catch its decision
                g.flush()
            event_handler(EndEpochEvent(epoch_id))
            if self.__preempted:
                break
        if g is not None:
            g.flush()

    def _make_guardian(self):
        """A guardian installed by the caller stays in charge (None: the
        Trainer neither installs nor removes it); otherwise
        ``FLAGS_guardian`` or ``guardian_config`` build one, quarantining
        beside the checkpoints unless configured elsewhere."""
        if self._guardian_config is not None \
                and not _flags.flag("guardian"):
            # an explicit config turns the flag on for this train(), so
            # the steps carry the skip guard; train() turns it off again
            _flags.set_flags({"guardian": True})
            self._set_guardian_flag = True
        if _guardian.active() is not None:
            return None
        cfg = self._guardian_config
        if cfg is None and not _flags.flag("guardian"):
            return None
        if isinstance(cfg, _guardian.Guardian):
            g = cfg
            # budgets and history are per run
            g.reset_run_state()
        else:
            g = _guardian.Guardian(**dict(cfg or {}))
        if not g.quarantine_dir \
                and not _flags.flag("guardian_quarantine_dir") \
                and self.checkpoint_cfg is not None:
            g.quarantine_dir = os.path.join(
                self.checkpoint_cfg.checkpoint_dir, "quarantine")
        return g

    def _rollback_recover(self, rb, executor, reader):
        """One rung of the ladder: charge the rollback budget, restore the
        newest clean TrainState (past corrupt or NaN-poisoned artifacts),
        re-apply the executor's and the reader's states and fast-forward
        the reader past poisoned batches.  Returns the epoch to re-enter
        the loop at."""
        g = _guardian.active()
        if g is None:
            raise rb
        if self._ckpt_mgr is None:
            raise _guardian.GuardianAbortError(
                "guardian requested a rollback at step %d (%s) but the "
                "Trainer has no CheckpointConfig — nothing to roll back "
                "to" % (rb.step, rb.reason)) from rb
        g.begin_rollback(rb)          # the budget; raises when spent
        executor.sync()
        readers = self._ckpt_readers(reader)
        if reader is not None and not readers:
            warnings.warn(
                "guardian rollback cannot rewind this reader (no "
                "state_dict — wrap it with reader.checkpointable()): the "
                "replay re-enters the epoch from the reader's current "
                "position, so the recovered trajectory will NOT exactly "
                "reproduce the clean run")
        restored = g.rollback_restore(
            self._ckpt_mgr, rb, scope=self.scope,
            program=self.train_program, executors={"train": executor},
            readers=readers)
        self._global_step = restored
        self.checkpoint_cfg.load_serial = restored
        ff = g.post_restore(rb, restored)
        if ff:
            if hasattr(reader, "fast_forward"):
                reader.fast_forward(ff)
                monitor.log_event({"event": "guardian_fast_forward",
                                   "batches": ff,
                                   "restored_step": restored})
            else:
                warnings.warn(
                    "guardian rollback wants to skip %d poisoned batches "
                    "but the reader has no fast_forward() — wrap it with "
                    "reader.checkpointable(); the replay may re-trip the "
                    "sentinel" % ff)
        if readers:
            return int(reader.state_dict().get("epoch",
                                               self._current_epoch))
        return self._current_epoch

    def _apply_resume_state(self, executor, reader):
        """After an auto-resume, the restored executor and reader states
        go to the objects that now exist, once: a second train() starts a
        fresh epoch range.  Returns the epoch to start at."""
        host, self._pending_resume = self._pending_resume, None
        start, self._resume_epoch = self._resume_epoch, 0
        if host is None:
            return start
        ex_state = host.get("executors", {}).get("train")
        if ex_state is not None:
            executor.load_state_dict(ex_state)
        rd_state = host.get("readers", {}).get("train")
        if rd_state is not None and hasattr(reader, "load_state_dict"):
            reader.load_state_dict(rd_state)
            # the reader's own epoch counter rolls over exactly at the end
            # of its source
            return int(rd_state.get("epoch", start))
        return start

    def _signal_guard(self):
        """While training, SIGTERM and SIGINT ask for a graceful stop: the
        current step finishes, a checkpoint is flushed, and the signal is
        raised again with its previous handler."""
        self.__preempted = None

        @contextlib.contextmanager
        def _ctx():
            prev = {}

            def handler(signum, frame):
                self.__preempted = signum
                self.__stop = True

            try:
                for sig in (_signal.SIGTERM, _signal.SIGINT):
                    prev[sig] = _signal.signal(sig, handler)
            except ValueError:      # not the main thread
                yield
                return
            try:
                yield
            finally:
                for sig, h in prev.items():
                    _signal.signal(sig, h)
                if self.__preempted is not None:
                    _signal.raise_signal(self.__preempted)

        return _ctx()

    def _vote(self):
        """The preemption vote after a step: True when any rank of the
        world was signalled (every rank stops after this step)."""
        from ..parallel import distributed

        if distributed.process_count() <= 1:
            return False
        if distributed.any_process_flagged(self.__preempted is not None):
            self._peer_preempted = True
            self.__stop = True
            return True
        return False

    @staticmethod
    def _ckpt_readers(reader):
        if reader is not None and hasattr(reader, "state_dict"):
            return {"train": reader}
        return None

    def _flush_checkpoint(self, executor, reader, epoch_id):
        self._ckpt_mgr.save_now(
            self._global_step, scope=self.scope,
            program=self.train_program, executors={"train": executor},
            readers=self._ckpt_readers(reader),
            extra={"epoch": epoch_id, "preempted": True})

    def _maybe_save_checkpoint(self, executor, reader, epoch_id):
        cfg = self.checkpoint_cfg
        if epoch_id % cfg.epoch_interval != 0:
            return
        # the manager gates on the global step; the snapshot is taken
        # here, the write overlaps the next steps
        self._ckpt_mgr.save(
            self._global_step, scope=self.scope,
            program=self.train_program, executors={"train": executor},
            readers=self._ckpt_readers(reader), extra={"epoch": epoch_id})

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
