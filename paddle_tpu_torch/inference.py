"""The deployment predictor API (counterpart of ``paddle_tpu/inference.py``):
``PaddleTensor``, ``NativeConfig``, ``AnalysisConfig``, ``PaddlePredictor``
(``run`` / ``clone``) and ``create_paddle_predictor``.

A predictor loads a saved inference model (``io.save_inference_model``'s
pruned program and persistables) into a scope of its own and runs it
through an ``Executor``: on the card the second run of an input signature
captures a CUDA graph, which every later run replays.  ``clone()`` shares
the program and the weights and takes an executor of its own, the
clone-per-thread pattern; runs of one predictor are serialized by a lock.
``AnalysisConfig.enable_serving`` routes ``run`` through one
continuous-batching ``serving.InferenceEngine`` that every clone shares;
``enable_quantization`` rewrites the loaded program to int8 weights
(``transpiler.quantize_inference``).

There is no silent fallback: ``use_gpu=True`` (the default) runs on
``CUDAPlace(device)`` and ``use_gpu=False`` on ``CPUPlace()``, where the
JAX package falls back to the host when it finds no accelerator."""

import threading

import numpy as np

from . import io as pt_io
from .executor import CPUPlace, CUDAPlace, Executor
from .scope import Scope, scope_guard

__all__ = ["PaddleTensor", "NativeConfig", "AnalysisConfig",
           "PaddlePredictor", "create_paddle_predictor"]


class PaddleTensor:
    """An input or output of a predictor: ``data`` is a numpy array;
    ``name`` names a feed (inputs) or fetch (outputs); ``lod`` holds the
    per-sequence lengths of a ``lod_level`` >= 1 input (its ``@LEN``
    feed)."""

    def __init__(self, name="", data=None, shape=None, dtype=None,
                 lod=None):
        self.name = name
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            if shape:
                data = data.reshape(shape)
        self.data = data
        self.shape = tuple(data.shape) if data is not None else \
            tuple(shape or ())
        self.dtype = str(data.dtype) if data is not None else dtype
        self.lod = lod

    def __repr__(self):
        return "PaddleTensor(name=%r, shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)


class NativeConfig:
    """Where the model lives and the device it runs on: ``use_gpu`` picks
    ``CUDAPlace(device)``, else ``CPUPlace()``.  ``fraction_of_gpu_memory``
    is accepted and unused (PyTorch's caching allocator sizes itself)."""

    def __init__(self, model_dir="", prog_file=None, param_file=None,
                 use_gpu=True, device=0, fraction_of_gpu_memory=-1.0):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.param_file = param_file
        self.use_gpu = use_gpu
        self.device = device
        self.fraction_of_gpu_memory = fraction_of_gpu_memory

    def _place(self):
        return CUDAPlace(self.device) if self.use_gpu else CPUPlace()


class AnalysisConfig(NativeConfig):
    """``NativeConfig`` plus the optimization switches.  A saved model is
    already an inference program, so ``enable_ir_optim`` is recorded and
    has nothing left to do; ``enable_serving`` and ``enable_quantization``
    change how ``run`` executes."""

    def __init__(self, *args, enable_ir_optim=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.enable_ir_optim = enable_ir_optim
        self.serving = None
        self.quantize_mode = None

    def enable_serving(self, slots=8, timeout_s=30.0, bucket_bounds=None,
                       tuned_config=None, quarantine_dir=None):
        """Run this config's predictors through one shared
        ``serving.InferenceEngine`` (its keyword arguments).  The
        TunedConfig artifact and quarantine dumps are not ported yet
        (ROADMAP A6), so ``tuned_config`` and ``quarantine_dir`` raise."""
        if tuned_config is not None or quarantine_dir is not None:
            raise NotImplementedError(
                "tuned_config= and quarantine_dir= are not ported yet "
                "(ROADMAP A6: the TunedConfig artifact, quarantine dumps)")
        self.serving = {"slots": slots, "timeout_s": timeout_s,
                        "bucket_bounds": bucket_bounds}
        return self

    def enable_quantization(self, mode="weight_only"):
        """int8 execution: the predictor rewrites the loaded program with
        ``transpiler.quantize_inference`` (int8 weights, per-channel
        scales, kernel #7 on the card); clones and the serving engine share
        the rewritten program.  A model saved already quantized loads
        int8 with no opt-in."""
        self.quantize_mode = mode
        return self


class PaddlePredictor:
    """``run(inputs) -> outputs`` and ``clone()`` over a saved model."""

    def __init__(self, config, _shared=None):
        self._config = config
        self._place = config._place()
        self._exe = Executor(self._place)
        if _shared is not None:
            # a clone: the program, weights and serving engine are shared,
            # the executor (and its captured graphs) is its own
            (self._program, self._feed_names, self._fetch_vars,
             self._scope, self._engine_holder) = _shared
        else:
            self._scope = Scope()
            with scope_guard(self._scope):
                self._program, self._feed_names, self._fetch_vars = \
                    pt_io.load_inference_model(
                        config.model_dir, self._exe,
                        model_filename=config.prog_file,
                        params_filename=config.param_file)
            mode = getattr(config, "quantize_mode", None)
            if mode:
                from .transpiler.quantize_pass import quantize_inference

                self._program = quantize_inference(
                    self._program, scope=self._scope, mode=mode)
                blk = self._program.global_block()
                self._fetch_vars = [blk.var(v.name)
                                    for v in self._fetch_vars]
            # the holder's own lock: a predictor and its clone calling
            # first at once must not build two engines
            self._engine_holder = [None, threading.Lock()]
        self._mu = threading.Lock()

    def serving_engine(self, **overrides):
        """The continuous-batching engine over this predictor's program and
        weights, built at the first call and shared by every clone."""
        holder = self._engine_holder
        with holder[1]:
            if holder[0] is None:
                from .serving import InferenceEngine

                kw = dict(getattr(self._config, "serving", None) or {})
                kw.update(overrides)
                holder[0] = InferenceEngine(
                    program=self._program, feed_names=self._feed_names,
                    fetch_vars=self._fetch_vars, scope=self._scope,
                    place=self._place, **kw)
        return holder[0]

    def run(self, inputs):
        """A list of ``PaddleTensor`` (or a name -> array dict) in; a list of
        ``PaddleTensor`` out, ordered like the saved fetch targets."""
        feed = {}
        if isinstance(inputs, dict):
            items = inputs.items()
        else:
            items = [(t.name, t.data) for t in inputs]
            for t in inputs:
                if t.lod is not None:
                    feed[t.name + "@LEN"] = np.asarray(t.lod, "int32")
        for name, data in items:
            if name not in self._feed_names and not name.endswith("@LEN"):
                raise ValueError(
                    "input %r is not a feed target of this model "
                    "(expected %s)" % (name, self._feed_names))
            if data is None:
                raise ValueError(
                    "input %r has no data (PaddleTensor.data is None)" % name)
            feed[name] = data
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError("missing inputs: %s" % missing)
        if getattr(self._config, "serving", None) is not None:
            return self._run_serving(feed)
        # the scope is passed explicitly: scope_guard's global is not
        # thread-safe, and clones run concurrently
        with self._mu:
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_vars,
                                 scope=self._scope)
        return self._tensors(outs)

    def _tensors(self, outs):
        return [PaddleTensor(name=v.name, data=o)
                for v, o in zip(self._fetch_vars, outs)]

    def _run_serving(self, feed):
        """The call through the shared engine: one micro-batch request a
        slot batch (fixed-shape models) or one request an example
        (sequence models); the outputs equal a direct run's."""
        engine = self.serving_engine()
        batch = max(int(np.shape(v)[0]) for n, v in feed.items()
                    if not n.endswith("@LEN"))
        if not engine._seq_feeds:
            step, reqs = engine.slots, []
            for lo in range(0, batch, step):
                chunk = {n: np.asarray(v)[lo:lo + step]
                         for n, v in feed.items()}
                rows = min(step, batch - lo)
                if rows == 1:
                    chunk = {n: v[0] for n, v in chunk.items()}
                reqs.append(engine.submit(chunk, rows=rows))
            parts = [r.result() for r in reqs]
            return self._tensors([np.concatenate(
                [p[j] if r.rows > 1 else np.asarray(p[j])[None]
                 for p, r in zip(parts, reqs)])
                for j in range(len(self._fetch_vars))])
        reqs = []
        for i in range(batch):
            reqs.append(engine.submit({
                n: (int(np.asarray(v)[i]) if n.endswith("@LEN")
                    else np.asarray(v)[i]) for n, v in feed.items()}))
        rows = [r.result() for r in reqs]
        return self._tensors([np.stack([row[j] for row in rows])
                              for j in range(len(self._fetch_vars))])

    Run = run

    def clone(self):
        """A predictor sharing the program and the weights, with an
        executor of its own (one a thread)."""
        return PaddlePredictor(
            self._config,
            _shared=(self._program, self._feed_names, self._fetch_vars,
                     self._scope, self._engine_holder))

    Clone = clone

    @property
    def feed_names(self):
        return list(self._feed_names)

    @property
    def fetch_names(self):
        return [v.name for v in self._fetch_vars]


def create_paddle_predictor(config):
    """A ``PaddlePredictor`` for ``config``."""
    return PaddlePredictor(config)
