"""Model persistence (counterpart of ``paddle_tpu/io.py``:
``save/load_vars``, ``save/load_params``, ``save/load_persistables``,
``save/load_inference_model`` and the serial checkpoints
``save_checkpoint``, ``get_latest_checkpoint_serial``, ``load_checkpoint``
and ``clean_checkpoint``).

The on-disk format is the JAX package's, so either package loads the
other's files: one ``<name>.npy`` per variable, or one combined ``.npz``
when a filename is given; an inference model is a JSON ``__model__``
holding ``{"program": Program.to_dict(), "feed_names", "fetch_names"}``
beside its persistables.  Scope values are tensors: they go to numpy on
save (bfloat16, which numpy lacks, as float32) and come back on load as
tensors on the executor's device, in the dtype the program declares (int8
weights stay int8; token ids the JAX package wrote as int32 become the
declared int64).  The JAX package saves a bfloat16 array as two raw bytes
an element (numpy reads it back as ``|V2``); those bytes load as the
bfloat16 bits they are.  A serial checkpoint is
``<dir>/checkpoint_<serial>/trainer_<id>/persistables.npz``, the JAX
package's layout.  ``save_train_program`` writes a whole training program
(forward, backward and optimizer ops) and its startup program as one JSON
``__train_program__``, the JAX package's format, so a program saved by
either package trains in the other.
"""

import json
import os
import shutil

import numpy as np
import torch

from .framework import (Parameter, Program, default_main_program,
                        default_startup_program)
from .scope import global_scope

__all__ = [
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model",
    "save_train_program", "load_train_program",
    "save_checkpoint", "get_latest_checkpoint_serial", "load_checkpoint",
    "clean_checkpoint",
]


def _is_parameter(var):
    return isinstance(var, Parameter)


def _is_persistable(var):
    return var.persistable


def _npz_path(dirname, filename):
    # np.savez appends ".npz" itself; normalize so save and load agree
    if not filename.endswith(".npz"):
        filename += ".npz"
    return os.path.join(dirname, filename)


def _numpy(value):
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _tensor(arr):
    """A loaded array as a tensor; 2-byte raw or bfloat16 elements are
    bfloat16 bits."""
    arr = np.array(arr)
    if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                    or arr.dtype.name == "bfloat16"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _select(main_program, vars, predicate):
    if main_program is None:
        main_program = default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    return vars


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Save the global scope's values of the selected program variables."""
    vars = _select(main_program, vars, predicate)
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    arrays = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is not None:
            arrays[v.name] = _numpy(val)
    if filename is not None:
        np.savez(_npz_path(dirname, filename), **arrays)
        return
    for name, arr in arrays.items():
        np.save(os.path.join(dirname, name + ".npy"), arr)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Parameters, optimizer accumulators, learning-rate and counter vars,
    int8 weights and their scales: every persistable variable."""
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load the selected variables into the global scope as tensors on
    ``executor``'s device, each in its declared dtype."""
    vars = _select(main_program, vars, predicate)
    scope = global_scope()
    device = executor.place.device

    def put(v, arr):
        scope.set_var(v.name, _tensor(arr).to(device=device, dtype=v.dtype))

    if filename is not None:
        with np.load(_npz_path(dirname, filename)) as data:
            for v in vars:
                if v.name in data:
                    put(v, data[v.name])
        return
    for v in vars:
        path = os.path.join(dirname, v.name + ".npy")
        if os.path.exists(path):
            put(v, np.load(path))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    """Prune ``main_program`` (cloned for test) to what computes
    ``target_vars`` from the feeds; write it as JSON ``__model__`` and its
    persistables beside it.  Returns the fetch names."""
    if main_program is None:
        main_program = default_main_program()
    fetch_names = [v.name for v in target_vars]
    pruned = main_program.clone(for_test=True).prune_feed_fetch(
        feeded_var_names, fetch_names)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or "__model__"),
              "w") as f:
        json.dump({"program": pruned.to_dict(),
                   "feed_names": list(feeded_var_names),
                   "fetch_names": fetch_names}, f)
    save_persistables(executor, dirname, pruned, filename=params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Returns (program, feed_names, fetch_vars); the persistables land in
    the global scope on ``executor``'s device."""
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        payload = json.load(f)
    program = Program.from_dict(payload["program"])
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in payload["fetch_names"]]
    return program, payload["feed_names"], fetch_vars


def save_train_program(dirname, main_program=None, startup_program=None,
                       loss_name=None, feed_names=None):
    """Write a whole training program and its startup program to
    ``<dirname>/__train_program__``, so training runs with no Python graph
    build (``load_train_program``)."""
    if main_program is None:
        main_program = default_main_program()
    if startup_program is None:
        startup_program = default_startup_program()
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "__train_program__"), "w") as f:
        json.dump({"main": main_program.to_dict(),
                   "startup": startup_program.to_dict(),
                   "loss_name": loss_name,
                   "feed_names": list(feed_names or [])}, f)


def load_train_program(dirname):
    """(main_program, startup_program, loss_name, feed_names).  Without a
    recorded ``loss_name`` the loss is the first ``mean`` op's output, and
    without recorded feeds they are the main program's data vars."""
    with open(os.path.join(dirname, "__train_program__")) as f:
        payload = json.load(f)
    main = Program.from_dict(payload["main"])
    startup = Program.from_dict(payload["startup"])
    loss_name = payload.get("loss_name")
    if not loss_name:
        for op in main.global_block().ops:
            if op.type == "mean":
                loss_name = op.outputs["Out"][0]
                break
    feed_names = payload.get("feed_names") or [
        name for name, v in main.global_block().vars.items()
        if getattr(v, "is_data", False)]
    return main, startup, loss_name, feed_names


# ---- serial checkpoints (the reference io.py save_checkpoint family) ----

def _serials(checkpoint_dir):
    return [int(n.split("_")[1]) for n in os.listdir(checkpoint_dir)
            if n.startswith("checkpoint_")]


def save_checkpoint(executor, checkpoint_dir, trainer_id=0, main_program=None,
                    serial=None, max_num_checkpoints=3):
    """Save every persistable under ``checkpoint_<serial>/trainer_<id>``
    (``serial`` None: one past the latest), then drop the oldest serials
    beyond ``max_num_checkpoints``.  Returns the directory written."""
    if serial is None:
        serial = get_latest_checkpoint_serial(checkpoint_dir) + 1
    d = os.path.join(checkpoint_dir, "checkpoint_%d" % serial,
                     "trainer_%d" % trainer_id)
    save_persistables(executor, d, main_program, filename="persistables.npz")
    existing = sorted(_serials(checkpoint_dir))
    while len(existing) > max_num_checkpoints:
        victim = existing.pop(0)
        shutil.rmtree(os.path.join(checkpoint_dir, "checkpoint_%d" % victim),
                      ignore_errors=True)
    return d


def get_latest_checkpoint_serial(checkpoint_dir):
    """The largest serial under ``checkpoint_dir``; -1 when none."""
    if not os.path.isdir(checkpoint_dir):
        return -1
    serials = _serials(checkpoint_dir)
    return max(serials) if serials else -1


def load_checkpoint(executor, checkpoint_dir, trainer_id=0,
                    main_program=None, serial=None):
    """Load serial ``serial`` (None: the latest) into the global scope;
    False when the directory holds none."""
    if serial is None:
        serial = get_latest_checkpoint_serial(checkpoint_dir)
    if serial < 0:
        return False
    d = os.path.join(checkpoint_dir, "checkpoint_%d" % serial,
                     "trainer_%d" % trainer_id)
    load_persistables(executor, d, main_program, filename="persistables.npz")
    return True


def clean_checkpoint(checkpoint_dir, delete_dir=False):
    """Remove every serial; with ``delete_dir`` the directory too, when
    nothing else is left in it."""
    if not os.path.isdir(checkpoint_dir):
        return
    for n in os.listdir(checkpoint_dir):
        if n.startswith("checkpoint_"):
            shutil.rmtree(os.path.join(checkpoint_dir, n),
                          ignore_errors=True)
    if delete_dir and not os.listdir(checkpoint_dir):
        os.rmdir(checkpoint_dir)
