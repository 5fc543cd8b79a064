"""Joining a world of processes (counterpart of
``paddle_tpu/parallel/distributed.py``; the reference's NCCL2 rendezvous,
``operators/distributed/gen_nccl_id_op.cc:31``, and its cluster role
variables).

The JAX package joins ``jax.distributed`` and then drives every local
device from one process.  The port runs one process a device:
``init_distributed`` calls ``torch.distributed.init_process_group`` with
the address, world size and rank the caller gives, or the reference's
variables ``PADDLE_COORDINATOR`` (``host:port``, or ``file://<path>`` for
a file store), ``PADDLE_TRAINERS`` and ``PADDLE_TRAINER_ID``.  A process
on a card joins over NCCL on ``cuda:<local rank>``; gloo on the CPU is
used only when the caller asks for it (``place=CPUPlace()``), and nothing
switches from one to the other.  After the join the persistent compile
cache is scoped to the world's shape (``compile_cache.
rescope_persistent_cache``).
"""

import os
from datetime import timedelta

import torch

__all__ = ["init_distributed", "shutdown", "is_initialized",
           "process_count", "process_id", "barrier", "any_process_flagged",
           "gather_objects",
           "device", "local_rank"]

_STATE = {"initialized": False, "device": None, "local_rank": 0}


def _init_method(address):
    if address.startswith(("tcp://", "file://", "env://")):
        return address
    return "tcp://" + address


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, place=None,
                     timeout_s=600):
    """Join the world (once a process).  Arguments fall back to
    ``PADDLE_COORDINATOR``, ``PADDLE_TRAINERS`` and ``PADDLE_TRAINER_ID``;
    a world of one needs none of them.  ``local_device_ids`` ([i]) names
    the card (default: the rank modulo the cards on the host); ``place``
    ``CPUPlace()`` joins over gloo on the CPU, anything else over NCCL on
    the card, which raises where there is none."""
    import torch.distributed as dist

    from .. import compile_cache
    from ..executor import CPUPlace

    if _STATE["initialized"]:
        return
    coordinator_address = coordinator_address or \
        os.getenv("PADDLE_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.getenv("PADDLE_TRAINERS", "1"))
    if process_id is None:
        process_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
    num_processes, process_id = int(num_processes), int(process_id)
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(
                "a world of %d processes needs a coordinator address "
                "(coordinator_address= or PADDLE_COORDINATOR)"
                % num_processes)
        # a world of one: a store of its own on a free local port
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        coordinator_address = "127.0.0.1:%d" % s.getsockname()[1]
        s.close()
    cpu = isinstance(place, CPUPlace)
    if cpu:
        backend, dev = "gloo", torch.device("cpu")
        local = 0
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed joins over NCCL on a CUDA card and this "
                "process sees none; pass place=CPUPlace() for gloo on the "
                "CPU")
        local = int(local_device_ids[0]) if local_device_ids else \
            process_id % torch.cuda.device_count()
        backend, dev = "nccl", torch.device("cuda", local)
        torch.cuda.set_device(dev)
    kwargs = {}
    import inspect

    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        # binds the communicator to the card at the join
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s), **kwargs)
    _STATE.update(initialized=True, device=dev, local_rank=local)
    compile_cache.rescope_persistent_cache(num_processes)


def shutdown():
    """Leave the world (``destroy_process_group``): the process is one of
    its own again."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(initialized=False, device=None, local_rank=0)


def is_initialized():
    """Whether ``init_distributed`` ran in this process."""
    return _STATE["initialized"]


def device():
    """The device the world's collectives run on (None before the
    join)."""
    return _STATE["device"]


def local_rank():
    return _STATE["local_rank"]


def process_count():
    if not _STATE["initialized"]:
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_id():
    if not _STATE["initialized"]:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def barrier(name="paddle_tpu_barrier"):
    """A barrier over the world (the reference's send/fetch barrier
    round); nothing to wait for in a process of its own."""
    if process_count() > 1:
        import torch.distributed as dist

        dist.barrier()


def gather_objects(obj):
    """Every process's ``obj`` (picklable), in rank order: the evidence
    each process saw, so that all of them decide alike from the same
    list."""
    if process_count() == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def any_process_flagged(flag):
    """Collective OR over the world's processes: the preemption vote.
    Every process passes its own signal flag at the same point of its step
    loop and learns whether any process was signalled, so all agree on
    the step a checkpoint-on-signal flushes at."""
    if process_count() == 1:
        return bool(flag)
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_STATE["device"])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(int(t.item()))
