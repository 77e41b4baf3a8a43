"""Multi-process data parallelism on ``torch.distributed``.

Port of ``situation_recognition_tpu/parallel/distributed.py``.  The port
runs one process per card: NCCL between the processes on the card, gloo on
the CPU (the tests).  A world starts either from ``torchrun``'s environment

    torchrun --nproc_per_node N -m situation_recognition_tpu_torch.cli \\
        --distributed ...

(``env://``, the part JAX's auto-detection plays on pods) or from the JAX
CLI's explicit ``--coordinator host:port --num_processes N --process_id
r`` (``tcp://``).  Every process runs the same program on its block of
each global batch (``ImsituLoader(shard=...)``, ``parallel/mesh.py``), so
the collectives are issued from the main thread in the same order on every
rank: the BatchNorm statistics (``models/resnet.py``), the loss
denominators, the top-k gather (``fetch``), one gradient all-reduce per
optimizer step and the preemption flag (``preempt_agreed``).

The collectives are ``all_reduce`` (and ``broadcast``) only: PyTorch
documents no others for gloo on CUDA tensors, and a world of two processes
on one card needs gloo (NCCL refuses two ranks on one device).  There is
no fallback: a failed ``init_process_group`` or collective raises, and a
process group on CUDA tensors is NCCL unless the caller names another
backend.  The preemption flag rides a gloo group of CPU tensors beside an
NCCL world (``host_group``), so that reading it does not wait for the
card.

``COUNTS`` counts the collectives by kind (``bn``, ``den``, ``loss``,
``fetch``, ``grad``, ``clip``, ``tp``, ``flag``, ``stats``, ``mesh``), as
the kernel wrappers count their launches.
"""

from __future__ import annotations

import collections
import os
import socket
import zlib
from typing import Optional

import torch
import torch.distributed as dist

from situation_recognition_tpu_torch.device import resolve_device

#: collectives issued, by kind (read and zeroed by ``chip_smoke.py``)
COUNTS: collections.Counter = collections.Counter()
#: the world this process joined: its device and its gloo group for host
#: flags (``torch.distributed`` itself is per process, and so is this)
_WORLD: dict = {}
#: torchrun's variables that ``env://`` reads
ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
#: the size of NCCL's flight recorder, by its names new and old
FLIGHT_RECORDER = ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE")


def _bind(device, process_id) -> torch.device:
    """The device this rank computes on: ``device`` with an index as it
    is, else ``cuda:LOCAL_RANK`` (torchrun's variable; with the explicit
    flags and no ``LOCAL_RANK``, the rank modulo the cards on this node),
    or the CPU by name."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None else int(process_id or 0)
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> torch.device:
    """Join the world and → this rank's device.

    With ``coordinator`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` it meets at ``tcp://coordinator``; with none of them
    at ``env://`` (torchrun).  ``backend``: NCCL for a CUDA device, gloo
    for the CPU, unless named.  Idempotent: a second call returns the
    device of the first."""
    if dist.is_initialized():
        return _WORLD["device"]
    given = [x is not None for x in (coordinator, num_processes,
                                     process_id)]
    if any(given) and not all(given):
        raise ValueError("coordinator, num_processes and process_id go "
                         "together (or none of them, for torchrun's "
                         "environment)")
    dev = _bind(device, process_id)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        # NCCL's flight recorder records every collective on the host, and
        # a ResNet-152 step issues one a BN layer: off unless asked for
        # (the variable's name, and its older one)
        if not any(v in os.environ for v in FLIGHT_RECORDER):
            os.environ[FLIGHT_RECORDER[0]] = "0"
    kw = {}
    if all(given):
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes), rank=int(process_id))
    else:
        missing = [v for v in ENV_VARS if v not in os.environ]
        if missing:
            raise ValueError(f"env:// needs torchrun's environment; "
                             f"{missing} are not set")
        kw["init_method"] = "env://"
    dist.init_process_group(backend, **kw)
    _WORLD["device"] = dev
    _WORLD["host_group"] = (dist.group.WORLD if backend == "gloo"
                            else dist.new_group(backend="gloo"))
    return dev


def destroy() -> None:
    """Leave the world (``destroy_process_group``) and forget it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.clear()


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def host_group():
    """A gloo group over the world for CPU tensors (the world itself when
    it is gloo)."""
    return _WORLD["host_group"]


def all_reduce(t: torch.Tensor, group, kind: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group``, counted under
    ``kind``; → ``t``."""
    COUNTS[kind] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


def fetch(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of a batch → the rows of every rank of ``group``,
    in rank order, on every rank (JAX ``fetch``: every process then scores
    the whole batch).  An all-reduce of the rows placed in zeros, so that
    gloo serves CUDA tensors too.  ``group`` None: ``x``."""
    if group is None:
        return x
    b = x.shape[0]
    r = group_rank(group)
    out = x.new_zeros((group_size(group) * b,) + tuple(x.shape[1:]))
    out[r * b:(r + 1) * b] = x
    return all_reduce(out, group, "fetch")


def preempt_agreed(preempt, world: bool = True) -> bool:
    """Whether to stop at this step boundary (JAX ``_preempt_agreed``): the
    local flag, or in a world (``world``: the caller trains in it) the
    largest of every rank's, so that a rank that was not signalled stops
    at the same boundary instead of waiting in the next step's gradient
    all-reduce.  Every rank calls this at every boundary; the flag rides
    the host's gloo group."""
    if preempt is None:
        return False
    flag = preempt.is_set()
    if not (world and dist.is_initialized()):
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    return bool(all_reduce(t, host_group(), "flag",
                           op=dist.ReduceOp.MAX).item())


def node_ids(world: int) -> list:
    """Each rank's node (a hash of its host name), by an all-reduce of
    one slot per rank over the host group."""
    ids = torch.zeros(world, dtype=torch.int64)
    ids[dist.get_rank()] = zlib.crc32(socket.gethostname().encode())
    return all_reduce(ids, host_group(), "mesh").tolist()
