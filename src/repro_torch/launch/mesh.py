"""Process groups and meshes.

A port of ``repro.launch.mesh``.  One process per rank: ``torchrun
--nproc-per-node N`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``) starts the ranks, and
:func:`init_process_group` joins them, NCCL on ``cuda`` and gloo on
``cpu``; without those variables it makes a world of one.  On the card a
world has one rank per card: NCCL refuses two ranks on one card, so a
world larger than ``torch.cuda.device_count()`` raises, and card tensors
never fall back to gloo.  The meshes are functions, so importing this
module touches no device and no process group.
"""
from __future__ import annotations

import os
import socket
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import Mesh


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(device: DeviceLike = None) -> Tuple[int, int]:
    """Join the world of ``torchrun``'s variables, or make a world of one;
    returns (rank, world size).  ``device`` (``None`` means ``cuda``) picks
    the backend: NCCL with this rank's card (``LOCAL_RANK``) on ``cuda``,
    gloo on ``cpu``.  A no-op when the default group exists already."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1"))
    rank = int(env.get("RANK", "0"))
    if "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    elif world == 1:
        init = f"tcp://127.0.0.1:{_free_port()}"
    else:
        raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR and "
                           "MASTER_PORT")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"a world of {world} ranks needs {world} cards, one per "
                f"rank (NCCL refuses two ranks on one card); there are "
                f"{cards}")
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init, world_size=world,
                                rank=rank,
                                device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
    return rank, world


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1,
                   device: DeviceLike = None) -> Mesh:
    """A ``('data', 'model')`` mesh, or ``('pod', 'data', 'model')`` when
    ``pod > 1``, over the world (joined by :func:`init_process_group` on
    ``device`` if it is not yet), which must have exactly as many ranks."""
    dev = resolve_device(device)
    init_process_group(dev)
    if pod == 1:
        return Mesh((data, model), ("data", "model"), dev.type)
    return Mesh((pod, data, model), ("pod", "data", "model"), dev.type)


def make_production_mesh(multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """(16, 16) ``('data', 'model')`` single pod; (2, 16, 16) ``('pod',
    'data', 'model')`` across two pods: 256 or 512 ranks."""
    if multi_pod:
        return make_host_mesh(16, 16, pod=2, device=device)
    return make_host_mesh(16, 16, device=device)
