"""Start ``n`` ranks, each a process on a process group of its own making.

:func:`spawn` runs ``fn(rank, device, *args)`` in ``n`` fresh processes
(``torch.multiprocessing``, start method ``spawn``), each after
``init_process_group(init_method="tcp://127.0.0.1:<free port>")``; an
exception in any rank makes :func:`spawn` raise. ``fn`` must be importable
from this package: a child imports the port only.

The backend, by one rule (:func:`backend_for`), printed once:

* NCCL when each rank has a card of its own;
* gloo on the CPU, or when ranks share a card (NCCL refuses two ranks on
  one card, "Duplicate GPU detected"); gloo takes CUDA tensors and stages
  them through the host.

A CUDA run without CUDA raises: nothing moves from the card to the CPU
quietly.
"""

from __future__ import annotations

import socket
from typing import Callable

import torch
import torch.distributed as dist


def backend_for(n: int, device) -> str:
    """``"nccl"`` when ``device`` is CUDA and there are at least ``n``
    cards, ``"gloo"`` on the CPU or when ranks share a card."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"spawn: device {device} (takes 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError("spawn: device 'cuda' asked for but CUDA is not available")
    return "nccl" if torch.cuda.device_count() >= n else "gloo"


def rank_device(rank: int, device) -> torch.device:
    """The device rank ``rank`` runs on: its own card, or a shared one."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, n: int, device: str, backend: str, port: int,
               args: tuple) -> None:
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # n ranks share the host's cores
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *, device, args: tuple = (), log: Callable = print) -> str:
    """Run ``fn(rank, device, *args)`` on ``n`` ranks; returns the backend."""
    device = str(torch.device(device))
    backend = backend_for(n, device)
    cards = torch.cuda.device_count() if device.startswith("cuda") else 0
    log(f"parallel.launch: {n} ranks on {device} ({cards} cards) over {backend} (NCCL when "
        f"each rank has a card of its own, gloo on the CPU or when ranks share a card)")
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(fn, n, device, backend, free_port(), args), nprocs=n,
                       join=True, start_method="spawn")
    return backend
