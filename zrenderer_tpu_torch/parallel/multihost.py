"""Multi-process scale-out of the sharded frames (counterpart of
``zrenderer_tpu/parallel/multihost.py``).

One process per device, joined into one ``torch.distributed`` process
group: NCCL between CUDA devices, gloo between CPU processes.  The
sharded frame step (``parallel/tiles.py``) runs unchanged across hosts;
its only collectives are the setup-row all-gather (and, with
``binning="dist"``, one all-to-all), so band raster output never leaves
its device.  Bands are assigned host-major, so each host's bands are
contiguous rows; ``local_bands`` returns this process's rows without
communication and ``gather_frame`` assembles the whole frame (one
all-gather) for the process that presents it.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from zrenderer_tpu_torch.parallel import tiles


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               init_method: str | None = None) -> None:
    """Join the process group: ``coordinator_address`` "host:port" of rank
    0 (None: the MASTER_ADDR/MASTER_PORT environment), or any
    ``init_process_group`` ``init_method`` (e.g. "file://<path>", a store
    only these processes share); this process's rank ``process_id`` of
    ``num_processes``.  The backend follows ``device``: NCCL for "cuda"
    (this process takes card LOCAL_RANK, or its rank modulo the host's
    card count), gloo for "cpu"."""
    kind = torch.device(device).type
    if kind == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", (process_id or 0) % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init = init_method
    if init is None and coordinator_address is not None:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=init, world_size=num_processes,
                            rank=process_id)


def global_tile_mesh(group=None):
    """The process group whose rank order is host-major, so every host's
    bands are contiguous rows: ``group`` (the default group for None) when
    its ranks already run host by host, as launchers number them;
    otherwise a new group over the same ranks in host-major order."""
    n = dist.get_world_size(group)
    hosts = [None] * n
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    first = {h: i for i, h in reversed(list(enumerate(hosts)))}
    order = sorted(range(n), key=lambda i: (first[hosts[i]], i))
    if order == list(range(n)):
        return group
    ranks = [dist.get_global_rank(group or dist.group.WORLD, i)
             for i in order]
    return dist.new_group(ranks=ranks, sort_ranks=False)


def make_multihost_frame(group, width: int, height: int,
                         binning: str = "auto", device="cuda"):
    """The multi-process flat frame: ``tiles.make_sharded_frame`` over
    ``group``, unchanged."""
    return tiles.make_sharded_frame(group, width, height, binning, device)


def local_bands(band, group=None) -> list[tuple[int, np.ndarray]]:
    """This process's rows of a band-sharded frame output, as
    [(row_offset, rows)] (one band a process), without communication."""
    row0 = dist.get_rank(group) * band.shape[0]
    return [(row0, band.cpu().numpy())]


def gather_frame(band, group=None) -> np.ndarray:
    """The whole frame on every process: one all-gather of the bands, in
    rank (band) order."""
    n = dist.get_world_size(group)
    return tiles.all_gather(group, band, n).cpu().numpy()
