"""Batch covers split over processes: the split and gather of the JAX
package's tools/dcn_dryrun.py, with torch.distributed.

Songs are independent, so the process axis splits the song list and each
process converts its share on its own local device mesh (parallel/mesh.py);
the only traffic between processes is the cross-process reduction and the
gathered results. The process group is gloo over TCP on 127.0.0.1, also on
the card: NCCL refuses two ranks on one card, and gloo moves host objects
(the int16 songs) as they are. Rank and world size are always given; a
missing peer raises when the group's timeout runs out instead of hanging.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def init_hosts(port: int, world_size: int, rank: int, *, timeout_s: float = 300.0):
    """Join a gloo process group of world_size ranks whose rendezvous is
    rank 0's TCP store on 127.0.0.1:port. Every collective, the rendezvous
    included, raises after timeout_s seconds without its peers."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def host_share(n_songs: int, rank: int, world_size: int) -> list:
    """The song indices rank converts: i % world_size == rank."""
    return [i for i in range(n_songs) if i % world_size == rank]


def host_sum(rows: torch.Tensor) -> torch.Tensor:
    """The sum over every rank's rows of `rows` (R, C): each rank's local
    column sums, added across processes (all_reduce). Returns (C,) on the
    CPU, the same on every rank."""
    total = rows.detach().to("cpu").sum(dim=0)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total


def convert_batch_across_hosts(vc, songs: list, opts) -> list | None:
    """This rank's share of songs (host_share) through vc.convert_batch on
    the converter's own devices, gathered to rank 0. Rank 0 gets every
    song's (int16 audio, sample rate) in song order; the others get None."""
    rank, world_size = dist.get_rank(), dist.get_world_size()
    mine = host_share(len(songs), rank, world_size)
    outs = vc.convert_batch([songs[i] for i in mine], opts) if mine else []
    parts = [None] * world_size if rank == 0 else None
    dist.gather_object(list(zip(mine, outs)), parts, dst=0)
    if rank != 0:
        return None
    gathered = dict(pair for part in parts for pair in part)
    return [gathered[i] for i in range(len(songs))]
