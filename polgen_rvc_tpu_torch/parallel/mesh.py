"""Device mesh and data sharding: the port of polgen_rvc_tpu/parallel/mesh.py's
"data" axis.

A mesh is a row of torch devices, one a data shard: a chunk batch's rows
split over them, and each shard runs HuBERT, retrieval and the synthesizer
on its own rows with its own copy of the weights. The JAX package's
"model" axis (HuBERT tensor parallelism) is left out: HuBERT Base is
~190 MB in bf16 on an 80 GB card, and splitting its heads would only add
cross-device reductions to every chunk batch.

The JAX package annotates shardings and lets XLA insert the transfers;
eager PyTorch has no such compiler, so here the placement is explicit:
``shard_batch`` returns the row blocks, ``replicate`` one copy per
distinct device, and the engine (pipeline/engine.py) moves tensors
between them. A mesh may name one device several times: that is the
stand-in for JAX's virtual CPU devices (``["cpu"] * 8`` in the CPU tests,
``["cuda:0"] * 2`` on a machine with one card), and every shard on a
repeated device shares its copies.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


class Mesh:
    """The devices of the data shards, in shard order, CUDA ones indexed
    (resolve_device: torch.device("cuda") names no card and compares
    unequal to torch.device("cuda:0"))."""

    def __init__(self, devices):
        devices = list(devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [resolve_device(d) for d in devices]

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> list:
        """Each device of the mesh once, in shard order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(n_data: int | None = None, devices=None) -> Mesh:
    """Build a mesh of n_data data shards over the first n_data devices.

    devices defaults to every visible CUDA device, and raises when there is
    none (no fall back to the CPU). A list that repeats a device, such as
    ``["cpu"] * 8`` or ``["cuda:0"] * 2``, stands in for JAX's virtual
    devices. n_data defaults to len(devices)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. "
                               "['cpu'] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices)
    if n_data < 1 or len(devices) < n_data:
        raise ValueError(f"make_mesh: {n_data} data shards need that many "
                         f"devices, got {len(devices)}")
    return Mesh(devices[:n_data])


def tree_map(fn, tree):
    """fn on every tensor (or numpy array) of a nested dict/list/tuple;
    anything else passes through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(tree))
    return tree


def shard_batch(x: torch.Tensor, mesh: Mesh) -> list:
    """A (B, ...) tensor -> its row blocks, block d on devices[d].

    Raises unless B is a multiple of the shard count (JAX's device_put
    raises too)."""
    n_data = len(mesh.devices)
    if x.shape[0] % n_data:
        raise ValueError(f"shard_batch: {x.shape[0]} rows do not split over "
                         f"{n_data} data shards")
    return [blk.to(dev) for dev, blk in zip(mesh.devices, x.chunk(n_data))]


def replicate(tree, mesh: Mesh) -> dict:
    """{device: the tree on that device} for each distinct mesh device; a
    device the tree already lies on gets the tree's own tensors."""
    return {dev: tree_map(lambda a, dev=dev: a.to(dev), tree) for dev in mesh.distinct()}
