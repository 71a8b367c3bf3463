"""Device mesh and sharding policies: the port of polgen_rvc_tpu/parallel/mesh.py.

A ("data", "model") grid of torch devices:
  - "data": a chunk batch's rows split over the grid's rows; each data row
    runs HuBERT, retrieval and the synthesizer on its own rows
  - "model": Megatron-style tensor parallelism for the HuBERT encoder (heads
    and FFN columns split, partial sums reduced), for a data row that spans
    several devices

The JAX package annotates shardings and lets XLA insert the collectives;
eager PyTorch has no such compiler, so here the placement is explicit:
``shard_batch`` returns the row blocks, ``replicate`` one copy per distinct
device, ``shard_hubert_params`` one tree per mesh place, and the engine
(pipeline/engine.py) and ``models.hubert.hubert_extract_tp`` move tensors
between them. A mesh may name one device several times: that is the
stand-in for JAX's virtual CPU devices (``["cpu"] * 8`` in the CPU tests,
``["cuda:0"] * 4`` on a machine with one card), and every place on a
repeated device shares its copies.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


class Mesh:
    """An (n_data, n_model) object array of torch devices, CUDA ones indexed
    (resolve_device: torch.device("cuda") names no card and compares
    unequal to torch.device("cuda:0"))."""

    def __init__(self, devices):
        shape = np.shape(devices)
        if len(shape) != 2 or 0 in shape:
            raise ValueError(f"a mesh is a non-empty 2-D grid, not {shape}")
        grid = np.empty(shape, dtype=object)
        for d, m in np.ndindex(shape):
            grid[d, m] = resolve_device(devices[d][m])
        self.devices = grid

    @property
    def shape(self) -> dict:
        return {"data": self.devices.shape[0], "model": self.devices.shape[1]}

    @property
    def primary(self) -> torch.device:
        return self.devices[0, 0]

    def distinct(self) -> list:
        """Each device of the mesh once, in row-major order."""
        return list(dict.fromkeys(self.devices.flat))


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """Build a ("data", "model") mesh over the first n_data * n_model devices.

    devices defaults to every visible CUDA device, and raises when there is
    none (no fall back to the CPU). A list that repeats a device, such as
    ``["cpu"] * 8`` or ``["cuda:0"] * 4``, stands in for JAX's virtual
    devices. n_data defaults to len(devices) // n_model."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. "
                               "['cpu'] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or len(devices) < n_data * n_model:
        raise ValueError(f"make_mesh: {n_data} x {n_model} places need that many "
                         f"devices, got {len(devices)}")
    grid = [devices[d * n_model:(d + 1) * n_model] for d in range(n_data)]
    return Mesh(grid)


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
    """A (B, ...) tensor -> its n_data row blocks, block d on devices[d, 0].

    Raises unless B is a multiple of n_data (JAX's device_put raises too)."""
    n_data = mesh.shape["data"]
    if x.shape[0] % n_data:
        raise ValueError(f"shard_batch: {x.shape[0]} rows do not split over "
                         f"{n_data} data shards")
    return [blk.to(mesh.devices[d, 0]) for d, blk in enumerate(x.chunk(n_data))]


def replicate(tree, mesh: Mesh) -> dict:
    """{device: the tree on that device} for each distinct mesh device; a
    device the tree already lies on gets the tree's own tensors."""
    return {dev: tree_map(lambda a, dev=dev: a.to(dev), tree) for dev in mesh.distinct()}


def _column_block(a, m, n_model):
    s = a.shape[-1] // n_model
    return a[..., m * s:(m + 1) * s]


def _row_block(a, m, n_model):
    s = a.shape[0] // n_model
    return a[m * s:(m + 1) * s]


def shard_hubert_params(params: dict, mesh: Mesh, n_heads: int) -> list:
    """Tensor-parallel placement for the HuBERT encoder: shards[d][m] is the
    parameter tree of mesh place (d, m), on devices[d, m].

    Per transformer layer and model index m of n_model, with s = C / n_model
    (n_heads / n_model whole heads) and f = ffn_dim / n_model: q/k/v take
    w[:, m*s:(m+1)*s] and b[m*s:(m+1)*s]; o takes w[m*s:(m+1)*s, :]; fc1
    takes columns and bias m*f:(m+1)*f; fc2 takes rows m*f:(m+1)*f. The
    biases of o and fc2, and every other leaf (conv extractor, norms,
    pos_conv, final_proj), are replicated: hubert_extract_tp adds those two
    biases once, after the reduction. Places on one device share tensors."""
    n_model = mesh.shape["model"]
    layers = params["encoder"]["layers"]
    ffn_dim = int(np.shape(layers[0]["fc1"]["w"])[-1]) if layers else 0
    if n_heads % n_model or ffn_dim % n_model:
        raise ValueError(f"shard_hubert_params: {n_heads} heads and ffn_dim {ffn_dim} "
                         f"must split evenly over {n_model} model shards")
    full = replicate(params, mesh)
    made = {}

    def place(dev, m):
        if (dev, m) in made:
            return made[(dev, m)]
        tree = full[dev]
        new_layers = []
        for lp in tree["encoder"]["layers"]:
            attn = dict(lp["attn"])
            for name in ("q", "k", "v"):
                attn[name] = {"w": _column_block(attn[name]["w"], m, n_model).contiguous(),
                              "b": _column_block(attn[name]["b"], m, n_model).contiguous()}
            attn["o"] = {"w": _row_block(attn["o"]["w"], m, n_model).contiguous(),
                         "b": attn["o"]["b"]}
            fc1 = {"w": _column_block(lp["fc1"]["w"], m, n_model).contiguous(),
                   "b": _column_block(lp["fc1"]["b"], m, n_model).contiguous()}
            fc2 = {"w": _row_block(lp["fc2"]["w"], m, n_model).contiguous(),
                   "b": lp["fc2"]["b"]}
            new_layers.append({**lp, "attn": attn, "fc1": fc1, "fc2": fc2})
        made[(dev, m)] = {**tree, "encoder": {**tree["encoder"], "layers": new_layers}}
        return made[(dev, m)]

    n_data = mesh.shape["data"]
    return [[place(mesh.devices[d, m], m) for m in range(n_model)] for d in range(n_data)]
