#!/usr/bin/env python3
"""Batch covers split over processes: the port's counterpart of the JAX
package's tools/dcn_dryrun.py, with torch.distributed (gloo on 127.0.0.1).

    python3 hosts_dryrun.py [--device cpu|cuda] [--out DIR] [--noise FILE]
                                                     launcher: spawns 2 workers
    python3 hosts_dryrun.py --proc N --port P --out DIR [--device cpu|cuda]
                            [--noise FILE]           worker N

Songs are independent, so the process axis splits the song list, and each
process runs its share on its own local device mesh:

  1. two worker processes join one gloo process group (rank and world size
     given, rendezvous on the launcher's free port) and run the
     cross-process reduction: each rank's (2, 8) rows filled with rank + 1,
     summed over every rank (parallel/hosts.py:host_sum), exactly 6.0 in
     every column;
  2. each worker converts its share of a 3-song batch cover (song i goes to
     rank i % 2) with convert_batch on a local 4-place mesh, and rank 0
     gathers every song in order (convert_batch_across_hosts);
  3. the launcher converts the whole list with one process's convert_batch
     on the same local mesh, while the workers run, and holds every
     gathered song to it: at most 1 int16 count, the bound the JAX dryrun
     holds its processes to.

The songs, engine, model and options are the JAX dryrun's: 7, 5 and 6 s
sines at 220, 330 and 262 Hz with light noise (seeds 10 + i); x_pad 1,
x_query 2, x_center 4, x_max 5, chunk_batch 4, 2 s buckets; the tiny 48 kHz
model with 64 index vectors; index_rate 0.4, protect 0.2, seed 5. The local
mesh is 4 data shards over the device named four times (four distinct cards
where the machine shows four). The device is the card unless --device cpu is
given (no card raises); CPU processes run one torch thread. Each worker
has a time limit; a failed worker or comparison exits non-zero. Prints one
summary line.

--out DIR keeps the gathered songs (DIR/song<i>.npy, int16) and each rank's
proc<rank>.json there; by default they go to a temporary directory,
removed at the end. --noise FILE replays per-chunk noise draws from an
.npz (eps_<seed>_<chunk id> (inter channels, frames) and nsf_<seed>_<chunk
id> (samples,), float32) in every process instead of the engine's own
generator: another implementation's draws, so that its output can be held
against this one's sample by sample.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

N_PROC = 2
LOCAL_PLACES = 4
WORKER_TIMEOUT_S = 900
PEER_TIMEOUT_S = 300.0
ENGINE = dict(x_pad=1, x_query=2, x_center=4, x_max=5, chunk_batch=4, bucket_step_s=2)
OPTS = dict(index_rate=0.4, protect=0.2, seed=5)
BOUND_COUNTS = 1


def songs() -> list:
    """The JAX dryrun's three songs, float32 at 16 kHz."""
    out = []
    for i, (seconds, hz) in enumerate([(7.0, 220.0), (5.0, 330.0), (6.0, 262.0)]):
        rng = np.random.default_rng(10 + i)
        t = np.arange(int(seconds * 16000)) / 16000
        out.append((0.3 * np.sin(2 * np.pi * hz * t)
                    + 0.01 * rng.standard_normal(t.size)).astype(np.float32))
    return out


def local_device(device: str):
    """The resolved device (raises for a missing card); one torch thread on
    the CPU."""
    import torch

    from polgen_rvc_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    return dev


def local_mesh(dev):
    """Four data shards over four distinct cards where the machine shows
    four, else over dev named four times."""
    import torch

    from polgen_rvc_tpu_torch.parallel import make_mesh

    if dev.type == "cuda" and torch.cuda.device_count() >= LOCAL_PLACES:
        return make_mesh(LOCAL_PLACES)
    return make_mesh(LOCAL_PLACES, devices=[dev] * LOCAL_PLACES)


def file_noise(path: str):
    """A noise provider (pipeline/engine.py:NoiseProvider) replaying the
    draws in the .npz at path; a draw it does not hold raises KeyError."""
    import torch

    draws = dict(np.load(path))

    def provider(seed, chunk_id, lat_shape, nsf_len, device):
        eps = draws[f"eps_{seed}_{chunk_id}"]
        nsf = draws[f"nsf_{seed}_{chunk_id}"]
        if eps.shape != tuple(lat_shape) or nsf.shape != (nsf_len,):
            raise ValueError(f"noise for chunk {chunk_id}: {eps.shape}, {nsf.shape}; "
                             f"wanted {tuple(lat_shape)}, ({nsf_len},)")
        return torch.from_numpy(eps).to(device), torch.from_numpy(nsf).to(device)

    return provider


def build_converter(mesh, noise: str | None = None):
    """The dryrun's tiny 48 kHz converter on mesh, with the draws in the
    .npz `noise` or the engine's own noise."""
    from polgen_rvc_tpu_torch.pipeline.config import EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

    kw = {} if noise is None else {"noise_provider": file_noise(noise)}
    return build_synthetic_converter(tiny=True, sr=48000, index_vectors=64,
                                     engine=EngineConfig(**ENGINE), mesh=mesh, **kw)


def worker(rank: int, port: int, out_dir: str, device: str = "cuda",
           noise: str | None = None) -> int:
    """Rank `rank` of N_PROC: the reduction, then its share of the songs;
    rank 0 writes every gathered song to out_dir/song<i>.npy. Each rank
    writes out_dir/proc<rank>.json."""
    import torch
    import torch.distributed as dist

    from polgen_rvc_tpu_torch.parallel import (
        convert_batch_across_hosts, host_share, host_sum, init_hosts,
    )
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions

    dev = local_device(device)
    init_hosts(port, N_PROC, rank, timeout_s=PEER_TIMEOUT_S)
    try:
        got = host_sum(torch.full((2, 8), float(rank + 1)))
        want = torch.full((8,), 2.0 * sum(range(1, N_PROC + 1)))
        if not torch.equal(got, want):
            raise AssertionError(f"rank {rank}: host_sum {got.tolist()}, want {want.tolist()}")
        mesh = local_mesh(dev)
        vc = build_converter(mesh, noise)
        t0 = time.perf_counter()
        outs = convert_batch_across_hosts(vc, songs(), ConversionOptions(**OPTS))
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for i, (audio, _) in enumerate(outs):
            np.save(os.path.join(out_dir, f"song{i}.npy"), audio)
    mine = host_share(len(songs()), rank, N_PROC)
    with open(os.path.join(out_dir, f"proc{rank}.json"), "w") as f:
        json.dump({"rank": rank, "songs": mine, "host_sum": got.tolist(),
                   "convert_s": wall, "mesh": [str(d) for d in mesh.devices]}, f)
    print(f"worker {rank}: ok (songs {mine}, host_sum {got[0].item()})", flush=True)
    return 0


def free_port() -> int:
    with socket.create_server(("127.0.0.1", 0)) as s:
        return s.getsockname()[1]


def run_workers(argv_of, meanwhile=None, timeout_s: float = WORKER_TIMEOUT_S) -> list:
    """Start N_PROC processes (argv_of(rank)), call meanwhile() while they
    run, wait for each within timeout_s of the start, kill any still
    running; their return codes, then meanwhile's result where given."""
    procs = [subprocess.Popen(argv_of(rank)) for rank in range(N_PROC)]
    deadline = time.monotonic() + timeout_s
    rcs = []
    try:
        extra = [meanwhile()] if meanwhile is not None else []
        for p in procs:
            rcs.append(p.wait(timeout=max(deadline - time.monotonic(), 1.0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs + extra


def launcher(device: str, out: str | None = None, noise: str | None = None) -> int:
    with tempfile.TemporaryDirectory(prefix="hosts_dryrun_") as tmp:
        return compare_workers(device, out or tmp, noise)


def compare_workers(device: str, out_dir: str, noise: str | None) -> int:
    """The launcher's work: the workers writing to out_dir, one process's
    convert_batch of the whole list meanwhile, then the comparison."""
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions

    dev = local_device(device)
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    argv = [sys.executable, os.path.abspath(__file__), "--port", str(port),
            "--out", out_dir, "--device", device, *(["--noise", noise] if noise else [])]
    try:
        rcs = run_workers(lambda rank: [*argv, "--proc", str(rank)],
                          # one process's conversion of the whole list, on the
                          # same local mesh, while the workers run
                          meanwhile=lambda: build_converter(local_mesh(dev), noise)
                          .convert_batch(songs(), ConversionOptions(**OPTS)))
    except subprocess.TimeoutExpired:
        print(f"hosts dryrun FAILED: a worker ran past {WORKER_TIMEOUT_S} s", flush=True)
        return 1
    refs = rcs.pop()
    if any(rc != 0 for rc in rcs):
        print(f"hosts dryrun FAILED: worker return codes {rcs}", flush=True)
        return 1
    worst, failed = 0, []
    for i, (ref, _) in enumerate(refs):
        got = np.load(os.path.join(out_dir, f"song{i}.npy"))
        if got.shape != ref.shape:
            failed.append((i, got.shape, ref.shape))
            continue
        d = int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())
        worst = max(worst, d)
        if d > BOUND_COUNTS:
            failed.append((i, d))
    procs = []
    for r in range(N_PROC):
        with open(os.path.join(out_dir, f"proc{r}.json")) as f:
            procs.append(json.load(f))
    summary = {"processes": N_PROC, "local_places": LOCAL_PLACES, "device": str(dev),
               "backend": "gloo", "host_sum": procs[0]["host_sum"],
               "songs_by_rank": [p["songs"] for p in procs],
               "max_abs_diff": worst, "bound": BOUND_COUNTS, "failed": failed}
    verdict = "FAILED" if failed else "OK"
    print(f"hosts dryrun {verdict}: {json.dumps(summary)}", flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--proc", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--out")
    ap.add_argument("--noise")
    args = ap.parse_args(argv)
    if args.proc is None:
        return launcher(args.device, args.out, args.noise)
    return worker(args.proc, args.port, args.out, args.device, args.noise)


if __name__ == "__main__":
    sys.exit(main())
