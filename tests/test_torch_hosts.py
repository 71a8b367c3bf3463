"""Batch covers split over processes on the CPU: the port's counterpart of
tools/dcn_dryrun.py (polgen_rvc_tpu_torch/parallel/hosts.py and
hosts_dryrun.py), held against the JAX dryrun's split and the JAX
package's single-process convert_batch.

Every child process runs under its own time limit, and the process group's
timeout makes a missing peer raise, so nothing here can hang the run.

Bounds. The gathered songs against one process's convert_batch on the same
4-place mesh: at most 1 int16 count (the JAX dryrun's own bound); the
process split changes which chunks share a batch and the bucket they ride,
and on the CPU the plain twins' convolutions sum by length, so a chunk on
another bucket differs by rounding only. Against the JAX package's
convert_batch of the same songs and weights, with the JAX engine's noise
replayed: JAX_GAP (tests/test_torch_parallel.py), since the two
frameworks' convolutions sum in other orders all along the path.
"""

import ast
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from polgen_rvc_tpu.convert.rvc_ckpt import build_config
from polgen_rvc_tpu.convert.synthetic import make_hubert_state, rvc_config_list
from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.engine import VoiceConverter as JaxConverter
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_synthetic
from polgen_rvc_tpu_torch.parallel import host_share
from polgen_rvc_tpu_torch.utils.metrics import mel_distortion_db
from test_torch_parallel import JAX_GAP
from test_torch_pipeline import one_intra_op_thread  # noqa: F401

import hosts_dryrun

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 240


def _dryrun_split():
    """tools/dcn_dryrun.py's own expression for a process's song indices
    (the `my_idx = [...]` of its worker), as a function of (songs,
    N_PROC, proc_id)."""
    tree = ast.parse((REPO / "tools" / "dcn_dryrun.py").read_text())
    (node,) = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and [getattr(t, "id", None) for t in n.targets] == ["my_idx"]]
    code = compile(ast.Expression(node.value), "dcn_dryrun.py", "eval")
    return lambda songs, n_proc, proc_id: eval(
        code, {"range": range, "len": len},
        {"songs": songs, "N_PROC": n_proc, "proc_id": proc_id})


@pytest.mark.parametrize("world_size", [1, 2, 3, 4])
def test_host_share_is_the_dryrun_split(world_size):
    split = _dryrun_split()
    for n_songs in range(9):
        shares = [host_share(n_songs, rank, world_size) for rank in range(world_size)]
        assert shares == [split(list(range(n_songs)), world_size, rank)
                          for rank in range(world_size)]
        assert sorted(i for share in shares for i in share) == list(range(n_songs))


def _run_ranks(code: str, world_size: int, port: int, timeout_s: float = CHILD_TIMEOUT_S):
    """`code` in world_size fresh interpreters at once (RANK, WORLD and PORT
    set), each under the time limit: [(returncode, stdout, stderr)]."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"RANK, WORLD, PORT = {rank}, {world_size}, {port}\n{code}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world_size)]
    deadline = time.monotonic() + timeout_s
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


SUM_CODE = """
import torch
import torch.distributed as dist
from polgen_rvc_tpu_torch.parallel import host_sum, init_hosts
init_hosts(PORT, WORLD, RANK, timeout_s=60)
print(host_sum(torch.full((2, 8), float(RANK + 1))).tolist())
dist.destroy_process_group()
"""


def test_host_sum_over_two_gloo_processes():
    """The dryrun's cross-process reduction: each rank's (2, 8) rows of
    rank + 1, summed over both ranks, exactly 2 x (1 + 2) in every column,
    on every rank."""
    results = _run_ranks(SUM_CODE, 2, hosts_dryrun.free_port())
    for rc, stdout, stderr in results:
        assert rc == 0, stderr
        assert json.loads(stdout.strip().splitlines()[-1]) == [6.0] * 8


def test_a_missing_peer_raises_within_the_timeout():
    """Rank 0 of two whose peer never starts: init_hosts raises once its
    timeout runs out, instead of waiting for ever."""
    code = ("import time\nfrom polgen_rvc_tpu_torch.parallel import init_hosts\n"
            "t0 = time.monotonic()\ntry:\n"
            "    init_hosts(PORT, 2, 0, timeout_s=2)\n"
            "except Exception as e:\n"
            "    print(type(e).__name__, time.monotonic() - t0)\n    raise SystemExit(3)\n")
    ((rc, stdout, stderr),) = _run_ranks(code, 1, hosts_dryrun.free_port(), timeout_s=120)
    assert rc == 3, (stdout, stderr)
    name, waited = stdout.split()[-2:]
    assert name.endswith("Error") and 2.0 <= float(waited) < 60.0, stdout


def _noise_shapes(engine):
    """The JAX engine's noise draw shapes for the dryrun's tiny 48 kHz model,
    from its configs alone (no weights): ((inter channels, frames), source
    samples)."""
    synth_cfg = build_config(rvc_config_list(48000, tiny=True), use_f0=True, version="v2")
    hubert_cfg, _ = make_hubert_state(tiny=True)
    nf = JaxConverter._noise_frames(types.SimpleNamespace(engine=engine,
                                                          hubert_cfg=hubert_cfg))
    return (synth_cfg.inter_channels, nf), nf * synth_cfg.upp


def _jax_noise_file(shapes, path: Path, seed: int, chunk_ids) -> None:
    """The JAX engine's per-chunk draws (fold_in(PRNGKey(seed), chunk id),
    split into latent and source keys, at the fixed noise length) in
    hosts_dryrun.py's --noise layout."""
    lat_shape, nsf_len = shapes
    draws = {}
    for ci in chunk_ids:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ci)
        k_lat, k_nsf = jax.random.split(key)
        draws[f"eps_{seed}_{ci}"] = np.asarray(
            jax.random.normal(k_lat, lat_shape, np.float32))
        draws[f"nsf_{seed}_{ci}"] = np.asarray(
            jax.random.normal(k_nsf, (nsf_len,), np.float32))
    np.savez(path, **draws)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """python3 hosts_dryrun.py --device cpu at its tiny size, with the JAX
    engine's noise replayed (--noise) and the gathered songs kept (--out);
    the JAX package's single-process convert_batch of the same songs and
    weights runs here meanwhile. (return code, output, gathered, JAX's)."""
    tmp = tmp_path_factory.mktemp("hosts_dryrun")
    engine = JaxEngineConfig(**hosts_dryrun.ENGINE)
    shapes = _noise_shapes(engine)
    noise = tmp / "noise.npz"
    _jax_noise_file(shapes, noise, hosts_dryrun.OPTS["seed"], range(4))
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "hosts_dryrun.py"), "--device", "cpu",
         "--out", str(tmp / "out"), "--noise", str(noise)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jvc = jax_synthetic(tiny=True, sr=48000, index_vectors=64, engine=engine)
        nf = jvc._noise_frames()
        assert shapes == ((jvc.synth_cfg.inter_channels, nf), nf * jvc.synth_cfg.upp)
        jax_out = [a for a, _ in jvc.convert_batch(hosts_dryrun.songs(),
                                                   JaxOptions(**hosts_dryrun.OPTS))]
        stdout, stderr = proc.communicate(timeout=hosts_dryrun.WORKER_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    gathered = ([np.load(tmp / "out" / f"song{i}.npy") for i in range(len(jax_out))]
                if proc.returncode == 0 else None)
    return proc.returncode, stdout + stderr, gathered, jax_out


def test_dryrun_split_matches_one_process(dryrun):
    """The whole dryrun on the CPU: two gloo workers, the exact reduction,
    each song of the gathered list within 1 count of one process's
    convert_batch (the launcher's own check, read from its summary)."""
    rc, output, _, _ = dryrun
    assert rc == 0, output
    line = [ln for ln in output.splitlines() if ln.startswith("hosts dryrun OK: ")][-1]
    summary = json.loads(line.split(": ", 1)[1])
    assert summary["host_sum"] == [6.0] * 8
    assert summary["songs_by_rank"] == [[0, 2], [1]]
    assert summary["max_abs_diff"] <= 1 and not summary["failed"]


def test_dryrun_gathered_songs_match_the_jax_package(dryrun):
    """The gathered list against the JAX package's single-process
    convert_batch of the same songs and weights, on the same noise:
    JAX_GAP for every song."""
    rc, output, gathered, jax_out = dryrun
    assert rc == 0, output
    assert len(gathered) == len(jax_out) == 3
    for got, want in zip(gathered, jax_out):
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32)).max() > 1000
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= JAX_GAP["max_abs_diff"], d.max()
        assert (d > 0).mean() < JAX_GAP["share_differing"], (d > 0).mean()
        dist = mel_distortion_db(got, want, 48000)
        assert dist < JAX_GAP["mel_distortion_db"], dist
