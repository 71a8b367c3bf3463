"""The port end to end against the JAX package, and the port's guards.

End to end: bench.py's CPU-smoke configuration (tiny models, 48 kHz,
256 index vectors, 2-second chunk buckets), its synthetic song cut to 6 s
so the song spans several chunks, and bench's options. The port's engine
takes the JAX engine's own noise draws through its noise provider, so the
two renditions differ only by float32 arithmetic order.
"""

import ast
import copy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_builder
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.ops.conv_transpose import pack_phase_taps
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import torch_noise
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

PKG = Path(__file__).resolve().parent.parent / "polgen_rvc_tpu_torch"
SMOKE_ENGINE = dict(x_pad=1, x_query=2, x_center=3, x_max=4, chunk_batch=2,
                    bucket_step_s=2)
BENCH_OPTS = dict(index_rate=0.5, protect=0.33, volume_envelope=0.25)


def _bench_song(seconds: float) -> np.ndarray:
    rng = np.random.default_rng(0)
    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    return (0.4 * np.sin(2 * np.pi * 220.0 * t * vibrato)
            + 0.1 * np.sin(2 * np.pi * 440.0 * t)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def jax_noise(seed, chunk_id, lat_shape, nsf_len, device):
    """The JAX engine's per-chunk draws: fold_in(PRNGKey(seed), chunk id),
    split into (latent, source) keys, normals at the fixed noise length."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), chunk_id)
    k_lat, k_nsf = jax.random.split(key)
    eps = np.array(jax.random.normal(k_lat, lat_shape, jnp.float32))
    nsf = np.array(jax.random.normal(k_nsf, (nsf_len,), jnp.float32))
    return torch.from_numpy(eps).to(device), torch.from_numpy(nsf).to(device)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread while a module's tests run (this one's, and
    every port test file's that imports it): the tier-1 run puts six test
    processes on the machine's cores, and eight threads each make the tiny
    models' CPU convs spin on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_vc():
    """bench.py's CPU-smoke converter, built once for this file (its
    full-width RMVPE is the costly part of a build)."""
    return build_synthetic_converter(
        tiny=True, sr=48000, index_vectors=256,
        engine=EngineConfig(**SMOKE_ENGINE), device="cpu")


def test_convert_matches_jax_end_to_end(port_vc):
    song = _bench_song(6.0)
    vc = copy.copy(port_vc)
    vc.noise_provider = jax_noise
    jvc = jax_builder(tiny=True, sr=48000, index_vectors=256,
                      engine=JaxEngineConfig(**SMOKE_ENGINE))
    out, sr = vc.convert(song, ConversionOptions(**BENCH_OPTS))
    ref, jsr = jvc.convert(song, JaxOptions(**BENCH_OPTS))
    assert sr == jsr == 48000
    assert out.dtype == np.int16 and out.shape == ref.shape
    assert np.abs(out).max() > 1000  # not silent
    # the repo's acceptance gate for two renditions (tests/test_quality.py)
    dist = mel_distortion_db(out, ref, sr)
    assert dist < 0.5, f"mel distortion {dist:.3f} dB"
    print(f"mel distortion vs JAX: {dist:.6f} dB")


def test_default_noise_is_deterministic_and_seeded(port_vc):
    song = _bench_song(2.0)
    vc = port_vc
    assert vc.noise_provider is torch_noise
    a, _ = vc.convert(song, ConversionOptions(seed=1))
    b, _ = vc.convert(song, ConversionOptions(seed=1))
    c, _ = vc.convert(song, ConversionOptions(seed=2))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_weights_are_packed_once_at_load(port_vc):
    """The converter makes the kernels' weight layouts when it loads its
    weights, beside the fp32 originals the plain twins use."""
    dec, cfg = port_vc.synth_params["dec"], port_vc.synth_cfg
    for up, u in zip(dec["ups"], cfg.upsample_rates):
        c_in, c_out, k = up["w"].shape
        assert torch.equal(up["w_taps"], pack_phase_taps(up["w"].to(torch.bfloat16),
                                                         u, (k - u) // 2))
        assert up["w_taps"].shape == (k, c_out, c_in)
        assert up["w_taps"].dtype == torch.bfloat16
    for rb in dec["resblocks"]:
        for conv in (*rb["convs1"], *rb["convs2"]):
            assert torch.equal(conv["w_taps"].float(),
                               conv["w"].to(torch.bfloat16).float().permute(2, 0, 1))
    n_blocks = n_shortcuts = 0
    for part in ("encoder", "intermediate", "decoder"):
        for lvl in port_vc.rmvpe_params[part]:
            for blk in lvl["blocks"]:
                n_blocks += 1
                for name in ("conv1", "conv2"):
                    assert blk[name]["w_taps"].dtype == torch.bfloat16
                    assert blk[name]["w"].dtype == torch.float32
                n_shortcuts += "w_mat" in blk.get("shortcut", {})
    assert n_blocks == 56 and n_shortcuts > 0  # 14 levels of 4 blocks


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    """Statically: no module of the port names jax or polgen_rvc_tpu. At run
    time: importing every module in a fresh interpreter loads neither."""
    modules = []
    for path in sorted(PKG.rglob("*.py")):
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "polgen_rvc_tpu"), (path, name)
        rel = path.relative_to(PKG.parent).with_suffix("")
        modules.append(".".join(p for p in rel.parts if p != "__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'polgen_rvc_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from polgen_rvc_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_synthetic_converter(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_wrappers_import_and_run_plain_without_nvcc(monkeypatch):
    """The kernel modules import with no nvcc; on CPU tensors the wrappers
    run their plain twins and never build or count a launch."""
    from polgen_rvc_tpu_torch.ops import (
        band_attention, conv_transpose, cuda_build, resblock_group, unet_chain, viterbi,
    )

    def no_build(*a, **k):
        raise AssertionError("a CPU call must not build kernels")

    monkeypatch.setattr(cuda_build, "build_all", no_build)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()
    wrappers = (resblock_group.fused_resblock_group, conv_transpose.conv_transpose1d,
                band_attention.band_attention, unet_chain.convblock_chain,
                viterbi.viterbi_path)
    before = [w.launches for w in wrappers]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 32, 20, generator=g)
    p = [{"convs1": [{"w": torch.randn(32, 32, 3, generator=g) * 0.1,
                      "b": torch.zeros(32)}],
          "convs2": [{"w": torch.randn(32, 32, 3, generator=g) * 0.1,
                      "b": torch.zeros(32)}]}]
    assert resblock_group.fused_resblock_group(x, p, (3,), ((1,),)).shape == x.shape
    w = torch.randn(32, 16, 4, generator=g)
    assert conv_transpose.conv_transpose1d(x, w, None, stride=2,
                                           padding=1).shape == (1, 16, 40)
    q = torch.randn(2, 20, 8, generator=g)
    assert band_attention.band_attention(q, q, q, torch.zeros(21, 8),
                                         torch.zeros(21, 8), torch.tensor([20, 7]),
                                         10).shape == q.shape
    blk = [{"conv1": {"w": torch.randn(16, 1, 3, 3, generator=g), "b": torch.zeros(16)},
            "conv2": {"w": torch.randn(16, 16, 3, 3, generator=g), "b": torch.zeros(16)},
            "shortcut": {"w": torch.randn(16, 1, 1, 1, generator=g), "b": torch.zeros(16)}}]
    assert unet_chain.convblock_chain(torch.randn(1, 1, 8, 16, generator=g),
                                      blk).shape == (1, 16, 8, 16)
    path = viterbi.viterbi_path(torch.randn(12, 360, generator=g), 9)
    assert path.shape == (12,) and path.dtype == torch.int32
    assert viterbi.viterbi_path(torch.zeros(0, 360), 0).shape == (0,)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("method,error,match", [
    ("fcpe", RuntimeError, "fcpe weights not loaded"),
    ("harvest", ValueError, "unknown f0 method: harvest"),
    ("RMVPE+", ValueError, "unknown f0 method: RMVPE\\+"),
])
def test_f0_method_names_outside_the_port(port_vc, method, error, match):
    """fcpe on a converter built without FCPE weights raises as the JAX
    package's fcpe_f0 does; a name the JAX package rejects (f0_dispatch:
    "unknown f0 method") raises ValueError here too."""
    with pytest.raises(error, match=match):
        port_vc.convert(_bench_song(1.0), ConversionOptions(f0_method=method))
