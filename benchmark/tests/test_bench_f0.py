"""The F0 models found by name (benchmark/f0/), and what the harness makes
for each configuration pinned: its weights from one seed, byte for byte,
and mfu's operation counts on one fixed window. The pins were taken
before the F0 models moved into benchmark/f0/; a change that moves them
changes what every cell reads."""

import hashlib

import pytest

from benchmark import f0, spec
from benchmark.reference.signal import Engine
from benchmark.tests.test_bench_work import window
from benchmark.weights import make_weights

SEED = 3_050_000_011

# sha256 over every leaf's key, dtype, shape and bytes, in the order made
# (torch's CPU generator; full widths)
WEIGHTS_SHA256 = {
    "v2_48k_rmvpe": "59067092c894804a19598fa0f006fcbb821076e68fa125055a0aef2ef316e142",
    "v2_48k_crepe": "1850b6161b4f7cb75367432e61aab603baff1e957e3c38c97630a2eb5984fc63",
    "v1_32k_rmvpe": "d1a830cc5986f98d5d4c027c4d6da2f0b2b7fb77994a9c8e95e69d3bbfb8dabe",
}

# {dtype: operations} of mfu.flops over two songs' worth of chunks
MFU_FLOPS = {
    "v2_48k_rmvpe": {"bfloat16": 6948898462720.0, "float32": 275946673152.0},
    "v2_48k_crepe": {"bfloat16": 24485741943808.0, "float32": 264737390592.0},
    "v1_32k_rmvpe": {"bfloat16": 3737814890496.0, "float32": 105691485184.0},
}


def weights_sha256(weights: dict) -> str:
    h = hashlib.sha256()
    for part, leaves in weights.items():
        if not isinstance(leaves, dict):
            leaves = {"": leaves}
        for key, t in leaves.items():
            h.update(f"{part}/{key}:{t.dtype}:{tuple(t.shape)};".encode())
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def mfu_window():
    return window([480_000 + 32_160, 300_000], padded_len=812_000, batches=1)


@pytest.mark.parametrize("name", sorted(WEIGHTS_SHA256))
def test_weights_are_pinned(name):
    weights = make_weights(spec.load_config(name), SEED, "cpu")
    assert weights_sha256(weights) == WEIGHTS_SHA256[name]


@pytest.mark.parametrize("name", sorted(MFU_FLOPS))
def test_mfu_counts_are_pinned(name):
    config = spec.load_config(name)
    got = spec.load_metric("mfu").flops(config, Engine(**config["engine"]), mfu_window())
    assert got == MFU_FLOPS[name]


@pytest.mark.parametrize("name", ["rmvpe", "crepe"])
def test_f0_models_are_found_by_name(name):
    mod = f0.find(name)
    for part in ("make_weights", "program_params", "stated_operands", "reference_f0",
                 "flops"):
        assert callable(getattr(mod, part)), part
    # CREPE's track is judged stage by stage; RMVPE's against the reference's
    stages = ("program_tap", "intermediate", "checks")
    assert all(callable(getattr(mod, part, None)) for part in stages) == (name == "crepe")


def test_an_unknown_f0_model_is_refused():
    for name in ("fcpe2", "../weights", "", "RMVPE"):
        with pytest.raises(ValueError):
            f0.find(name)


def test_no_f0_model_makes_no_f0_weights(tiny):
    config, _ = tiny
    del config["f0_model"]
    config["synthesizer"]["f0"] = 0
    assert f0.model(config) is None
    assert list(make_weights(config, 1, "cpu")) == ["rvc", "hubert", "index"]


@pytest.mark.parametrize("frames, shift, low, high", [
    (0, 0.0, 0.0, 0.0021),          # rounding alone
    (1, 20.0, 19.0, 21.0),          # one bin off on one frame
    (364, 20.0, 19.0, 21.0),        # one bin off on 2% of the frames
    (1, 1200.0, 1200.0, 1200.0),    # one frame unvoiced on one side
])
def test_f0_cents_max_sees_a_fault_on_any_frame(frames, shift, low, high):
    """The decode stage is compared on the same salience, so rounding alone
    reads ~0.002 cents, and a fault on a single frame reads in full."""
    import torch

    from benchmark.reference.f0 import f0_cents_max

    ref = torch.full((18_200,), 220.0, dtype=torch.float64)
    got = ref * 2.0 ** (0.002 / 1200)
    assert f0_cents_max(got, ref, 18_200) == pytest.approx(0.002, rel=1e-6)
    if shift >= 1200.0:
        got[1000:1000 + frames] = 0.0
    else:
        got[1000:1000 + frames] *= 2.0 ** (shift / 1200)
    assert low <= f0_cents_max(got, ref, 18_200) <= high
    assert f0_cents_max(got, ref, 1000) == pytest.approx(0.002, rel=1e-6)


def test_salience_rel_err():
    import torch

    from benchmark.reference.f0 import salience_rel_err

    ref = torch.rand(500, 360, generator=torch.Generator().manual_seed(0)) + 0.1
    assert salience_rel_err(ref, ref) == 0.0
    assert salience_rel_err(ref * 1.001, ref) == pytest.approx(1e-3, rel=1e-3)
    half = ref.clone()
    half[250:] = 0.0
    assert salience_rel_err(half, ref) > 0.5
    assert salience_rel_err(ref[:499], ref) == float("inf")
