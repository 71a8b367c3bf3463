"""FCPE in the benchmark at tiny widths on the CPU: the port against the
plain reference (benchmark/reference/fcpe.py) on seeded random weights,
the weights through the port's checkpoint conversion, the operation and
byte counts against hand counts, the two metric readers, and the cell's
limits against both controls and two planted faults.

Tiny widths: 2 layers at 64 channels; every other width as published."""

import json
import time
import types

import numpy as np
import pytest
import torch

from benchmark import f0, harness, spec
from benchmark.reference import fcpe as ref
from benchmark.reference.convert import padded_buffer
from benchmark.reference.f0 import f0_cents_max, salience_rel_err
from benchmark.reference.ops import Ops
from benchmark.reference.signal import Engine
from benchmark.tests.conftest import DATA
from benchmark.tests.test_bench_work import window
from benchmark.weights import Normals

CELL = "v2_48k_fcpe.songs"
FCPE = f0.find("fcpe")


@pytest.fixture(scope="module")
def tiny_fcpe():
    with open(DATA / "tiny_fcpe.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def clips():
    with open(DATA / "tiny_clips.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def model(tiny_fcpe):
    """(fcpe.pt state dict, the port's parameters on the CPU, its FcpeConfig)
    from seeded random weights."""
    from polgen_rvc_tpu_torch.convert.params import params_to_torch

    sd = FCPE.make_weights(Normals(torch.Generator().manual_seed(11), "cpu"), tiny_fcpe)
    args = FCPE.program_params(sd, tiny_fcpe)
    return sd, params_to_torch(args["fcpe_params"], torch.device("cpu")), args["fcpe_cfg"]


@pytest.fixture(scope="module")
def song(tiny_fcpe):
    """A 6 s sung tone through the harness's high-pass, pad and quantize:
    (the zero-tailed buffer, its padded length, n = padded_len // 160 + 1)."""
    t = np.arange(6 * 16000) / 16000
    x = (0.3 * np.sin(2 * np.pi * 220 * t * (1 + 0.03 * np.sin(2 * np.pi * 5 * t)))
         + 0.01 * np.random.default_rng(0).standard_normal(t.size)).astype(np.float32)
    buf, padded_len = padded_buffer(x, Engine(**tiny_fcpe["engine"]), "cpu")
    return buf, padded_len, padded_len // 160 + 1


def test_the_fcpe_model_is_found_with_its_stage_judge():
    for part in ("make_weights", "program_params", "stated_operands", "reference_f0",
                 "flops", "program_tap", "intermediate", "checks"):
        assert callable(getattr(FCPE, part)), part


def test_make_weights_loads_through_convert_fcpe_state(tiny_fcpe, model):
    """fcpe.pt's layout: every key and shape of the port's own synthetic
    FCPE state at the same widths, and the port's conversion of it gives
    the reference's weights (the weight norm folded within rounding)."""
    from polgen_rvc_tpu_torch.convert.fcpe_ckpt import make_fcpe_state

    sd, params, cfg = model
    _, own = make_fcpe_state(tiny=True)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: v.shape for k, v in own.items()}
    assert (cfg.n_layers, cfg.n_chans, cfg.hop_size, cfg.f0_min) == (2, 64, 160, 32.70)
    layer = params["layers"][1]
    assert torch.equal(layer["attn"]["projection_matrix"],
                       sd["decoder._layers.1.attn.fast_attention.projection_matrix"])
    assert torch.equal(layer["conformer"]["depthwise"]["w"],
                       sd["decoder._layers.1.conformer.net.4.conv.weight"])
    torch.testing.assert_close(params["dense_out"]["w"], ref.dense_weight(sd).T,
                               rtol=1e-6, atol=1e-7)


def test_the_port_matches_the_reference_on_one_input(tiny_fcpe, model, song):
    """The app's input, buf[:padded_len], through both: the log-mel within
    1e-4 (two FFT paths and two Slaney filterbanks in float32, the RMVPE
    mel's precedent; 1.8e-5 read), the salience within 1e-5 of its norm
    (float32 in another order; 1.6e-7 read)."""
    from polgen_rvc_tpu_torch.models import fcpe as port

    sd, params, cfg = model
    buf, padded_len, n = song
    m = tiny_fcpe["fcpe"]
    with torch.no_grad():
        mel = port.fcpe_mel(buf[:padded_len][None], cfg)[0]
        ref_mel = ref.log_mel(buf[:padded_len], m)
        assert mel.shape == ref_mel.shape == (n, m["num_mels"])
        assert float((mel - ref_mel).abs().max()) < 1e-4
        got = port.fcpe_salience(params, cfg, ref_mel[None])[0]
    assert salience_rel_err(got, ref.salience(sd, m, ref_mel, Ops(None))) < 1e-5


def test_the_bucket_form_against_the_unpadded_reference(tiny_fcpe, model, song):
    """The port's pass reads the whole zero-tailed buffer and masks the
    frames past n (n_valid); the reference runs over n frames alone.
    Fed the same n mel frames, every frame within 1e-5 of the norm: the
    mask leaves nothing of the padding. Fed each its own input (the
    buffer; the app's buf[:padded_len]), which differ in the last few
    frames' mel windows by design, the frames beyond those windows' reach
    through the convs (two k3 convs, then 15 frames a layer) within 1e-3:
    the edge frames still enter every frame through the GroupNorm
    statistics and FAVOR+'s sums over all frames, at about 1 part in n
    (4e-5 read). Without the mask, the padding reads over 1e-2."""
    from polgen_rvc_tpu_torch.models import fcpe as port

    sd, params, cfg = model
    buf, padded_len, n = song
    m = tiny_fcpe["fcpe"]
    with torch.no_grad():
        mel = port.fcpe_mel(buf[None], cfg)
        assert mel.shape[1] == buf.shape[0] // 160 + 1 > n
        got = port.fcpe_salience(params, cfg, mel, n_valid=n)[0, :n]
        unmasked = port.fcpe_salience(params, cfg, mel)[0, :n]
    same = ref.padded_salience(sd, m, buf, padded_len, Ops(None))
    assert salience_rel_err(got, same) < 1e-5
    assert salience_rel_err(unmasked, same) > 1e-2
    app = ref.salience(sd, m, ref.log_mel(buf[:padded_len], m), Ops(None))
    # the first frame whose window reaches past padded_len, less the convs' reach
    edge = -(-(padded_len - m["win_size"] + (m["win_size"] - m["hop_size"]) // 2 + 1)
             // m["hop_size"])
    keep = edge - 2 - m["n_layers"] * (m["kernel"] // 2)
    assert 0 < keep < n
    assert salience_rel_err(got[:keep], app[:keep]) < 1e-3
    assert salience_rel_err(got, app) > salience_rel_err(got[:keep], app[:keep])


def test_the_port_track_matches_the_reference_decode(tiny_fcpe, model, song):
    """The port's device path against the reference's decode, resize and
    fill of the port's own salience: within 0.01 cents on every frame (the
    port fills the gaps in float32, the description with np.interp in
    float64; 0.002 read). Zeros from padded_len // 160 on both."""
    from polgen_rvc_tpu_torch.models import fcpe as port
    from polgen_rvc_tpu_torch.pipeline.fcpe_method import fcpe_f0_device

    _, params, cfg = model
    buf, padded_len, n = song
    p_len = padded_len // 160
    with torch.no_grad():
        got = fcpe_f0_device(params, cfg, buf, padded_len, p_len)
        sal = port.fcpe_salience(params, cfg, port.fcpe_mel(buf[None], cfg), n_valid=n)[0, :n]
    want = ref.track(sal, tiny_fcpe["fcpe"], padded_len, buf.shape[0] // 160 + 1)
    assert got.shape == want.shape
    assert f0_cents_max(got, want, p_len) < 0.01
    assert torch.all(got[p_len:] == 0) and torch.all(want[p_len:] == 0)
    assert float((want[:p_len] > 0).double().mean()) > 0.5


def test_flops_against_a_count_by_hand():
    """The published widths on a 240 s song's 24,201 valid frames."""
    config = spec.load_config("v2_48k_fcpe")
    padded_len = (240 + 2) * 16000
    mel = 2 * 128 * 513
    stack = 2 * 3 * 128 * 512 + 2 * 3 * 512 * 512
    projections = 4 * 2 * 512 * 512
    features = 2 * (2 * 8 * 64 * 266)
    attention = 2 * 8 * 266 * 64 + 2 * 8 * 266 * 64 + 2 * 8 * 266
    conformer = 2 * 512 * 2048 + 2 * 1024 * 31 + 2 * 1024 * 512
    head = 2 * 512 * 360
    per_frame = mel + stack + 12 * (projections + features + attention + conformer) + head
    assert per_frame == 79_267_968
    assert FCPE.flops(config, None, padded_len) == {"float32": 24_201 * per_frame}


def test_fcpe_roofline_counts(tiny_fcpe):
    """Bytes: each layer's activations read and written once, the mel read,
    the salience written, every weight once a song; the weight count is
    make_weights' at the published widths (33.3 M)."""
    metric = spec.load_metric("fcpe_roofline")
    config = spec.load_config("v2_48k_fcpe")
    weights = FCPE.make_weights(Normals(torch.Generator().manual_seed(1), "cpu"), config)
    assert metric.weight_count(config["fcpe"]) == sum(t.numel() for t in weights.values()) \
        == 33_305_808
    flops, nbytes = metric.work(config, None, window([], padded_len=48_000))
    n = 48_000 // 160 + 1
    assert flops == FCPE.flops(config, None, 48_000)["float32"]
    assert nbytes == 4 * n * (128 + 512 + 2 * 12 * 512 + 360) + 4 * 33_305_808
    trace = types.SimpleNamespace(kernel_ns=lambda match=None, phase=None:
                                  2e6 if phase == "_prepare_song" else 0.0)
    ctx = types.SimpleNamespace(config=config, engine=None, trace=trace,
                                traced=window([], padded_len=48_000))
    assert metric.read(ctx) == pytest.approx(100.0 * flops / 67e12 / 2e-3)
    no_fcpe = {k: v for k, v in tiny_fcpe.items() if k != "fcpe"}
    assert metric.read(types.SimpleNamespace(**{**vars(ctx), "config": no_fcpe})) is None


def test_fcpe_padding_share_reads_the_counters(model, song, monkeypatch):
    from polgen_rvc_tpu_torch.pipeline.fcpe_method import fcpe_f0_device
    from polgen_rvc_tpu_torch.utils import tracing

    metric = spec.load_metric("fcpe_padding_share")
    monkeypatch.setattr(tracing, "_COUNTERS", {})
    assert metric.read(None) is None
    _, params, cfg = model
    buf, padded_len, n = song
    with torch.no_grad():
        fcpe_f0_device(params, cfg, buf, padded_len, padded_len // 160)
    computed = buf.shape[0] // 160 + 1
    assert metric.read(None) == pytest.approx(100.0 * (1 - n / computed))


def run(config, traffic, seed):
    return harness.run_cell(CELL, bench=spec.load_benchmark(), config=config, traffic=traffic,
                            limits=spec.load_limits(CELL), seed=seed, seconds=0.5, trace=False,
                            device="cpu", process_start=time.time())


def test_the_reference_agrees_with_the_port(tiny_fcpe, clips):
    """float32 on the CPU: the salience within 1e-5 of its norm, the decode
    within 0.01 cents, the audio within 0.05 dB."""
    result = run(tiny_fcpe, clips, seed=3)
    assert result["checks"]["salience_rel_err"]["value"] < 1e-5
    assert result["checks"]["f0_decode_cents_max"]["value"] < 0.01
    assert result["checks"]["mel_db"]["value"] < 0.05
    assert result["checks"]["length_diff"]["value"] == 0
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("operand", ["fp8", "bf16_decode"])
def test_the_controls_fail_a_limit(tiny_fcpe, clips, operand):
    """The net's control (fp8 operands) and the decode's (its salience in
    bf16) each fail a limit of the cell, on every seed."""
    from benchmark.control import judge_control

    limits = spec.load_limits(CELL)
    for seed in (1, 2, 3):
        got = judge_control(tiny_fcpe, clips, seed, "cpu", operand)
        assert any(got[name] > lim["limit"] for name, lim in limits.items()), got


def _plant(monkeypatch, fault):
    """decode: the track one bin (~15 cents) high on a fiftieth of the
    frames; salience: the second half of the signal's frames at zero."""
    from polgen_rvc_tpu_torch.pipeline import fcpe_method

    if fault == "decode":
        resize = fcpe_method.fcpe_resize_fill

        def altered(f0, n, p_len):
            out = resize(f0, n, p_len).clone()
            out[p_len // 3: p_len // 3 + max(p_len // 50, 1)] *= 2.0 ** (15.0 / 1200.0)
            return out
        monkeypatch.setattr(fcpe_method, "fcpe_resize_fill", altered)
    else:
        net = fcpe_method.fcpe_salience

        def dropped(*args, n_valid=None, **kwargs):
            sal = net(*args, n_valid=n_valid, **kwargs).clone()
            sal[:, n_valid // 2:] = 0
            return sal
        monkeypatch.setattr(fcpe_method, "fcpe_salience", dropped)


@pytest.mark.parametrize("fault, number", [("decode", "f0_decode_cents_max"),
                                           ("salience", "salience_rel_err")])
def test_a_broken_fcpe_pass_is_not_correct(tiny_fcpe, clips, monkeypatch, fault, number):
    _plant(monkeypatch, fault)
    result = run(tiny_fcpe, clips, seed=5)
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]
