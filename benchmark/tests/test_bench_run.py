"""A run end to end on the CPU at tiny widths: the reference against the
port, the result line, the control and planted faults. The harness's
look for a card is skipped by calling run_cell with device="cpu";
run.py itself must refuse to run without a card."""

import os
import subprocess
import sys
import time

import pytest

from benchmark import harness, spec

ROOT = spec.ROOT
CELL = "v2_48k_rmvpe.songs"
V1_CELL = "v1_32k_rmvpe.songs"
CREPE_CELL = "v2_48k_crepe.songs"


def run(config, traffic, *, seed=3, trace=False, seconds=0.5, cell=CELL):
    return harness.run_cell(cell, bench=spec.load_benchmark(), config=config,
                            traffic=traffic, limits=spec.load_limits(cell), seed=seed,
                            seconds=seconds, trace=trace, device="cpu",
                            process_start=time.time())


@pytest.fixture(scope="module")
def traced(request):
    import json

    from benchmark.tests.conftest import DATA

    with open(DATA / "tiny_rmvpe.json") as f:
        config = json.load(f)
    with open(DATA / "tiny_clips.json") as f:
        traffic = json.load(f)
    return run(config, traffic, trace=True)


def test_run_without_a_card_fails_and_prints_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_the_reference_agrees_with_the_port(traced):
    """fp32 engine at tiny widths: every compared song within 0.05 dB, the
    same F0 on every frame, the same length."""
    assert traced["checks"]["mel_db"]["value"] < 0.05
    assert traced["checks"]["f0_mismatch_pct"]["value"] == 0
    assert traced["checks"]["length_diff"]["value"] == 0
    assert traced["correct"] is True and traced["failed"] == 0


def test_the_reference_agrees_with_the_port_on_v1(tiny, tiny_v1):
    """v1 32 kHz rates at tiny widths (five decoder stages, HuBERT's
    final_proj into a 16-wide content): as close as v2."""
    _, mixes = tiny
    result = run(tiny_v1, mixes["tiny_clips"], seed=6, cell=V1_CELL)
    assert result["checks"]["mel_db"]["value"] < 0.05
    assert result["checks"]["f0_mismatch_pct"]["value"] == 0
    assert result["checks"]["length_diff"]["value"] == 0
    assert result["correct"] is True and result["failed"] == 0


def test_result_line_keys(traced):
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks"]
    assert set(traced["device"]) >= {"platform", "kind", "count", "memory_peak_bytes",
                                     "busy_s", "window_s"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "mfu" in traced["metrics"]
    for name, c in traced["checks"].items():
        assert set(c) == {"value", "limit"}, name


def test_untraced_line_carries_end_to_end_metrics(tiny):
    config, mixes = tiny
    result = run(config, mixes["tiny_clips"], seed=4)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"rtf", "setup_s"}
    assert result["metrics"]["rtf"]["unit"] == "audio_s/s"


def _control_fails(config, traffic, cell, operand="fp8"):
    from benchmark.control import judge_control

    limits = spec.load_limits(cell)
    for seed in (1, 2, 3):
        got = judge_control(config, traffic, seed, "cpu", operand)
        assert any(got[name] > lim["limit"] for name, lim in limits.items()), got


def test_the_control_fails_a_limit(tiny):
    """The reference in fp8 operands put in the program's place, judged as a
    run judges the program: it fails at least one of the cell's limits."""
    config, mixes = tiny
    _control_fails(config, mixes["tiny_clips"], CELL)


def test_the_control_fails_a_v1_limit(tiny, tiny_v1):
    _control_fails(tiny_v1, tiny[1]["tiny_clips"], V1_CELL)


def _zero_middle(fn):
    def altered(self, *args, **kwargs):
        audio, sr = fn(self, *args, **kwargs)
        audio = audio.copy()
        n = len(audio)
        audio[n // 3: n // 3 + max(n // 10, 1)] = 0
        return audio, sr
    return altered


def _drop_half(fn):
    def dropped(self, *args, **kwargs):
        out = fn(self, *args, **kwargs).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return dropped


def _plant(monkeypatch, fault):
    from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter

    if fault == "answer_altered":
        monkeypatch.setattr(VoiceConverter, "_finish_song",
                            _zero_middle(VoiceConverter._finish_song))
    else:
        monkeypatch.setattr(VoiceConverter, "_chunk_batch",
                            _drop_half(VoiceConverter._chunk_batch))


FAULTS = ["answer_altered", "half_batch_left_out"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_path_is_not_correct(tiny, monkeypatch, fault):
    config, mixes = tiny
    _plant(monkeypatch, fault)
    result = run(config, mixes["tiny_songs"], seed=5)
    assert result["correct"] is False
    assert result["checks"]["mel_db"]["value"] > result["checks"]["mel_db"]["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_v1_path_is_not_correct(tiny, tiny_v1, monkeypatch, fault):
    _plant(monkeypatch, fault)
    result = run(tiny_v1, tiny[1]["tiny_songs"], seed=5, cell=V1_CELL)
    assert result["correct"] is False
    assert result["checks"]["mel_db"]["value"] > result["checks"]["mel_db"]["limit"]


@pytest.fixture
def tiny_crepe():
    """The tiny widths with torchcrepe's "tiny" capacity for mangio-crepe."""
    import json

    from benchmark.tests.conftest import DATA

    with open(DATA / "tiny_crepe.json") as f:
        return json.load(f)


def test_the_reference_agrees_with_the_port_on_crepe(tiny, tiny_crepe):
    """fp32 engine: the program's salience within float16 rounding of the
    reference's, and the reference's decode of it equal to the program's
    track on every frame."""
    result = run(tiny_crepe, tiny[1]["tiny_clips"], seed=3, cell=CREPE_CELL)
    assert result["checks"]["salience_rel_err"]["value"] < 1e-4
    assert result["checks"]["f0_decode_cents_max"]["value"] < 1e-3
    assert result["checks"]["mel_db"]["value"] < 0.05
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("operand", ["fp8", "bf16_decode"])
def test_the_crepe_controls_fail_a_limit(tiny, tiny_crepe, operand):
    """The control of the CREPE net (fp8 operands) and that of its decode
    (bf16 observations and weights) each fail a limit of the cell."""
    _control_fails(tiny_crepe, tiny[1]["tiny_clips"], CREPE_CELL, operand)


def _plant_crepe(monkeypatch, fault):
    """answer_altered: the decode's track one bin (20 cents) high on a
    fiftieth of the frames; half_batch_left_out: the second half of each
    salience slab's frames left at zero."""
    from polgen_rvc_tpu_torch.pipeline import crepe_method

    if fault == "answer_altered":
        decode = crepe_method.crepe_f0_decode_device

        def altered(salience, n, **kwargs):
            f0 = decode(salience, n, **kwargs).clone()
            f0[n // 3: n // 3 + max(n // 50, 1)] *= 2.0 ** (20.0 / 1200.0)
            return f0
        monkeypatch.setattr(crepe_method, "crepe_f0_decode_device", altered)
    else:
        window = crepe_method.crepe_salience_window

        def dropped(*args, **kwargs):
            sal = window(*args, **kwargs).clone()
            sal[sal.shape[0] // 2:] = 0
            return sal
        monkeypatch.setattr(crepe_method, "crepe_salience_window", dropped)


@pytest.mark.parametrize("fault, number", [("answer_altered", "f0_decode_cents_max"),
                                           ("half_batch_left_out", "salience_rel_err")])
def test_a_broken_crepe_path_is_not_correct(tiny, tiny_crepe, monkeypatch, fault, number):
    _plant_crepe(monkeypatch, fault)
    result = run(tiny_crepe, tiny[1]["tiny_clips"], seed=5, cell=CREPE_CELL)
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]
