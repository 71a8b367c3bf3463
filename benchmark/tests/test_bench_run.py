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


def run(config, traffic, *, seed=3, trace=False, seconds=0.5):
    return harness.run_cell(CELL, bench=spec.load_benchmark(), config=config,
                            traffic=traffic, limits=spec.load_limits(CELL), seed=seed,
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


def test_the_control_fails_a_limit(tiny):
    """The reference in fp8 operands put in the program's place, judged as a
    run judges the program: it fails at least one of the cell's limits."""
    from benchmark.control import judge_control

    config, mixes = tiny
    limits = spec.load_limits(CELL)
    for seed in (1, 2, 3):
        got = judge_control(config, mixes["tiny_clips"], seed, "cpu")
        assert any(got[name] > lim["limit"] for name, lim in limits.items()), got


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


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
def test_a_broken_path_is_not_correct(tiny, monkeypatch, fault):
    from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter

    config, mixes = tiny
    if fault == "answer_altered":
        monkeypatch.setattr(VoiceConverter, "_finish_song",
                            _zero_middle(VoiceConverter._finish_song))
    else:
        monkeypatch.setattr(VoiceConverter, "_chunk_batch",
                            _drop_half(VoiceConverter._chunk_batch))
    result = run(config, mixes["tiny_songs"], seed=5)
    assert result["correct"] is False
    assert result["checks"]["mel_db"]["value"] > result["checks"]["mel_db"]["limit"]
