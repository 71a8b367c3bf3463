"""The spans and counters of the port's FCPE pass, on the CPU.

A tiny FCPE's pass through ``VoiceConverter.compute_f0``, profiled, on
both paths: the device path (the FCPE hop equals the engine's window) and
the host path (another hop). Its three parts nest under ``polgen.fcpe``,
and the frame counters read the bucket's mel frames against the padded
signal's."""

import copy
import dataclasses

import pytest
import torch

from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
from polgen_rvc_tpu_torch.utils import tracing
from test_torch_pipeline import _bench_song, one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_tracing import nesting, profiled

PARTS = {"polgen.fcpe.mel", "polgen.fcpe.net", "polgen.fcpe.decode"}
BUCKET = 1024 * 160          # one whole F0 frame bucket of the buffer
PADDED = 48_000              # samples of padded signal in it


@pytest.fixture(scope="module")
def vc():
    return build_synthetic_converter(tiny=True, sr=48000, device="cpu", with_fcpe=True)


def _buffer():
    buf = torch.zeros(BUCKET)
    song = _bench_song(3.0)[:PADDED]
    buf[:PADDED] = torch.from_numpy(song)
    return buf


def _pass(vc, hop):
    """One profiled FCPE pass at the given FCPE hop: (spans, what the
    counters gained)."""
    vc = copy.copy(vc)
    vc.fcpe_cfg = dataclasses.replace(vc.fcpe_cfg, hop_size=hop)
    before = tracing.counters()
    _, spans = profiled(lambda: vc.compute_f0(_buffer(), ConversionOptions(f0_method="fcpe"),
                                              PADDED))
    after = tracing.counters()
    gained = {k: after.get(k, 0) - before.get(k, 0)
              for k in ("fcpe_frames_computed", "fcpe_frames_valid")}
    return spans, gained


@pytest.mark.parametrize("hop", [160, 320], ids=["device_path", "host_path"])
def test_fcpe_parts_nest_under_the_pass(vc, hop):
    spans, _ = _pass(vc, hop)
    assert nesting(spans) == {(None, "polgen.fcpe")} | {("polgen.fcpe", p) for p in PARTS}
    for part in PARTS:
        assert sum(s[0] == part for s in spans) == 1, part


@pytest.mark.parametrize("hop, computed, valid", [
    # the device path's mel covers the whole buffer: BUCKET // 160 + 1
    # frames, PADDED // 160 + 1 of them valid
    (160, BUCKET // 160 + 1, PADDED // 160 + 1),
    # the host path's mel covers the padded signal, zero-padded to a
    # multiple of 1,024 frames
    (320, 1024, PADDED // 320 + 1),
], ids=["device_path", "host_path"])
def test_fcpe_frame_counters_read_the_bucket(vc, hop, computed, valid):
    _, gained = _pass(vc, hop)
    assert gained == {"fcpe_frames_computed": computed, "fcpe_frames_valid": valid}


def test_no_other_f0_pass_moves_the_fcpe_counters(vc):
    before = tracing.counters()
    vc.compute_f0(_buffer(), ConversionOptions(f0_method="rmvpe+"), PADDED)
    after = tracing.counters()
    for key in ("fcpe_frames_computed", "fcpe_frames_valid"):
        assert after.get(key, 0) == before.get(key, 0)
