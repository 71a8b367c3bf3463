"""The system under test: the port's ``VoiceConverter``, built from the
benchmark's raw weights through the port's own checkpoint conversions,
as ``build_converter`` builds it from a user's files."""

from __future__ import annotations

import contextlib

import numpy as np

from . import f0


def build_converter(weights: dict, config: dict, device):
    from polgen_rvc_tpu_torch.convert.hubert_ckpt import convert_hubert_state
    from polgen_rvc_tpu_torch.convert.rvc_ckpt import build_config, convert_synthesizer_state
    from polgen_rvc_tpu_torch.models.hubert import HubertConfig
    from polgen_rvc_tpu_torch.pipeline.config import EngineConfig
    from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter

    syn = config["synthesizer"]
    config_list = list(syn["config"])
    # as the .pth loader does: the speaker count comes from the embedding
    config_list[-3] = weights["rvc"]["emb_g.weight"].shape[0]
    synth_cfg = build_config(config_list, use_f0=bool(syn["f0"]), version=syn["version"])
    h = config["hubert"]
    hub_cfg = HubertConfig(
        conv_layers=tuple(tuple(c) for c in h["conv_layers"]), embed_dim=h["embed_dim"],
        ffn_dim=h["ffn_dim"], n_heads=h["n_heads"], n_layers=h["n_layers"],
        pos_conv_kernel=h["pos_conv_kernel"], pos_conv_groups=h["pos_conv_groups"],
        final_dim=h["final_dim"])
    f0_model = f0.model(config)
    f0_params = ({} if f0_model is None
                 else f0_model.program_params(weights[config["f0_model"]], config))
    bank = weights.get("index")
    return VoiceConverter(
        synth_cfg=synth_cfg,
        synth_params=convert_synthesizer_state(weights["rvc"], synth_cfg),
        hubert_cfg=hub_cfg, hubert_params=convert_hubert_state(weights["hubert"], hub_cfg),
        **f0_params,
        index_bank=None if bank is None else np.ascontiguousarray(bank.cpu().numpy()),
        engine=EngineConfig(**config["engine"]), device=device)


def conversion_options(config: dict, seed: int):
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions

    return ConversionOptions(**config["options"], seed=int(seed))


def entry(vc, name: str):
    """The timed entry: name "convert" (one song a call) or
    "convert_batch" (the call's songs packed), as fn(songs, opts) ->
    [int16 audio per song]."""
    if name == "convert":
        return lambda songs, opts: [vc.convert(s, opts)[0] for s in songs]
    if name == "convert_batch":
        return lambda songs, opts: [a for a, _ in vc.convert_batch(songs, opts)]
    raise ValueError(f"unknown entry {name!r}")


@contextlib.contextmanager
def f0_tap(sink: list, config: dict):
    """While open, every VoiceConverter._prepare_song appends to sink the
    pair (the song's shifted F0 track, its ``pitchf``, None without F0;
    what the F0 module's program_tap caught in the song's pass, or None):
    the state the reference's synthesizer reads in the judge, and the
    stage the F0 module's checks judge. Keeps references, no copies."""
    from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter

    orig = VoiceConverter.__dict__["_prepare_song"]
    inner = getattr(f0.model(config), "program_tap", None)

    def tapped(self, *args, **kwargs):
        caught = []
        with inner(caught) if inner else contextlib.nullcontext():
            song = orig(self, *args, **kwargs)
        sink.append((song.pitchf, caught[-1] if caught else None))
        return song

    VoiceConverter._prepare_song = tapped
    try:
        yield
    finally:
        VoiceConverter._prepare_song = orig


def kernel_counts() -> dict:
    from polgen_rvc_tpu_torch.ops import cuda_build

    return cuda_build.counts()


def converter_class():
    from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter

    return VoiceConverter
