"""The reference conversion of one song: the plain path a timed call's
output is judged against.

Per song: high-pass, pad and quantize, the chunk plan, one F0 pass over
the padded buffer (the configuration's F0 model, by its module in
``benchmark/f0/``), the pitch shift and coarse bins. Per chunk, alone
and at its own length (the port's masked models give a chunk the same
values whatever bucket and batch it rides):
HuBERT, the retrieval blend, the 2x frame repeat, the protect mix, the
synthesizer with the chunk's noise (re-drawn from the seed formula
seed * 1,000,003 + chunk id on the same device), the pad trim. Then the
RMS envelope over the whole song and the int16 output. float32, TF32
off, but where the configuration states another operand precision;
``Ops("fp8")`` gives the control.

The synthesizer may read another F0 track than the reference's own (the
judge passes the one the program computed): the argmax of a random-weight
RMVPE's flat salience is decided by rounding, so no independent path can
reproduce the program's pitch frame for frame; the F0 pass is then judged
by itself (f0.f0_mismatch_pct), or stage by stage where its module has
checks (CREPE, benchmark/f0/crepe.py)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..f0 import find, model as f0_model
from . import f0 as f0_mod
from .models import hubert, retrieval_blend, synthesize
from .ops import Ops
from .signal import (
    Engine, change_rms, highpass_pad_quant, hubert_frames, noise_frames,
    pack_and_finalize, plan_chunks,
)


def chunk_noise(seed: int, chunk_id: int, inter: int, frames: int, upp: int, device):
    """The chunk's latent noise (inter, frames) and source noise
    (frames * upp,), drawn in that order from one generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + int(chunk_id))
    eps = torch.randn((inter, frames), generator=gen, device=device)
    return eps, torch.randn(frames * upp, generator=gen, device=device)


def stated_ops(config: dict) -> Ops:
    """The reference's products at the precisions the configuration states:
    float32, but where its F0 model's entry states another (RMVPE's U-Net
    operands)."""
    model = f0_model(config)
    return Ops(None, **({} if model is None else model.stated_operands(config)))


def _dequant(qbuf, inv_scale, device):
    return torch.from_numpy(qbuf).to(device).float() * float(inv_scale)


def padded_buffer(audio16k: np.ndarray, eng: Engine, device):
    """(the song's high-passed, padded and quantized buffer on device, as
    float32, its padded length): what the F0 pass reads."""
    _, qbuf, inv_scale, padded_len = highpass_pad_quant(audio16k, eng.t_pad, eng.window)
    return _dequant(qbuf, inv_scale, device), padded_len


@torch.no_grad()
def reference_convert(weights: dict, config: dict, audio16k: np.ndarray, opts: dict,
                      seed: int, device, ops: Ops = None, f0_track=None):
    """Float 16 kHz audio -> (the int16 output the configuration gives it,
    the reference's own shifted F0 track over the padded buffer's frames,
    or None for a no-f0 model).

    weights: make_weights' raw state dicts on `device`; ops: stated_ops by
    default, Ops("fp8") for the control. f0_track: the shifted F0 (Hz per
    frame of the padded buffer) that the synthesizer is to read instead of
    the reference's own; its coarse bins are worked out again here."""
    ops = stated_ops(config) if ops is None else ops
    eng = Engine(**config["engine"])
    syn = config["synthesizer"]
    cfg, use_f0 = syn["config"], bool(syn["f0"])
    hcfg = config["hubert"]
    upp, tgt_sr = math.prod(cfg[12]), cfg[17]
    audio, qbuf, inv_scale, padded_len = highpass_pad_quant(audio16k, eng.t_pad, eng.window)
    chunks = plan_chunks(audio, eng)
    buf = _dequant(qbuf, inv_scale, device)
    pitch = pitchf = None
    if use_f0:
        f0 = find(config["f0_model"]).reference_f0(weights[config["f0_model"]], config, buf,
                                                   padded_len, opts, ops)
        pitchf = f0 * float(np.float32(2.0 ** (opts["pitch"] / 12.0)))
    own_f0 = pitchf
    if f0_track is not None:
        pitchf = f0_track.to(device=device, dtype=torch.float32)
    if use_f0:
        pitch = f0_mod.coarse_f0(pitchf, opts["f0_min"], opts["f0_max"])
    v1 = syn["version"] == "v1"
    out_layer = 9 if (v1 and hcfg["n_layers"] >= 9) else hcfg["n_layers"]
    nf = noise_frames(eng, hcfg["conv_layers"])
    t_pad_tgt = tgt_sr * eng.x_pad
    rvc, bank = weights["rvc"], weights.get("index")
    segments = []
    for ci, c in enumerate(chunks):
        length = c.slice_end - c.slice_start
        wav = buf[c.slice_start:c.slice_end]
        hub = hubert_frames(length, hcfg["conv_layers"])
        frames = min(length // eng.window, 2 * hub)
        feats0 = hubert(weights["hubert"], hcfg, wav, ops, out_layer, v1)
        feats = feats0
        if bank is not None and opts["index_rate"] > 0:
            feats = retrieval_blend(feats, bank, float(opts["index_rate"]), eng.retrieval_k)
        feats = feats.repeat_interleave(2, dim=0)[:frames]
        p = pf = None
        if use_f0:
            first = c.slice_start // eng.window
            p, pf = pitch[first:first + frames], pitchf[first:first + frames]
            if opts["protect"] < 0.5:
                keep = torch.where(pf > 0, 1.0, float(opts["protect"]))[:, None]
                feats = feats * keep + feats0.repeat_interleave(2, dim=0)[:frames] * (1 - keep)
        eps, nsf = chunk_noise(seed, ci, cfg[2], nf, upp, device)
        out = synthesize(rvc, cfg, feats, p, pf, int(opts.get("speaker_id", 0)), eps, nsf,
                         eng.noise_scale, ops)
        segments.append(out[t_pad_tgt:max(frames * upp - t_pad_tgt, t_pad_tgt)])
    segments = [s for s in segments if s.shape[0]]
    lens = [s.shape[0] for s in segments]
    out = torch.cat(segments) if segments else buf.new_zeros(0)
    if opts["volume_envelope"] != 1.0 and out.numel():
        src = buf[eng.t_pad:eng.t_pad + audio.shape[0]]
        out = change_rms(src, eng.sample_rate, out, tgt_sr, float(opts["volume_envelope"]))
    return pack_and_finalize(list(torch.split(out, lens))), own_f0
