"""FCPE (torchfcpe; fcpe.pt) for the app's fcpe F0: an input conv stack,
12 conformer layers of Performer linear attention and a depthwise GLU conv
module at 512 wide, a 360-bin head and the local-argmax decode, all in
float32."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..init import fan, linear
from ..reference import f0 as f0_ref
from ..reference import fcpe as fcpe_ref


def _norm(nrm, sd, prefix, c):
    sd[f"{prefix}.weight"] = nrm(c) * 0.01 + 1.0
    sd[f"{prefix}.bias"] = nrm(c) * 0.01


def _conv(nrm, sd, prefix, out_c, in_c, k):
    sd[f"{prefix}.weight"] = nrm(out_c, in_c, k) * fan(in_c, k)
    sd[f"{prefix}.bias"] = nrm(out_c) * 0.02


def make_weights(nrm, config: dict) -> dict:
    """fcpe.pt's "model" state dict (FCPE, PCmer, SelfAttention's
    fast_attention.projection_matrix, the weight-normed dense_out), every
    leaf drawn from the Normals and scaled by its fan-in; the projection
    matrix i.i.d. standard normal."""
    m = config["fcpe"]
    c, inner = m["n_chans"], m["n_chans"] * m["expansion"]
    attn = m["n_heads"] * m["dim_head"]
    sd = {}
    _conv(nrm, sd, "stack.0", c, m["input_channel"], 3)
    _norm(nrm, sd, "stack.1", c)
    _conv(nrm, sd, "stack.3", c, c, 3)
    for i in range(m["n_layers"]):
        p = f"decoder._layers.{i}"
        _norm(nrm, sd, f"{p}.norm", c)
        sd[f"{p}.attn.fast_attention.projection_matrix"] = nrm(m["n_features"], m["dim_head"])
        for name in ("to_q", "to_k", "to_v"):
            linear(nrm, sd, f"{p}.attn.{name}", attn, c)
        linear(nrm, sd, f"{p}.attn.to_out", c, attn)
        _norm(nrm, sd, f"{p}.conformer.net.0", c)
        _conv(nrm, sd, f"{p}.conformer.net.2", 2 * inner, c, 1)
        _conv(nrm, sd, f"{p}.conformer.net.4.conv", inner, 1, m["kernel"])
        _conv(nrm, sd, f"{p}.conformer.net.6", c, inner, 1)
    _norm(nrm, sd, "norm", c)
    v = nrm(m["out_dims"], c) * fan(c)
    sd["dense_out.weight_g"] = ((nrm(m["out_dims"], 1) * 0.2).abs() + 0.8) \
        * v.norm(dim=1, keepdim=True)
    sd["dense_out.weight_v"] = v
    sd["dense_out.bias"] = nrm(m["out_dims"]) * 0.02
    return sd


def checkpoint_config(config: dict) -> dict:
    """fcpe.pt's "config" entry ({"model", "mel"}) for the configuration."""
    m = config["fcpe"]
    return {"model": {k: m[k] for k in ("input_channel", "out_dims", "n_layers", "n_chans",
                                        "f0_min", "f0_max")},
            "mel": {k: m[k] for k in ("sampling_rate", "num_mels", "n_fft", "win_size",
                                      "hop_size", "fmin", "fmax")}}


def program_params(state: dict, config: dict) -> dict:
    from polgen_rvc_tpu_torch.convert.fcpe_ckpt import build_fcpe_config, convert_fcpe_state

    cfg = build_fcpe_config(checkpoint_config(config))
    return {"fcpe_params": convert_fcpe_state(state, cfg), "fcpe_cfg": cfg}


def stated_operands(config: dict) -> dict:
    """float32 everywhere: nothing to round."""
    return {}


def reference_f0(state: dict, config: dict, buf, padded_len: int, opts: dict, ops):
    """fcpe over the padded signal: salience, decode, resize, fill."""
    return fcpe_ref.fcpe_f0(state, config["fcpe"], buf, padded_len, ops)


@contextlib.contextmanager
def program_tap(sink: list):
    """While open, each salience the port's fcpe pass hands to its decode
    (the bucket's frames x 360, float32, pipeline/fcpe_method.py) is
    appended to sink: a reference to the tensor, no copy."""
    from polgen_rvc_tpu_torch.pipeline import fcpe_method

    orig = fcpe_method.fcpe_decode

    def tapped(salience, *args, **kwargs):
        sink.append(salience[0])
        return orig(salience, *args, **kwargs)

    fcpe_method.fcpe_decode = tapped
    try:
        yield
    finally:
        fcpe_method.fcpe_decode = orig


def intermediate(state: dict, config: dict, buf, padded_len: int, opts: dict, ops):
    """The reference's counterpart of what program_tap catches: the
    salience of the padded signal's n = padded_len // hop + 1 frames, the
    net run over those frames alone, with no bucket and no mask."""
    return fcpe_ref.padded_salience(state, config["fcpe"], buf, padded_len, ops)


@torch.no_grad()
def checks(state: dict, config: dict, buf, padded_len: int, opts: dict, ops,
           got_f0, got_salience, frames: int) -> dict:
    """The F0 pass judged in its two stages, since a random-weight FCPE's
    salience has near-ties at its peak (the top two bins 0.02 apart at
    the median frame, on the CPU at published widths), which leave the
    local argmax of some frames to rounding, and such a frame's F0 moves
    by up to hundreds of cents:
      salience_rel_err     the program's salience on the padded signal's
                           n frames against the reference's of the same
                           frames (intermediate; ||got - ref|| / ||ref||)
      f0_decode_cents_max  the program's F0 track against the reference's
                           decode, resize and fill of the program's own
                           salience, the largest error in cents over the
                           frames"""
    ref_sal = intermediate(state, config, buf, padded_len, opts, ops)
    sal = got_salience[:ref_sal.shape[0]].to(ref_sal.device).float()
    shift = float(np.float32(2.0 ** (opts["pitch"] / 12.0)))
    decoded = fcpe_ref.track(sal, config["fcpe"], padded_len, buf.shape[0] // 160 + 1) * shift
    return {"salience_rel_err": f0_ref.salience_rel_err(sal, ref_sal),
            "f0_decode_cents_max": f0_ref.f0_cents_max(got_f0.to(decoded.device), decoded,
                                                       frames)}


def frame_flops(m: dict) -> dict:
    """Operations a frame, by part: the mel filterbank, the input stack,
    one layer's projections (q, k, v, out), FAVOR+ feature maps (queries and
    keys), linear attention (context, output, denominator) and conformer
    (1x1 in, depthwise, 1x1 out), and the head. Products only."""
    c, h, d, f = m["n_chans"], m["n_heads"], m["dim_head"], m["n_features"]
    inner = c * m["expansion"]
    return {"mel": 2 * m["num_mels"] * (m["n_fft"] // 2 + 1),
            "stack": 2 * 3 * c * (m["input_channel"] + c),
            "projections": 4 * 2 * c * h * d,
            "features": 2 * 2 * h * d * f,
            "attention": 2 * 2 * h * f * d + 2 * h * f,
            "conformer": 2 * c * 2 * inner + 2 * inner * m["kernel"] + 2 * inner * c,
            "head": 2 * c * m["out_dims"]}


def flops(config: dict, engine, padded_len: int) -> dict:
    """FCPE on the song's padded_len // hop + 1 valid frames, all float32."""
    m = config["fcpe"]
    n = padded_len // m["hop_size"] + 1
    per = frame_flops(m)
    layer = per["projections"] + per["features"] + per["attention"] + per["conformer"]
    return {"float32": n * (per["mel"] + per["stack"] + m["n_layers"] * layer + per["head"])}
