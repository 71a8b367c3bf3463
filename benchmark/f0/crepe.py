"""CREPE "full" (torchcrepe, arXiv:1802.06182) for mangio-crepe F0: six
convs over 1024-sample frames, a 360-bin classifier and the banded
Viterbi decode."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..reference import f0 as f0_ref


def make_weights(nrm, config: dict) -> dict:
    """torchcrepe's state dict (conv{i}, conv{i}_BN, classifier), with
    batch-norm statistics away from the identity."""
    layers = config["crepe"]["layers"]
    sd = {}
    in_c = 1
    for i, (out_c, k, _, _, _) in enumerate(layers):
        sd[f"conv{i + 1}.weight"] = nrm(out_c, in_c, k, 1) * (1.0 / math.sqrt(in_c * k))
        sd[f"conv{i + 1}.bias"] = nrm(out_c) * 0.02
        sd[f"conv{i + 1}_BN.weight"] = nrm(out_c) * 0.2 + 1.0
        sd[f"conv{i + 1}_BN.bias"] = nrm(out_c) * 0.1
        sd[f"conv{i + 1}_BN.running_mean"] = nrm(out_c) * 0.1
        sd[f"conv{i + 1}_BN.running_var"] = (nrm(out_c) * 0.3).exp()
        in_c = out_c
    in_features = layers[-1][0] * 4
    sd["classifier.weight"] = nrm(360, in_features) * (1.0 / math.sqrt(in_features))
    sd["classifier.bias"] = nrm(360) * 0.0
    return sd


def program_params(state: dict, config: dict) -> dict:
    from polgen_rvc_tpu_torch.convert.crepe_ckpt import convert_crepe_state

    return {"crepe_params": convert_crepe_state(state)}


def stated_operands(config: dict) -> dict:
    return {}


def reference_f0(state: dict, config: dict, buf, padded_len: int, opts: dict, ops):
    """mangio-crepe at the options' hop: salience, Viterbi decode, resize."""
    return f0_ref.crepe_f0(state, buf, padded_len, int(opts["hop_length"]), opts["f0_min"],
                           opts["f0_max"], config["crepe"]["layers"], ops)


@contextlib.contextmanager
def program_tap(sink: list):
    """While open, each salience the port's mangio-crepe pass hands to its
    decode (n frames x 360, float16, pipeline/crepe_method.py) is appended
    to sink: a reference to the tensor, no copy."""
    from polgen_rvc_tpu_torch.pipeline import crepe_method

    orig = crepe_method.crepe_f0_decode_device

    def tapped(salience, n, **kwargs):
        sink.append(salience[:n])
        return orig(salience, n, **kwargs)

    crepe_method.crepe_f0_decode_device = tapped
    try:
        yield
    finally:
        crepe_method.crepe_f0_decode_device = orig


def intermediate(state: dict, config: dict, buf, padded_len: int, opts: dict, ops):
    """The reference's counterpart of what program_tap catches: the
    salience track, its slabs cast to float16."""
    return f0_ref.crepe_salience_track(state, buf, padded_len, int(opts["hop_length"]),
                                       config["crepe"]["layers"], ops)


@torch.no_grad()
def checks(state: dict, config: dict, buf, padded_len: int, opts: dict, ops,
           got_f0, got_salience, frames: int) -> dict:
    """The F0 pass judged in its two stages. The Viterbi path over a
    random-weight CREPE's flat salience is decided by rounding (on an H100,
    a path 0.34 nats below the best over a 240 s song's 30,251 frames put
    6% of them up to 361 cents off), so no independent decode reproduces
    the program's track:
      salience_rel_err     the program's salience against the reference's
                           (||got - ref|| / ||ref||)
      f0_decode_cents_max  the program's F0 track against the reference's
                           decode of the program's own salience, the
                           largest error in cents over the frames"""
    ref_sal = intermediate(state, config, buf, padded_len, opts, ops)
    sal = got_salience.to(ref_sal.device).float()
    shift = float(np.float32(2.0 ** (opts["pitch"] / 12.0)))
    decoded = f0_ref.crepe_decode(sal, padded_len, opts["f0_min"], opts["f0_max"],
                                  buf.shape[0] // 160 + 1) * shift
    return {"salience_rel_err": f0_ref.salience_rel_err(sal, ref_sal),
            "f0_decode_cents_max": f0_ref.f0_cents_max(got_f0.to(decoded.device), decoded,
                                                       frames)}


def flops(config: dict, engine, padded_len: int) -> dict:
    """CREPE on the song's padded_len // hop + 1 frames of 1024 samples."""
    n = padded_len // int(config["options"]["hop_length"]) + 1
    bf, positions, c_in = 0.0, 1024, 1
    for c_out, k, stride, pt, pb in config["crepe"]["layers"]:
        out = (positions + pt + pb - k) // stride + 1
        bf += 2 * c_out * c_in * k * out
        positions, c_in = out // 2, c_out
    return {"bfloat16": n * bf, "float32": n * 2 * positions * c_in * 360}
