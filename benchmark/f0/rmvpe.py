"""RMVPE (rmvpe.pt, arXiv:2306.15412) for rmvpe+ F0: E2E(4, 1, (2, 2)),
a U-Net over the log-mel, a BiGRU and a 360-bin classifier."""

from __future__ import annotations

import torch

from ..reference import f0 as f0_ref
from ..init import fan, linear

N_BLOCKS = 4


def make_weights(nrm, config: dict) -> dict:
    """rmvpe.pt's E2E(4, 1, (2, 2)) state dict."""
    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = nrm(c) * 0.01 + 1.0
        sd[f"{prefix}.bias"] = nrm(c) * 0.01
        sd[f"{prefix}.running_mean"] = nrm(c) * 0.1
        sd[f"{prefix}.running_var"] = (nrm(c) * 0.1).abs() + 1.0
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    def block(prefix, in_c, out_c):
        sd[f"{prefix}.conv.0.weight"] = nrm(out_c, in_c, 3, 3) * fan(in_c, 3, 3)
        bn(f"{prefix}.conv.1", out_c)
        sd[f"{prefix}.conv.3.weight"] = nrm(out_c, out_c, 3, 3) * fan(out_c, 3, 3)
        bn(f"{prefix}.conv.4", out_c)
        if in_c != out_c:
            sd[f"{prefix}.shortcut.weight"] = nrm(out_c, in_c, 1, 1) * fan(in_c)
            sd[f"{prefix}.shortcut.bias"] = nrm(out_c) * 0.02

    bn("unet.encoder.bn", 1)
    in_c, out_c = 1, 16
    for i in range(5):
        for j in range(N_BLOCKS):
            block(f"unet.encoder.layers.{i}.conv.{j}", in_c if j == 0 else out_c, out_c)
        in_c, out_c = out_c, out_c * 2
    for i in range(4):
        for j in range(N_BLOCKS):
            block(f"unet.intermediate.layers.{i}.conv.{j}",
                  256 if (i == 0 and j == 0) else 512, 512)
    c = 512
    for i in range(5):
        oc = c // 2
        sd[f"unet.decoder.layers.{i}.conv1.0.weight"] = nrm(c, oc, 3, 3) * fan(c, 3, 3)
        bn(f"unet.decoder.layers.{i}.conv1.1", oc)
        for j in range(N_BLOCKS):
            block(f"unet.decoder.layers.{i}.conv2.{j}", oc * 2 if j == 0 else oc, oc)
        c = oc
    sd["cnn.weight"] = nrm(3, 16, 3, 3) * fan(16, 3, 3)
    sd["cnn.bias"] = nrm(3) * 0.02
    for suffix in ("", "_reverse"):
        sd[f"fc.0.gru.weight_ih_l0{suffix}"] = nrm(768, 384) * fan(384)
        sd[f"fc.0.gru.weight_hh_l0{suffix}"] = nrm(768, 256) * fan(256)
        sd[f"fc.0.gru.bias_ih_l0{suffix}"] = nrm(768) * 0.02
        sd[f"fc.0.gru.bias_hh_l0{suffix}"] = nrm(768) * 0.02
    linear(nrm, sd, "fc.1", 360, 512)
    return sd


def program_params(state: dict, config: dict) -> dict:
    from polgen_rvc_tpu_torch.convert.rmvpe_ckpt import convert_rmvpe_state

    return {"rmvpe_params": convert_rmvpe_state(state)}


def stated_operands(config: dict) -> dict:
    """The U-Net's operand precision, as the configuration's "rmvpe" entry
    states it."""
    return {"unet": config.get("rmvpe", {}).get("operand_dtype")}


def reference_f0(state: dict, config: dict, buf, padded_len: int, opts: dict, ops):
    """RMVPE over the whole buffer, zero outside [f0_min, f0_max] (rmvpe+)."""
    f0 = f0_ref.rmvpe_f0(state, buf, ops)
    return torch.where((f0 < opts["f0_min"]) | (f0 > opts["f0_max"]), torch.zeros_like(f0), f0)


def flops(config: dict, engine, padded_len: int) -> dict:
    """RMVPE on the song's padded_len // window + 1 frames: {dtype: operations}."""
    n = padded_len // engine.window + 1
    bf = fp = 0.0
    levels = []
    c_in, c = 1, 16
    for i in range(5):
        levels.append((c_in, c, n / 2 ** i, 128 / 2 ** i))
        c_in, c = c, c * 2
    for i in range(4):
        levels.append((256 if i == 0 else 512, 512, n / 32, 4))
    c = 512
    for i in range(5):
        oc = c // 2
        t_in, w_in = n / 2 ** (5 - i), 4 * 2 ** i
        fp += 2 * 9 * c * oc * t_in * w_in                 # transposed conv
        levels.append((2 * oc, oc, n / 2 ** (4 - i), 8 * 2 ** i))
        c = oc
    for c_in, c, t, w in levels:
        for j in range(N_BLOCKS):
            cin = c_in if j == 0 else c
            bf += 2 * 9 * (cin * c + c * c) * t * w
            if cin != c:
                bf += 2 * cin * c * t * w
    fp += 2 * 9 * 16 * 3 * n * 128                            # head conv
    fp += n * 2 * 2 * 3 * 256 * (384 + 256)                   # BiGRU
    fp += n * (2 * 512 * 360 + 2 * 128 * 513)                 # classifier, mel basis
    return {"bfloat16": bf, "float32": fp}
