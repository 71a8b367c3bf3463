#!/usr/bin/env python3
"""Time the Viterbi (K6), band-attention (K4), conv-transpose (K3) and
BiGRU-scan kernels alone on one card.

    python3 kernel_times.py [--reps 20]

Inputs at the shapes the 60 s song gives them (see chip_smoke.py), made
from a seed: K6 on a (7,751, 360) random-walk track with all-tie frames,
all rows valid; K4 on bf16 q, k, v of (4, 3,998, 96), window 10, lengths
(2,744, 2,744, 3,654, 3,654) and, apart, every row at its full
length; K3 on bf16 x at the four upsample stages of the 48 kHz main path
and the five of a v1 32 kHz model (u = 10, 4, 2, 2, 2; its second stage
has padding 6 > stride, offsets -2..2, which a checkout that refuses it
reports as null; its fifth is 16 wide, padded to 32 as the converter
loads it); the BiGRU on fp32 x of (1, 7,200, 384), the frames of the
60 s song's F0 pass, with cuDNN's nn.GRU on the same input and weights
beside it (library_ms). Prints one JSON line of device times (CUDA
events, mean over --reps calls after one warm-up), with the nvidia-smi
name and power limit. It times only the public wrappers and, where the
module has them, the launches inside a call, so that two checkouts can be
compared in one run on one card. Checks nothing: chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import cuda_ms, structured_log_obs


def viterbi_times(reps: int) -> dict:
    from polgen_rvc_tpu_torch.ops import viterbi as vt

    t_len = n = 7751
    lo = structured_log_obs(t_len, n).cuda()
    out = {"ms": cuda_ms(lambda: vt.viterbi_path(lo, n), reps)}
    if hasattr(vt, "_backpointers"):
        rows = vt._forward(lo, n)
        back, maps = vt._backpointers(rows, n)
        out.update(forward_ms=cuda_ms(lambda: vt._forward(lo, n), reps),
                   backpointers_ms=cuda_ms(lambda: vt._backpointers(rows, n), reps),
                   walk_ms=cuda_ms(lambda: vt._walk(rows, back, maps, t_len, n), reps))
    return out


# RMVPE's frames for the 60 s song: its 1,146,880-sample F0 buffer at hop
# 160, padded to a multiple of 32
GRU_FRAMES = 7200


def gru_times(reps: int) -> dict:
    from polgen_rvc_tpu_torch.ops import rnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    gru = torch.nn.GRU(384, 256, batch_first=True, bidirectional=True, device="cuda")
    params = {}
    with torch.no_grad():
        for name, value in gru.named_parameters():
            fan = value.shape[-1] if value.dim() == 2 else 256
            value.copy_(torch.from_numpy((rng.standard_normal(tuple(value.shape))
                                          / np.sqrt(fan)).astype(np.float32)))
            params[name.replace("weight", "w").replace("bias", "b")] = value.detach()
    x = torch.from_numpy((rng.standard_normal((1, GRU_FRAMES, 384)) * 0.5
                          ).astype(np.float32)).cuda()
    if hasattr(rnn, "pack_gru_weights"):
        params = rnn.pack_gru_weights(params)
    with torch.no_grad():
        out = {"frames": GRU_FRAMES, "ms": cuda_ms(lambda: rnn.bigru(x, params), reps),
               "library_ms": cuda_ms(lambda: gru(x), reps)}
    if hasattr(rnn, "_scan"):
        gx = rnn._project(x, params)
        out.update(projection_ms=cuda_ms(lambda: rnn._project(x, params), reps),
                   scan_ms=cuda_ms(lambda: rnn._scan(gx, params), reps))
        out["us_per_step"] = 1e3 * out["scan_ms"] / GRU_FRAMES
    return out


def band_attention_times(reps: int) -> dict:
    from polgen_rvc_tpu_torch.ops import band_attention as ba

    rng = np.random.default_rng(0)
    bh, t, dk, w = 4, 3998, 96, 10
    lengths = (2744, 2744, 3654, 3654)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                                ).cuda().to(torch.bfloat16)

    q = rand(bh, t, dk, scale=dk ** -0.5)
    k, v = rand(bh, t, dk), rand(bh, t, dk)
    rk, rv = rand(2 * w + 1, dk, scale=dk ** -0.5), rand(2 * w + 1, dk, scale=dk ** -0.5)
    out = {}
    # the main path's lengths, then every row at its full T
    for name, lengths in (("", lengths), ("full_", (t,) * bh)):
        lens = torch.tensor(lengths, device="cuda")
        ms = cuda_ms(lambda: ba.band_attention(q, k, v, rk, rv, lens, w), reps)
        flops = sum(4.0 * n * n * dk for n in lengths)
        out.update({f"{name}ms": ms, f"{name}tflop_per_s": flops / ms / 1e9})
    return out


# (C_in, C_out, T_in, u, k) of each upsample stage, batch 2, the 60 s song
CONVT_STAGES = {
    "48k": ((512, 256, 3998, 12, 24), (256, 128, 47976, 10, 20),
            (128, 64, 479760, 2, 4), (64, 32, 959520, 2, 4)),
    "v1_32k": ((512, 256, 3998, 10, 16), (256, 128, 39980, 4, 16),
               (128, 64, 159920, 2, 4), (64, 32, 319840, 2, 4),
               (32, 32, 639680, 2, 4)),
}


def conv_transpose_times(reps: int) -> dict:
    from polgen_rvc_tpu_torch.ops import conv_transpose as ct

    rng = np.random.default_rng(0)
    out = {}
    for config, stages in CONVT_STAGES.items():
        times = []
        for c_in, c_out, t, u, k in stages:
            pad = (k - u) // 2
            x = torch.from_numpy((rng.standard_normal((2, c_in, t)) * 0.5
                                  ).astype(np.float32)).cuda().to(torch.bfloat16)
            w = torch.from_numpy((rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k)
                                  ).astype(np.float32)).cuda()
            b = torch.zeros(c_out, device="cuda")
            try:
                taps = ct.pack_phase_taps(w.to(torch.bfloat16), u, pad)
            except ValueError:
                times.append(None)
                continue
            times.append(cuda_ms(lambda: ct.conv_transpose1d(
                x, w, b, stride=u, padding=pad, taps=taps), reps))
            del x, w, taps
        out[config] = {"stage_ms": times,
                       "ms": None if None in times else sum(times)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "viterbi": viterbi_times(args.reps),
                      "band_attention": band_attention_times(args.reps),
                      "conv_transpose": conv_transpose_times(args.reps),
                      "gru": gru_times(args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
