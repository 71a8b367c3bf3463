"""HiFi-GAN discriminators (multi-period and scale) as functions of
parameter dictionaries: the port of the JAX package's
models/discriminators.py.

Dead code in the reference (never imported there) but part of the RVC
model family, kept for a training path that neither package has yet:
  - discriminator_p: a period-reshaped 2-D conv stack (periods v1
    [2,3,5,7,11,17], v2 adds [23,37]);
  - discriminator_s: a strided, grouped 1-D conv stack;
  - multi_period_discriminator: the S head and every P head on real and
    generated audio, with per-head logits and feature maps (for
    feature-matching losses).

Plain convolutions (ops/conv.py), as the JAX package leaves them to XLA:
no kernel of the port's own, no backward. ``init_discriminator_params``
is the port's numpy copy of the JAX package's, so one seed gives the same
arrays bit for bit; ``convert.params.params_to_torch`` carries them onto
tensors.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from ..ops.conv import conv1d, conv2d

LRELU_SLOPE = 0.1

PERIODS_V1 = (2, 3, 5, 7, 11, 17)
PERIODS_V2 = (2, 3, 5, 7, 11, 17, 23, 37)

# (out_channels, kernel_h, stride_h) ladder of DiscriminatorP
_P_LAYERS = ((32, 5, 3), (128, 5, 3), (512, 5, 3), (1024, 5, 3), (1024, 5, 1))
# (out, kernel, stride, groups) ladder of DiscriminatorS
_S_LAYERS = (
    (16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16),
    (1024, 41, 4, 64), (1024, 41, 4, 256), (1024, 5, 1, 1),
)


def discriminator_p(params, x, period: int):
    """x: (B, 1, T) -> (logits (B, L), feature maps)."""
    b, c, t = x.shape
    pad = (-t) % period
    if pad:
        x = F.pad(x, (0, pad), mode="reflect")
    t = t + pad
    x = x.reshape(b, c, t // period, period)
    fmaps = []
    for p, (_, _, stride) in zip(params["convs"], _P_LAYERS):
        x = F.leaky_relu(conv2d(x, p["w"], p["b"], stride=(stride, 1), padding=(2, 0)),
                         LRELU_SLOPE)
        fmaps.append(x)
    p = params["conv_post"]
    x = conv2d(x, p["w"], p["b"], padding=(1, 0))
    fmaps.append(x)
    return x.reshape(b, -1), fmaps


def discriminator_s(params, x):
    """x: (B, 1, T) -> (logits, feature maps)."""
    fmaps = []
    for p, (_, k, s, g) in zip(params["convs"], _S_LAYERS):
        x = F.leaky_relu(conv1d(x, p["w"], p["b"], stride=s, padding=k // 2, groups=g),
                         LRELU_SLOPE)
        fmaps.append(x)
    p = params["conv_post"]
    x = conv1d(x, p["w"], p["b"], padding=1)
    fmaps.append(x)
    return x.reshape(x.shape[0], -1), fmaps


def multi_period_discriminator(params, y, y_hat, *, version: str = "v2"):
    """Run all heads on real and generated audio (B, 1, T).

    Returns (real_logits, fake_logits, real_fmaps, fake_fmaps) lists, the
    standard HiFi-GAN discriminator contract: the S head first, then one P
    head per period."""
    periods = PERIODS_V2 if version == "v2" else PERIODS_V1
    r_logits, f_logits, r_fmaps, f_fmaps = [], [], [], []
    for x, logits, fmaps in ((y, r_logits, r_fmaps), (y_hat, f_logits, f_fmaps)):
        l, f = discriminator_s(params["s"], x)
        logits.append(l)
        fmaps.append(f)
        for head, period in zip(params["p"], periods):
            l, f = discriminator_p(head, x, period)
            logits.append(l)
            fmaps.append(f)
    return r_logits, f_logits, r_fmaps, f_fmaps


def init_discriminator_params(*, version: str = "v2", seed: int = 0) -> dict:
    """Random init with the reference topology, as numpy arrays (the JAX
    package's draws, in its order)."""
    rng = np.random.default_rng(seed)

    def conv_init(out_c, in_c, *k):
        fan = in_c * int(np.prod(k))
        return {
            "w": (rng.standard_normal((out_c, in_c, *k)) / np.sqrt(fan)).astype(np.float32),
            "b": np.zeros(out_c, np.float32),
        }

    periods = PERIODS_V2 if version == "v2" else PERIODS_V1
    p_heads = []
    for _ in periods:
        in_c, convs = 1, []
        for out_c, k, s in _P_LAYERS:
            convs.append(conv_init(out_c, in_c, k, 1))
            in_c = out_c
        p_heads.append({"convs": convs, "conv_post": conv_init(1, in_c, 3, 1)})
    # grouped convs: weight (out, in/groups, k)
    in_c = 1
    s_convs = []
    for out_c, k, s, g in _S_LAYERS:
        s_convs.append(conv_init(out_c, max(in_c // g, 1), k))
        in_c = out_c
    return {
        "p": p_heads,
        "s": {"convs": s_convs, "conv_post": conv_init(1, in_c, 3)},
    }
