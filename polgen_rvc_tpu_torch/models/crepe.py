"""CREPE F0 model (torchcrepe "full" capacity) and its decode, in PyTorch.

The port of polgen_rvc_tpu/models/crepe.py's device path: framing with
torchcrepe's pad=True geometry and per-frame normalization, six conv
blocks (pad -> conv -> +b -> ReLU -> BatchNorm affine -> maxpool(2, 1)),
the classifier and a sigmoid over 360 pitch bins; then the decode: bin
masking outside [f0_min, f0_max], the banded Viterbi (ops/viterbi.py, the
CUDA kernel on the card), the +-4-bin weighted cents and the resize onto
the engine's frame grid.

Precision: the convs' multiplicands are in ``compute_dtype``. In bfloat16
(the card) ``F.conv1d`` returns bfloat16 where JAX keeps an fp32 result
(``preferred_element_type``), so the output is upcast right after each
conv: one extra rounding of the conv result (2^-9 relative) beside the
rounding of its operands. Bias, ReLU, the affine, the pools, the
classifier and the sigmoid run in fp32, and so does the decode. TF32 is
off (``resolve_device``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.f0_utils import bin_cents_table, cents_to_hz
# the transition matrix and its band table live beside the kernel
from ..ops.viterbi import PITCH_BINS, viterbi_path

WINDOW_SIZE = 1024

# torchcrepe "full" topology: (out_ch, kernel_h, stride_h, pad_top, pad_bottom)
FULL_LAYERS = (
    (1024, 512, 4, 254, 254),
    (128, 64, 1, 31, 32),
    (128, 64, 1, 31, 32),
    (128, 64, 1, 31, 32),
    (256, 64, 1, 31, 32),
    (512, 64, 1, 31, 32),
)


@dataclasses.dataclass(frozen=True)
class CrepeConfig:
    layers: tuple = FULL_LAYERS
    in_features: int = 2048  # 512 ch x 4 after poolings


def pack_crepe_weights(params, compute_dtype=torch.float32):
    """The conv weights as conv1d operands, (out, in, k) in compute_dtype
    ("w_conv"), made once when the weights load; the fp32 originals stay."""
    return {**params, "convs": [
        {**p, "w_conv": p["w"][..., 0].to(compute_dtype).contiguous()}
        for p in params["convs"]
    ]}


def crepe_salience_window(params, buf, inv_scale, start_frame: int, hop: int,
                          n_frames: int, cfg: CrepeConfig = CrepeConfig(),
                          compute_dtype=torch.float32):
    """Salience (n_frames, 360) of frames [start_frame, start_frame +
    n_frames) of a (S,) int16 or float buffer read as buf * inv_scale.
    Frame f covers samples f * hop - 512 .. f * hop + 511; samples outside
    the buffer read as zero. Each frame is normalized by its mean and its
    population std (floored at 1e-10)."""
    x = buf.float() * inv_scale
    first = start_frame * hop - WINDOW_SIZE // 2  # first sample of the window
    need = (n_frames - 1) * hop + WINDOW_SIZE
    lo = max(first, 0)
    hi = min(first + need, x.shape[0])
    seg = x[lo:max(hi, lo)]
    seg = F.pad(seg, (lo - first, need - (lo - first) - seg.shape[0]))
    frames = seg.unfold(0, WINDOW_SIZE, hop)  # (n_frames, 1024) view
    mean = frames.mean(dim=-1, keepdim=True)
    std = torch.clamp(frames.std(dim=-1, keepdim=True, correction=0), min=1e-10)
    return crepe_salience(params, (frames - mean) / std, cfg, compute_dtype)


def crepe_salience(params, frames, cfg: CrepeConfig = CrepeConfig(),
                   compute_dtype=torch.float32):
    """(N, 1024) normalized frames -> (N, PITCH_BINS) fp32 sigmoid salience, in
    torchcrepe's layer order: the BatchNorm affine (s, t) follows the ReLU
    and precedes the pool. params come through pack_crepe_weights."""
    x = frames.float()[:, None, :]  # (N, 1, 1024): conv2d's H axis as time
    for p, (_, _, stride, pt, pb) in zip(params["convs"], cfg.layers):
        x = F.pad(x, (pt, pb)).to(compute_dtype)
        x = F.conv1d(x, p["w_conv"].to(compute_dtype), stride=stride).float()
        x = x.add_(p["b"][:, None]).relu_().mul_(p["s"][:, None]).add_(p["t"][:, None])
        x = F.max_pool1d(x, 2)
    x = x.transpose(1, 2).reshape(x.shape[0], -1)  # torchcrepe permute(0, 2, 1, 3)
    cls = params["classifier"]
    return torch.sigmoid(x @ cls["w"] + cls["b"])


def bins_to_f0(path, salience):
    """Weighted local average (+-4 bins) of the salience around the decoded
    path -> Hz, in fp32. path (T,) ints, salience (T, 360)."""
    sal = salience.float()
    dev = sal.device
    cents_map = F.pad(torch.from_numpy(bin_cents_table()).to(dev), (4, 4))
    sal_pad = F.pad(sal, (4, 4))
    idx = path.long()[:, None] + torch.arange(9, device=dev)[None, :]
    w = torch.gather(sal_pad, 1, idx)
    cents = (w * cents_map[idx]).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1e-12)
    return cents_to_hz(cents)


def crepe_f0_decode_device(salience, n: int, *, f0_min: float = 50.0,
                           f0_max: float = 1100.0):
    """(T, 360) salience -> (T,) Hz: bins outside [f0_min, f0_max] masked
    (from a float64 frequency table, as JAX computes it), rows normalized,
    log(p + 1e-20), the banded Viterbi over rows < n, then bins_to_f0.
    Rows t >= n are pass-through in the Viterbi; nothing past n is read by
    crepe_resize_device."""
    freqs = np.asarray(cents_to_hz(bin_cents_table()), np.float64)
    bin_mask = torch.from_numpy((freqs < f0_min) | (freqs > f0_max)).to(salience.device)
    sal = salience.float()
    probs = torch.where(bin_mask[None, :], torch.zeros_like(sal), sal)
    obs = probs / torch.clamp(probs.sum(dim=1, keepdim=True), min=1e-20)
    log_obs = torch.log(obs + 1e-20)
    path = viterbi_path(log_obs, n)
    return bins_to_f0(path, sal)


def crepe_resize_device(f0, n: int, p_len: int, out_size: int):
    """The reference crepe post (pipeline.py:108-117): frames below 0.001 Hz
    are nan, the n-frame track is resampled by np.interp onto i * n / p_len
    for i < p_len (an exact grid hit reads only its own frame; right edge
    clamped), nan -> 0, zeros from p_len to out_size. The grid index
    q = i * n // p_len and its remainder are exact int64."""
    dev = f0.device
    i = torch.arange(out_size, device=dev)
    nf, pf = max(int(n), 1), max(int(p_len), 1)
    q = torch.div(i * nf, pf, rounding_mode="floor")
    r = i * nf - q * pf
    frac = r.to(torch.float32) / torch.tensor(float(pf), device=dev)
    s0 = f0[torch.clamp(q, 0, nf - 1)]
    s1 = f0[torch.clamp(q + 1, 0, nf - 1)]
    zero = torch.zeros_like(s0)
    out = torch.where(frac > 0, s0 + frac * (s1 - s0), s0)
    out = torch.where(q >= nf - 1, f0[nf - 1].expand_as(out), out)
    invalid = (s0 < 0.001) | ((s1 < 0.001) & (frac > 0) & (q < nf - 1))
    out = torch.where(invalid, zero, out)
    return torch.where(i < p_len, out, zero)
