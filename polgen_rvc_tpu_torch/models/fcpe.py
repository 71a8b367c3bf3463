"""FCPE F0 predictor (conformer + Performer linear attention) in PyTorch:
the port of polgen_rvc_tpu/models/fcpe.py.

Mel frontend (asymmetric padding, slaney mels), an input conv stack with
GroupNorm, PCmer layers (FAVOR+ linear attention over the checkpoint's
stored projection, then a depthwise-GLU conformer conv module), LayerNorm,
the dense layer to 360 cent bins and a sigmoid; then the local-argmax
cents decode and either the device resize/gap-fill (``fcpe_resize_fill``)
or the predictor's host post-processing (``fcpe_post_process``, numpy).

FCPE has no kernel of its own in the JAX package (no Pallas call), so on
the card it runs as these plain PyTorch ops, in float32 with TF32 off
(``resolve_device``): the F0 pass stays fp32, as for RMVPE.

``n_valid`` (frames of real signal in a zero-padded bucket) keeps every
frame-global op (GroupNorm statistics, the FAVOR+ sums, each conv's window
at the boundary) blind to the padding, as in the JAX package.

Spans (utils/tracing.py): ``polgen.fcpe.mel`` around ``fcpe_mel`` and
``polgen.fcpe.net`` around ``fcpe_salience`` (the stack, the PCmer layers
and the head); pipeline/fcpe_method.py opens ``polgen.fcpe.decode``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.audio import log_mel_spectrogram, mel_filterbank
from ..ops.conv import conv1d
from ..utils.tracing import spanned


@dataclasses.dataclass(frozen=True)
class FcpeConfig:
    input_channel: int = 128
    out_dims: int = 360
    n_layers: int = 12
    n_chans: int = 512
    n_heads: int = 8
    f0_min: float = 32.70
    f0_max: float = 1975.5
    # mel frontend
    sampling_rate: int = 16000
    num_mels: int = 128
    n_fft: int = 1024
    win_size: int = 1024
    hop_size: int = 160
    fmin: float = 0.0
    fmax: float = 8000.0

    def cent_table(self) -> np.ndarray:
        lo = 1200.0 * math.log2(self.f0_min / 10.0)
        hi = 1200.0 * math.log2(self.f0_max / 10.0)
        return np.linspace(lo, hi, self.out_dims, dtype=np.float32)


@lru_cache(maxsize=4)
def _fcpe_mel_basis(sr, n_fft, n_mels, fmin, fmax):
    return mel_filterbank(sr=sr, n_fft=n_fft, n_mels=n_mels, fmin=fmin,
                          fmax=fmax, htk=False)


@spanned("polgen.fcpe.mel")
def fcpe_mel(audio, cfg: FcpeConfig):
    """(B, T) -> (B, T // hop + 1, mels) log-mel frames: (win - hop)//2
    samples of padding on the left, enough on the right for one frame
    (reflect, or zeros when the signal is shorter than that pad), the
    last frame repeated where the STFT gives one frame fewer."""
    t = audio.shape[-1]
    pad_left = (cfg.win_size - cfg.hop_size) // 2
    pad_right = max((cfg.win_size - cfg.hop_size + 1) // 2,
                    cfg.win_size - t - pad_left)
    mode = "reflect" if pad_right < t else "constant"
    basis = _fcpe_mel_basis(cfg.sampling_rate, cfg.n_fft, cfg.num_mels,
                            cfg.fmin, cfg.fmax)
    mel = log_mel_spectrogram(
        audio, basis, n_fft=cfg.n_fft, hop_length=cfg.hop_size,
        win_length=cfg.win_size, center=False, pad_left=pad_left,
        pad_right=pad_right, pad_mode=mode, clamp=1e-5, magnitude_eps=1e-9,
    ).transpose(1, 2)  # (B, N, mels)
    n_frames = t // cfg.hop_size + 1
    if n_frames > mel.shape[1]:
        mel = torch.cat([mel, mel[:, -1:]], dim=1)
    return mel[:, :n_frames]


def _layer_norm(x, p, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], p["gamma"].to(x.dtype),
                        p["beta"].to(x.dtype), eps)


def _group_norm_channels(x, gamma, beta, groups: int, eps: float = 1e-5,
                         nmask=None, n_valid=None):
    """GroupNorm on (B, C, T); with nmask / n_valid the statistics run over
    the first n_valid frames only."""
    b, c, t = x.shape
    xg = x.reshape(b, groups, c // groups, t)
    if nmask is None:
        mean = xg.mean(dim=(2, 3), keepdim=True)
        var = xg.var(dim=(2, 3), keepdim=True, unbiased=False)
    else:
        m = nmask.to(x.dtype)[None, None, None, :]
        cnt = (c // groups) * max(int(n_valid), 1)
        mean = (xg * m).sum(dim=(2, 3), keepdim=True) / cnt
        xc = (xg - mean) * m
        var = (xc * xc).sum(dim=(2, 3), keepdim=True) / cnt
    x = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, t)
    return x * gamma.to(x.dtype)[None, :, None] + beta.to(x.dtype)[None, :, None]


def _softmax_kernel(data, projection, *, is_query: bool, eps: float = 1e-4):
    """The Performer FAVOR+ feature map, with the reference's eps inside the
    exp on the key branch."""
    d = data.shape[-1]
    normalizer = d ** -0.25
    ratio = projection.shape[0] ** -0.5
    data_dash = torch.einsum("bhnd,jd->bhnj", normalizer * data, projection)
    diag = (data ** 2).sum(dim=-1, keepdim=True) / 2.0 * (normalizer ** 2)
    if is_query:
        return ratio * (torch.exp(data_dash - diag
                                  - data_dash.amax(dim=-1, keepdim=True)) + eps)
    return ratio * torch.exp(data_dash - diag + eps)


def _linear_attention(q, k, v):
    """Non-causal linear attention."""
    k_cumsum = k.sum(dim=-2)
    d_inv = 1.0 / (torch.einsum("bhnd,bhd->bhn", q, k_cumsum) + 1e-8)
    context = torch.einsum("bhnd,bhne->bhde", k, v)
    return torch.einsum("bhde,bhnd,bhn->bhne", context, q, d_inv)


def _self_attention(x, p, n_heads: int, nmask=None):
    """(B, N, C) -> (B, N, C). The inner width comes from to_q (the
    reference fixes dim_head at 64, not C / heads); the padded frames' key
    features and values are zeroed so the sums see exact zeros there."""
    b, n, _ = x.shape
    inner = p["to_q"]["w"].shape[1]
    dh = inner // n_heads

    def proj(name):
        y = x @ p[name]["w"].to(x.dtype) + p[name]["b"].to(x.dtype)
        return y.reshape(b, n, n_heads, dh).transpose(1, 2)  # (B, H, N, dh)

    q, k, v = proj("to_q"), proj("to_k"), proj("to_v")
    proj_mat = p["projection_matrix"].to(x.dtype)
    q = _softmax_kernel(q, proj_mat, is_query=True)
    k = _softmax_kernel(k, proj_mat, is_query=False)
    if nmask is not None:
        m = nmask.to(k.dtype)[None, None, :, None]
        k = k * m
        v = v * m
    out = _linear_attention(q, k, v).transpose(1, 2).reshape(b, n, inner)
    return out @ p["to_out"]["w"].to(x.dtype) + p["to_out"]["b"].to(x.dtype)


def _conformer_conv(x, p, nmask=None):
    """LN -> 1x1 conv -> GLU -> (mask) -> depthwise k31 -> swish -> 1x1
    conv; the mask gives the k31 window the reference's zero padding at
    the n_valid boundary."""
    y = _layer_norm(x, p["norm"]).transpose(1, 2)  # (B, C, N)
    y = conv1d(y, p["conv_in"]["w"], p["conv_in"]["b"])
    a, g = torch.chunk(y, 2, dim=1)
    y = a * torch.sigmoid(g)
    if nmask is not None:
        y = y * nmask.to(y.dtype)[None, None, :]
    y = conv1d(y, p["depthwise"]["w"], p["depthwise"]["b"], padding=15,
               groups=y.shape[1])
    y = y * torch.sigmoid(y)
    y = conv1d(y, p["conv_out"]["w"], p["conv_out"]["b"])
    return y.transpose(1, 2)


@spanned("polgen.fcpe.net")
def fcpe_salience(params, cfg: FcpeConfig, mel, n_valid=None):
    """(B, N, mels) -> (B, N, 360) sigmoid salience. With n_valid, frames
    [0, n_valid) equal an unpadded run's to float rounding; later frames
    are garbage that callers slice or resize away."""
    nmask = None
    if n_valid is not None:
        nmask = torch.arange(mel.shape[1], device=mel.device) < int(n_valid)
        mel = torch.where(nmask[None, :, None], mel, torch.zeros_like(mel))
    x = mel.transpose(1, 2)
    st = params["stack"]
    x = conv1d(x, st["conv1"]["w"], st["conv1"]["b"], padding=1)
    x = _group_norm_channels(x, st["gn"]["gamma"], st["gn"]["beta"], groups=4,
                             nmask=nmask, n_valid=n_valid)
    x = F.leaky_relu(x, 0.01)
    if nmask is not None:
        x = x * nmask.to(x.dtype)[None, None, :]
    x = conv1d(x, st["conv2"]["w"], st["conv2"]["b"], padding=1)
    x = x.transpose(1, 2)  # (B, N, C)
    for lp in params["layers"]:
        x = x + _self_attention(_layer_norm(x, lp["norm"]), lp["attn"],
                                cfg.n_heads, nmask)
        x = x + _conformer_conv(x, lp["conformer"], nmask)
    x = _layer_norm(x, params["norm"])
    x = x @ params["dense_out"]["w"].to(x.dtype) + params["dense_out"]["b"].to(x.dtype)
    return torch.sigmoid(x)


def fcpe_decode(salience, cfg: FcpeConfig, threshold: float = 0.03):
    """The local-argmax cents decode -> Hz, 0 where the peak is at or below
    threshold: the salience-weighted cents of the 9 bins around the argmax
    (first index on ties), edge bins clamped."""
    cent_table = torch.from_numpy(cfg.cent_table()).to(salience.device)
    confident = salience.amax(dim=-1)
    max_idx = salience.argmax(dim=-1)
    idx = torch.clamp(max_idx[..., None]
                      + torch.arange(-4, 5, device=salience.device),
                      0, cfg.out_dims - 1)
    sal = torch.gather(salience, -1, idx)
    cents = (cent_table[idx] * sal).sum(dim=-1) / torch.clamp(sal.sum(dim=-1),
                                                              min=1e-12)
    f0 = 10.0 * (2.0 ** (cents / 1200.0))
    return torch.where(confident > threshold, f0, torch.zeros_like(f0))


def fcpe_resize_fill(f0, n: int, p_len: int):
    """The device form of fcpe_post_process, at f0's own length: nearest-
    resize of the first n frames onto p_len by floor((i * n) / p_len) (exact
    in int64), then linear interpolation across unvoiced (zero) gaps with
    the edges held, zeros from p_len on."""
    size = f0.shape[0]
    dev = f0.device
    i = torch.arange(size, device=dev)
    nf, pf = max(int(n), 1), max(int(p_len), 1)
    src = torch.clamp(torch.div(i * nf, pf, rounding_mode="floor"), 0, nf - 1)
    f0r = f0[src]
    valid = (i < p_len) & (f0r > 0)
    prev = torch.cummax(torch.where(valid, i, torch.full_like(i, -1)), dim=0).values
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(valid, i, torch.full_like(i, size)),
                                             dims=(0,)), dim=0).values, dims=(0,))
    vprev = f0r[torch.clamp(prev, 0, size - 1)]
    vnext = f0r[torch.clamp(nxt, 0, size - 1)]
    w = (i - prev).to(torch.float32) / torch.clamp(nxt - prev, min=1).to(torch.float32)
    out = vprev + (vnext - vprev) * w
    out = torch.where(prev < 0, vnext, torch.where(nxt >= size, vprev, out))
    zero = torch.zeros_like(out)
    out = torch.where(valid.any(), out, zero)
    return torch.where(i < p_len, out, zero)


def fcpe_post_process(f0: np.ndarray, p_len: int, hop: int, sr: int) -> np.ndarray:
    """The predictor's host post: nearest-resize to p_len, then fill the
    unvoiced gaps by interpolating between nonzero samples."""
    n = len(f0)
    if n != p_len:  # nearest interpolation
        idx = np.clip((np.arange(p_len) * (n / p_len)).astype(np.int64), 0, n - 1)
        f0 = f0[idx]
    nz = np.nonzero(f0)[0]
    if nz.size == 0:
        return np.zeros(p_len, np.float32)
    if nz.size == 1:
        return np.full(p_len, f0[nz[0]], np.float32)
    time_org = hop / sr * nz
    time_frame = np.arange(p_len) * hop / sr
    out = np.interp(time_frame, time_org, f0[nz], left=f0[nz[0]], right=f0[nz[-1]])
    return out.astype(np.float32)
