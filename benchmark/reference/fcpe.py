"""FCPE, the F0 predictor of the app's "fcpe" method, in plain PyTorch from
the raw fcpe.pt state dict, written from the published description
(torchfcpe, github.com/CNChTu/FCPE; its copy in RVC's
rvc/lib/predictors/FCPE.py: STFT and Wav2Mel, FCPE, PCmer,
SelfAttention, FastAttention, ConformerConvModule, FCPEF0Predictor).

Its parts, in float32 with TF32 off (``ops.full_precision``), each product
through ``Ops`` so that the controls can round its operands:

    log-mel    reflect pad of (win - hop) // 2 left and (win - hop + 1) // 2
               right (zeros where the signal is shorter than the right pad),
               periodic Hann, ``center=False``, sqrt(re^2 + im^2 + 1e-9),
               Slaney mels, log of clamp 1e-5; T // hop + 1 frames, the last
               repeated where the STFT gives one fewer
    the stack  conv k3 -> GroupNorm(4) -> leaky ReLU (0.01) -> conv k3
    PCmer      each layer x + attn(LayerNorm(x)), then x + conformer(x):
               Performer FAVOR+ over the stored projection (the query
               branch less its row max, eps 1e-4 added after the exp; the
               key branch with eps 1e-4 inside the exp), non-causal linear
               attention (1e-8 added to its denominator); the conformer conv module LayerNorm -> 1x1 conv to
               2 x inner -> GLU -> depthwise conv (same padding) -> swish ->
               1x1 conv back
    the head   LayerNorm -> weight-normed dense layer -> sigmoid
    decode     local argmax: the salience-weighted cents of the 9 bins
               around the peak (edge bins clamped), 0 Hz where the peak is
               at or below the threshold (the app's 0.03)
    resize     FCPEF0Predictor.compute_f0: nearest onto p_len frames, then
               linear interpolation in time over the unvoiced gaps, the
               edges held

No bucket, no n_valid masking: the net runs over the padded signal's
n = padded_len // hop + 1 frames alone, where the port runs the whole
zero-tailed buffer's frames and masks those past n. Their log-mel is
read from that buffer, as the port's pass is handed it: the app's input,
buf[:padded_len], reflects the signal into the last few frames' windows
where the buffer has zeros, a difference of design (the JAX package's)
that the CPU tests hold apart from the masking on the frames it cannot
reach. The control's F0 and its salience (benchmark/control.py) then
read one input, as the program's do.

Departures from the description, each on purpose:
  * the nearest resize takes source frame floor(i * n / p_len) in exact
    integers. torch's F.interpolate, which the description calls, forms
    i * (n / p_len) in float32, and at 24,000 frames that puts the last
    few dozen frames one source frame later; the port takes the exact rule
    (the JAX package's), and a rule that differs there would judge the
    rounding of an index, not the pass;
  * the projection matrix is read as stored: the trained checkpoint's
    rows are orthogonal Gaussian blocks, the benchmark's are i.i.d.
    Gaussian (benchmark/f0/fcpe.py), and the forward pass is the same
    either way;
  * dropout is left out (the model runs in eval mode).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

GROUPS = 4         # the input stack's GroupNorm, a published width no weight carries
EPS_FEATURES = 1e-4
EPS_DENOMINATOR = 1e-8


# --------------------------------------------------------------------------
# the log-mel (Slaney mel scale and area norm, as librosa's mel filters)
# --------------------------------------------------------------------------

_F_SP = 200.0 / 3.0          # Hz per mel below 1 kHz
_LOG_STEP = math.log(6.4) / 27.0
_MEL_1K = 1000.0 / _F_SP


def _hz_to_mel(hz: float) -> float:
    return hz / _F_SP if hz < 1000.0 else _MEL_1K + math.log(hz / 1000.0) / _LOG_STEP


def _mel_to_hz(mel: float) -> float:
    return mel * _F_SP if mel < _MEL_1K else 1000.0 * math.exp(_LOG_STEP * (mel - _MEL_1K))


def slaney_mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangles between n_mels + 2 points evenly
    spaced on the Slaney mel scale, each scaled to unit area (2 / width)."""
    lo, hi = _hz_to_mel(fmin), _hz_to_mel(fmax)
    edges = [_mel_to_hz(lo + (hi - lo) * j / (n_mels + 1)) for j in range(n_mels + 2)]
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    basis = np.zeros((n_mels, freqs.size), np.float64)
    for m in range(n_mels):
        left, centre, right = edges[m], edges[m + 1], edges[m + 2]
        rising = (freqs - left) / (centre - left)
        falling = (right - freqs) / (right - centre)
        basis[m] = np.maximum(0.0, np.minimum(rising, falling)) * (2.0 / (right - left))
    return basis.astype(np.float32)


def log_mel(x, cfg: dict):
    """(T,) float32 signal -> (T // hop + 1, n_mels) log-mel frames."""
    win, hop, n_fft = cfg["win_size"], cfg["hop_size"], cfg["n_fft"]
    t = x.shape[-1]
    left = (win - hop) // 2
    right = max((win - hop + 1) // 2, win - t - left)
    mode = "reflect" if right < t else "constant"
    y = F.pad(x.float()[None, None], (left, right), mode=mode)[0]
    spec = torch.stft(y, n_fft, hop_length=hop, win_length=win,
                      window=torch.hann_window(win, device=x.device), center=False,
                      return_complex=True)[0]
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = torch.from_numpy(slaney_mel_basis(cfg["sampling_rate"], n_fft, cfg["num_mels"],
                                              cfg["fmin"], cfg["fmax"])).to(x.device)
    mel = torch.log(torch.clamp(basis @ mag, min=1e-5)).T
    n = t // hop + 1
    if n > mel.shape[0]:
        mel = torch.cat([mel, mel[-1:]])
    return mel[:n]


# --------------------------------------------------------------------------
# the net
# --------------------------------------------------------------------------

def _features(data, projection, ops, *, query: bool):
    """FAVOR+'s positive random features of (H, N, d) queries or keys
    against the (m, d) projection -> (H, N, m)."""
    d = data.shape[-1]
    scale = d ** -0.25
    ratio = projection.shape[0] ** -0.5
    dash = ops.matmul(scale * data, projection.T)
    diag = (data * data).sum(-1, keepdim=True) * (0.5 * scale * scale)
    if query:
        return ratio * (torch.exp(dash - diag - dash.amax(-1, keepdim=True)) + EPS_FEATURES)
    return ratio * torch.exp(dash - diag + EPS_FEATURES)


def _attention(x, sd, p, heads: int, ops):
    """SelfAttention over (N, C): global heads only, FastAttention's
    non-causal linear attention."""
    n = x.shape[0]

    def split(name):
        y = ops.linear(x, sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"])
        return y.view(n, heads, -1).transpose(0, 1)       # (H, N, d)

    q, k, v = split("to_q"), split("to_k"), split("to_v")
    proj = sd[f"{p}.fast_attention.projection_matrix"]
    q = _features(q, proj, ops, query=True)
    k = _features(k, proj, ops, query=False)
    context = ops.matmul(k.transpose(1, 2), v)             # (H, m, d)
    d_inv = 1.0 / (ops.matmul(q, k.sum(1)[..., None])[..., 0] + EPS_DENOMINATOR)
    out = ops.matmul(q, context) * d_inv[..., None]         # (H, N, d)
    out = out.transpose(0, 1).reshape(n, -1)
    return ops.linear(out, sd[f"{p}.to_out.weight"], sd[f"{p}.to_out.bias"])


def _layer_norm(x, sd, p):
    return F.layer_norm(x, x.shape[-1:], sd[f"{p}.weight"], sd[f"{p}.bias"], 1e-5)


def _conformer(x, sd, p, ops):
    """ConformerConvModule over (N, C)."""
    y = _layer_norm(x, sd, f"{p}.net.0").T[None]          # (1, C, N)
    y = ops.conv1d(y, sd[f"{p}.net.2.weight"], sd[f"{p}.net.2.bias"])
    y = F.glu(y, dim=1)
    w = sd[f"{p}.net.4.conv.weight"]
    half = w.shape[-1] // 2
    y = ops.conv1d(F.pad(y, (half, half)), w, sd[f"{p}.net.4.conv.bias"], groups=y.shape[1])
    y = y * torch.sigmoid(y)
    y = ops.conv1d(y, sd[f"{p}.net.6.weight"], sd[f"{p}.net.6.bias"])
    return y[0].T


def dense_weight(sd) -> torch.Tensor:
    """dense_out's weight, g * v / ||v|| with the norm over each output row."""
    v = sd["dense_out.weight_v"]
    return sd["dense_out.weight_g"] * v / v.norm(dim=1, keepdim=True)


def salience(sd, cfg: dict, mel, ops):
    """(N, mels) log-mel -> (N, out_dims) sigmoid salience."""
    x = mel.T[None]
    x = ops.conv1d(x, sd["stack.0.weight"], sd["stack.0.bias"], padding=1)
    x = F.group_norm(x, GROUPS, sd["stack.1.weight"], sd["stack.1.bias"], 1e-5)
    x = F.leaky_relu(x, 0.01)
    x = ops.conv1d(x, sd["stack.3.weight"], sd["stack.3.bias"], padding=1)[0].T   # (N, C)
    for i in range(cfg["n_layers"]):
        p = f"decoder._layers.{i}"
        x = x + _attention(_layer_norm(x, sd, f"{p}.norm"), sd, f"{p}.attn",
                           cfg["n_heads"], ops)
        x = x + _conformer(x, sd, f"{p}.conformer", ops)
    x = _layer_norm(x, sd, "norm")
    return torch.sigmoid(ops.linear(x, dense_weight(sd), sd["dense_out.bias"]))


# --------------------------------------------------------------------------
# the decode and the predictor's resize
# --------------------------------------------------------------------------

def cent_table(cfg: dict, device) -> torch.Tensor:
    """The out_dims bin centres, evenly spaced in cents from f0_min to
    f0_max (each end as 1200 log2(f / 10) in float32, as FCPE forms it)."""
    ends = 1200.0 * torch.log2(torch.tensor([cfg["f0_min"], cfg["f0_max"]]) / 10.0)
    table = np.linspace(float(ends[0]), float(ends[1]), cfg["out_dims"])
    return torch.from_numpy(table.astype(np.float32)).to(device)


def decode(sal, cfg: dict, q=None):
    """(N, bins) salience -> (N,) Hz by the local argmax; q, where given,
    rounds the operands of the cents average's products, its salience
    weights (Ops.q_decode); the peak and its threshold read the salience
    as given."""
    peak, top = sal.max(dim=-1)
    idx = torch.clamp(top[:, None] + torch.arange(-4, 5, device=sal.device), 0,
                      sal.shape[1] - 1)
    w = (q or (lambda t: t))(torch.gather(sal, 1, idx))
    cents = (cent_table(cfg, sal.device)[idx] * w).sum(1) / w.sum(1)
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    return torch.where(peak > cfg["threshold"], f0, torch.zeros_like(f0))


def resize_fill(f0, p_len: int, out_size: int, hop: int, sr: int):
    """FCPEF0Predictor's post-process of an (n,) track: nearest onto p_len
    frames (source floor(i n / p_len), see the module's note), then np.interp
    in time over the frames with a nonzero F0, the first and last held
    outside them; zeros from p_len to out_size. All unvoiced stays zero."""
    f0 = f0.double().cpu().numpy()
    n = f0.shape[0]
    out = np.zeros(out_size, np.float32)
    src = np.minimum(np.arange(p_len, dtype=np.int64) * n // max(p_len, 1), n - 1)
    f0 = f0[src]
    nz = np.nonzero(f0)[0]
    if nz.size == 1:
        out[:p_len] = f0[nz[0]]
    elif nz.size > 1:
        t_org = hop * nz / sr
        t_frame = np.arange(p_len) * hop / sr
        out[:p_len] = np.interp(t_frame, t_org, f0[nz], left=f0[nz[0]], right=f0[nz[-1]])
    return out


def track(sal, cfg: dict, padded_len: int, out_size: int, window: int = 160, q=None):
    """(n, bins) salience of the padded signal -> (out_size,) Hz: the decode,
    then the resize onto padded_len // window frames."""
    f0 = decode(sal, cfg, q)
    out = resize_fill(f0, padded_len // window, out_size, cfg["hop_size"],
                      cfg["sampling_rate"])
    return torch.from_numpy(out).to(sal.device)


@torch.no_grad()
def padded_salience(sd, cfg: dict, buf, padded_len: int, ops):
    """(n, bins) salience of the padded signal's n = padded_len // hop + 1
    frames, their log-mel read from the zero-tailed buffer."""
    return salience(sd, cfg, log_mel(buf, cfg)[:padded_len // cfg["hop_size"] + 1], ops)


@torch.no_grad()
def fcpe_f0(sd, cfg: dict, buf, padded_len: int, ops, window: int = 160):
    """fcpe over the padded signal in its buffer -> the buffer's
    buf.shape[0] // window + 1 frames in Hz, zero from padded_len // window."""
    sal = padded_salience(sd, cfg, buf, padded_len, ops)
    return track(sal, cfg, padded_len, buf.shape[0] // window + 1, window, ops.q_decode)
