"""The F0 pass of the reference: RMVPE (log-mel, U-Net, BiGRU, salience
decode) and mangio-crepe (CREPE "full" salience, banded Viterbi, the
weighted cents and the resize onto the engine's frames), from the raw
rmvpe.pt and torchcrepe state dicts, in plain PyTorch and NumPy."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CENTS_OFFSET = 1997.3794084376191
BINS = 360


# --------------------------------------------------------------------------
# spectral frontend (librosa-compatible HTK mels, periodic Hann, reflect)
# --------------------------------------------------------------------------

def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank_htk(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float):
    """(n_mels, n_fft // 2 + 1) triangular HTK mels with slaney area norm."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz_htk(np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax),
                                       n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel(x, basis: np.ndarray, n_fft: int, hop: int):
    """(T,) float32 -> (n_mels, frames): log(clamp(mel @ |STFT|, 1e-5)),
    centred with reflect padding."""
    n = np.arange(n_fft)
    win = torch.from_numpy((0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft)).astype(np.float32))
    spec = torch.stft(x.float()[None], n_fft, hop_length=hop, window=win.to(x.device),
                      center=True, pad_mode="reflect", return_complex=True)
    mag = torch.sqrt(spec.real * spec.real + spec.imag * spec.imag)
    return torch.log(torch.clamp(torch.matmul(torch.from_numpy(basis).to(x.device), mag),
                                 min=1e-5))[0]


# --------------------------------------------------------------------------
# pitch helpers
# --------------------------------------------------------------------------

def cents_table(device):
    return torch.from_numpy((20.0 * np.arange(BINS) + CENTS_OFFSET).astype(np.float32)).to(device)


def coarse_f0(f0, f0_min: float, f0_max: float):
    """Hz -> the 1..255 coarse mel bins, rounded half to even."""
    mel_min = 1127.0 * np.log(1.0 + f0_min / 700.0)
    mel_max = 1127.0 * np.log(1.0 + f0_max / 700.0)
    mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = torch.where(mel > 0, (mel - mel_min) * 254.0 / (mel_max - mel_min) + 1.0, mel)
    return torch.round(torch.clamp(scaled, 1.0, 255.0)).long()


def _weighted_cents(sal, center):
    """Salience-weighted mean of the cents of the 9 bins around center."""
    cents = F.pad(cents_table(sal.device), (4, 4))
    idx = center.long()[:, None] + torch.arange(9, device=sal.device)[None, :]
    w = torch.gather(F.pad(sal, (4, 4)), 1, idx)
    return (w * cents[idx]).sum(1) / torch.clamp(w.sum(1), min=1e-12)


def f0_mismatch_pct(got, ref, frames: int, cents: float = 50.0) -> float:
    """Share (%) of the first `frames` frames where two F0 tracks disagree:
    one voiced and the other not, or both voiced and more than `cents`
    apart."""
    got, ref = got[:frames].double(), ref[:frames].double()
    vg, vr = got > 0, ref > 0
    both = vg & vr
    apart = torch.zeros_like(vg)
    apart[both] = (1200.0 * torch.log2(got[both] / ref[both])).abs() > cents
    return 100.0 * float(((vg != vr) | apart).double().mean()) if frames else 0.0


def _cents_error(got, ref, frames: int):
    """Per frame voiced in either of two tracks, over their first `frames`
    frames: |1200 log2(got / ref)| capped at 1200 where both are voiced,
    1200 where only one is."""
    got, ref = got[:frames].double(), ref[:frames].double()
    vg, vr = got > 0, ref > 0
    err = torch.full_like(got, 1200.0)
    both = vg & vr
    err[both] = torch.clamp((1200.0 * torch.log2(got[both] / ref[both])).abs(), max=1200.0)
    return err[vg | vr]


def f0_cents_max(got, ref, frames: int) -> float:
    """The largest pitch error in cents over the first `frames` frames
    voiced in either track: a fault on any one frame reads in full."""
    err = _cents_error(got, ref, frames)
    return float(err.max()) if err.numel() else 0.0


def salience_rel_err(got, ref) -> float:
    """||got - ref|| / ||ref|| of two (frames, bins) saliences, in float64."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        return float("inf")
    return float((got - ref).norm() / torch.clamp(ref.norm(), min=1e-300))


# --------------------------------------------------------------------------
# RMVPE
# --------------------------------------------------------------------------

def _bn(x, sd, prefix, eps=1e-5):
    return F.batch_norm(x, sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"],
                        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], False, 0.0, eps)


def fold_bn(w, sd, prefix, out_axis: int = 0, eps: float = 1e-5):
    """Eval-mode batch norm folded into the bias-free conv before it, in
    float64: (w * s, beta - mean * s) with s = gamma / sqrt(var + eps)."""
    s = sd[f"{prefix}.weight"].double() / torch.sqrt(sd[f"{prefix}.running_var"].double() + eps)
    shape = [1] * w.dim()
    shape[out_axis] = -1
    b = sd[f"{prefix}.bias"].double() - sd[f"{prefix}.running_mean"].double() * s
    return (w.double() * s.view(shape)).float(), b.float()


def _conv_block_res(x, sd, prefix, ops):
    """relu(conv(relu(conv(x)))) + x or its 1x1 shortcut; batch norms folded
    into the 3x3 convs, whose operands take the layer's stated precision."""
    w1, b1 = fold_bn(sd[f"{prefix}.conv.0.weight"], sd, f"{prefix}.conv.1")
    w2, b2 = fold_bn(sd[f"{prefix}.conv.3.weight"], sd, f"{prefix}.conv.4")
    h = F.relu(ops.unet_conv2d(x, w1, b1, padding=1))
    h = F.relu(ops.unet_conv2d(h, w2, b2, padding=1))
    if f"{prefix}.shortcut.weight" in sd:
        x = ops.unet_conv2d(x, sd[f"{prefix}.shortcut.weight"], sd[f"{prefix}.shortcut.bias"],
                            round_input=False)
    return h + x


def _conv_transpose2d_deterministic(x, w, b):
    """The decoder's 2x transposed conv under cuDNN's deterministic flag,
    restored after: its default algorithm on the card sums with atomics,
    which moves the F0 track from run to run."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic
    cudnn.deterministic = True
    try:
        return F.conv_transpose2d(x, w, b, stride=2, padding=1, output_padding=1)
    finally:
        cudnn.deterministic = prev


def rmvpe_salience(sd, mel, ops, n_blocks: int = 4):
    """(128, T) log-mel, T a multiple of 32 -> (T, 360) salience."""
    s = sd["unet.encoder.bn.weight"].double() / torch.sqrt(
        sd["unet.encoder.bn.running_var"].double() + 1e-5)
    shift = sd["unet.encoder.bn.bias"].double() - sd["unet.encoder.bn.running_mean"].double() * s
    x = mel.T[None, None] * s.float() + shift.float()
    skips = []
    for i in range(5):
        for j in range(n_blocks):
            x = _conv_block_res(x, sd, f"unet.encoder.layers.{i}.conv.{j}", ops)
        skips.append(x)
        x = F.avg_pool2d(x, 2)
    for i in range(4):
        for j in range(n_blocks):
            x = _conv_block_res(x, sd, f"unet.intermediate.layers.{i}.conv.{j}", ops)
    for i, skip in enumerate(reversed(skips)):
        p = f"unet.decoder.layers.{i}"
        w, b = fold_bn(sd[f"{p}.conv1.0.weight"], sd, f"{p}.conv1.1", out_axis=1)
        x = _conv_transpose2d_deterministic(x, w, b)
        x = torch.cat([F.relu(x), skip], dim=1)
        for j in range(n_blocks):
            x = _conv_block_res(x, sd, f"{p}.conv2.{j}", ops)
    x = F.conv2d(x, sd["cnn.weight"], sd["cnn.bias"], padding=1)
    x = x.transpose(1, 2).flatten(-2)  # (1, T, 3 * 128)
    gru = torch.nn.GRU(384, 256, batch_first=True, bidirectional=True,
                       device=x.device, dtype=torch.float32)
    with torch.no_grad():
        for name, value in gru.named_parameters():
            value.copy_(sd[f"fc.0.gru.{name}"])
        x, _ = gru(x)
    return torch.sigmoid(F.linear(x, sd["fc.1.weight"], sd["fc.1.bias"]))[0]


def rmvpe_f0(sd, buf, ops):
    """(S,) padded signal in its zero-tailed buffer -> (S // 160 + 1,) Hz,
    RMVPE read over the whole buffer, zero below 0.03 peak salience."""
    basis = mel_filterbank_htk(16000, 1024, 128, 30.0, 8000.0)
    mel = log_mel(buf, basis, 1024, 160)
    n = mel.shape[-1]
    pad = min(32 * ((n - 1) // 32 + 1) - n, n)
    if pad:
        mel = F.pad(mel[None], (0, pad), mode="reflect")[0]
    sal = rmvpe_salience(sd, mel, ops)[:n]
    peak = sal.amax(dim=-1)
    cents = torch.where(peak > 0.03, _weighted_cents(sal, sal.argmax(dim=-1)),
                        torch.zeros_like(peak))
    f0 = 10.0 * torch.pow(2.0, cents / 1200.0)
    return torch.where(cents == 0.0, torch.zeros_like(f0), f0)


# --------------------------------------------------------------------------
# CREPE "full" and its Viterbi decode
# --------------------------------------------------------------------------

def crepe_salience(sd, frames, layers, ops):
    """(N, 1024) normalized frames -> (N, 360) sigmoid salience, torchcrepe's
    layers: pad, conv, ReLU, batch norm, max pool."""
    x = frames[:, None, :]
    for i, (_, _, stride, pt, pb) in enumerate(layers):
        # torchcrepe's (k, 1) Conv2d over (N, C, T, 1) is a Conv1d over (N, C, T)
        x = ops.conv1d(F.pad(x, (pt, pb)), sd[f"conv{i + 1}.weight"][..., 0],
                       sd[f"conv{i + 1}.bias"], stride=stride)
        x = _bn(F.relu(x), sd, f"conv{i + 1}_BN", eps=0.0010000000474974513)
        x = F.max_pool1d(x, 2)
    x = x.transpose(1, 2).reshape(x.shape[0], -1)
    return torch.sigmoid(F.linear(x, sd["classifier.weight"], sd["classifier.bias"]))


def _band(width: int = 12) -> np.ndarray:
    """(360, 2w - 1): log(trans[j + d, j] + 1e-20), -inf off the bins, of the
    triangular transition matrix with rows summing to 1."""
    i = np.arange(BINS)
    trans = np.maximum(width - np.abs(i[:, None] - i[None, :]), 0).astype(np.float64)
    log_t = np.log(trans / trans.sum(axis=1, keepdims=True) + 1e-20)
    half = width - 1
    band = np.full((BINS, 2 * half + 1), -np.inf, np.float32)
    for d in range(-half, half + 1):
        src = i + d
        ok = (src >= 0) & (src < BINS)
        band[ok, d + half] = log_t[src[ok], i[ok]]
    return band


def viterbi(log_obs: np.ndarray, width: int = 12) -> np.ndarray:
    """(T, 360) float32 log observations -> (T,) path. In-band moves by
    the band table (lowest offset on ties); the out-of-band move from the
    first-index argmax at log(1e-20) wins an exact tie only from a lower
    bin; each step is renormalized by its max."""
    t_len = log_obs.shape[0]
    half = width - 1
    band = _band(width)
    gidx = np.arange(BINS)[:, None] + np.arange(2 * half + 1)[None, :]
    log_eps = np.float32(np.log(1e-20))
    dp = np.float32(np.log(1.0 / BINS)) + log_obs[0]
    back = np.zeros((max(t_len - 1, 0), BINS), np.int64)
    dp_pad = np.full(BINS + 2 * half, -np.inf, np.float32)
    for t in range(1, t_len):
        m = int(np.argmax(dp))
        eps_cand = np.float32(dp[m] + log_eps)
        dp_pad[half:half + BINS] = dp
        cand = dp_pad[gidx] + band
        bi_d = np.argmax(cand, axis=1)
        best = cand[np.arange(BINS), bi_d]
        bi = bi_d + np.arange(BINS) - half
        take = (eps_cand > best) | ((eps_cand == best) & (m < bi))
        best = np.where(take, eps_cand, best).astype(np.float32)
        bi = np.where(take, m, bi)
        new = best + log_obs[t]
        dp = (new - new.max()).astype(np.float32)
        back[t - 1] = bi
    path = np.empty(t_len, np.int64)
    path[-1] = int(np.argmax(dp))
    for t in range(t_len - 1, 0, -1):
        path[t - 1] = back[t - 1, path[t]]
    return path


def crepe_salience_track(sd, buf, padded_len: int, hop: int, layers, ops,
                         slab: int = 512):
    """mangio-crepe's salience over the padded signal: n = padded_len // hop
    + 1 frames of 1024 samples (frame f from sample f * hop - 512, zeros
    outside the buffer), each normalized by its mean and population std;
    computed in slabs, each cast to float16 -> (n, 360) float32."""
    n = padded_len // hop + 1
    x = F.pad(buf.float(), (512, n * hop + 1024))
    sal = []
    for s0 in range(0, n, slab):
        rows = min(slab, n - s0)
        fr = x[s0 * hop: s0 * hop + (rows - 1) * hop + 1024].unfold(0, 1024, hop)
        fr = (fr - fr.mean(-1, keepdim=True)) / torch.clamp(
            fr.std(-1, keepdim=True, correction=0), min=1e-10)
        sal.append(crepe_salience(sd, fr, layers, ops).to(torch.float16))
    return torch.cat(sal).float()


def crepe_decode(sal, padded_len: int, f0_min: float, f0_max: float, out_size: int,
                 q=None):
    """(n, 360) float32 salience -> (out_size,) Hz: bins outside [f0_min,
    f0_max] masked, the Viterbi decode, the weighted cents, then the resize
    onto padded_len // 160 frames, zero from there to out_size. q, where
    given, rounds the decode's operands: the log observations and the
    salience the cents average weighs (Ops.q_decode)."""
    q = q or (lambda t: t)
    n = sal.shape[0]
    freqs = 10.0 * 2.0 ** ((20.0 * np.arange(BINS) + CENTS_OFFSET).astype(np.float32)
                           .astype(np.float64) / 1200.0)
    masked = torch.from_numpy((freqs < f0_min) | (freqs > f0_max)).to(sal.device)
    probs = torch.where(masked[None, :], torch.zeros_like(sal), sal)
    obs = probs / torch.clamp(probs.sum(1, keepdim=True), min=1e-20)
    path = viterbi(q(torch.log(obs + 1e-20)).cpu().numpy())
    cents = _weighted_cents(q(sal), torch.from_numpy(path).to(sal.device))
    f0 = 10.0 * (2.0 ** (cents / 1200.0))
    # the reference resize: np.interp of the n-frame track onto p_len frames
    p_len = padded_len // 160
    f0 = f0.cpu().numpy().astype(np.float64)
    f0[f0 < 0.001] = np.nan
    grid = np.arange(p_len) * n / p_len
    out = np.interp(grid, np.arange(n), f0)
    out = np.nan_to_num(out).astype(np.float32)
    full = np.zeros(out_size, np.float32)
    full[:p_len] = out
    return torch.from_numpy(full).to(sal.device)


def crepe_f0(sd, buf, padded_len: int, hop: int, f0_min: float, f0_max: float,
             layers, ops, slab: int = 512):
    """mangio-crepe over the padded signal: the salience track, then the
    decode onto the buffer's S // 160 + 1 frames."""
    sal = crepe_salience_track(sd, buf, padded_len, hop, layers, ops, slab)
    return crepe_decode(sal, padded_len, f0_min, f0_max, buf.shape[0] // 160 + 1,
                        ops.q_decode)
