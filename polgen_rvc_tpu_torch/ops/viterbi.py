"""Banded Viterbi decode of the CREPE pitch track (torchcrepe's
decode.viterbi semantics) over 360 bins:

    dp[0]    = log(1/360) + log_obs[0]                       (not renormalized)
    cand     = dp[t-1][j+d] + band[j, d] for |d| <= 11, strict > keeps the
               lowest d; the out-of-band "teleport" candidate is
               dp[t-1][m] + log(1e-20) with m the first-index argmax of
               dp[t-1], and wins an exact tie only when m < the in-band source
    dp[t]    = best + log_obs[t], minus its max (renormalized, t >= 1)
    path     = first-index argmax of the last dp, then the backpointers

Rows t >= n pass through (dp unchanged, identity backpointers), so the
path is constant from n - 1 on. Every value is fp32 and every step is an
add, a compare or a subtract, so the CUDA kernel and the plain twin give
the same bits, and both give the paths of the JAX package's lax.scan.

Replaces polgen_rvc_tpu/ops/pallas_viterbi.py:viterbi_path_pallas. On a
CUDA tensor ``viterbi_path`` launches the three sm_90a kernels of
csrc/viterbi.cu: the serial forward recursion in one thread block
(``_forward``), the backpointers of every step and the maps of 16-row
spans in parallel (``_backpointers``), and the walk over the maps, then
the spans (``_walk``); one call counts one launch. On a CPU tensor it
runs ``viterbi_path_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

PITCH_BINS = 360
WIDTH = 12
LOG_EPS = np.float32(np.log(1e-20))
LOG_INIT = np.float32(np.log(1.0 / PITCH_BINS))
# csrc/viterbi.cu: backpointer rows a span (one map each), span maps a
# chunk of the walk
SPAN, WALK_MAPS = 16, 64


def transition_matrix(width: int = WIDTH) -> np.ndarray:
    """(360, 360) float64 triangular transitions, rows summing to 1."""
    i = np.arange(PITCH_BINS)
    t = np.maximum(width - np.abs(i[:, None] - i[None, :]), 0).astype(np.float64)
    return t / t.sum(axis=1, keepdims=True)


def band_table(width: int = WIDTH) -> np.ndarray:
    """(360, 2*width - 1) float32: column d + width - 1 of row j holds
    log(trans[j + d, j] + 1e-20), -inf where j + d falls outside the bins."""
    half = width - 1
    log_trans = np.log(transition_matrix(width) + 1e-20)
    band = np.full((PITCH_BINS, 2 * half + 1), -np.inf, np.float32)
    j = np.arange(PITCH_BINS)
    for d in range(-half, half + 1):
        src = j + d
        ok = (src >= 0) & (src < PITCH_BINS)
        band[ok, d + half] = log_trans[src[ok], j[ok]]
    return band


@functools.lru_cache(maxsize=4)
def _band_on(device: torch.device) -> torch.Tensor:
    """The kernel's band table, copied to a card once."""
    return torch.from_numpy(band_table(WIDTH)).to(device)


def _backtrack(back: np.ndarray, end: int, t_len: int, n: int) -> np.ndarray:
    """back[t - 1] holds row t's backpointers for 1 <= t < n."""
    path = np.full(t_len, end, np.int32)
    cur = end
    for t in range(n - 1, 0, -1):
        cur = int(back[t - 1, cur])
        path[t - 1] = cur
    return path


def viterbi_path_plain(log_obs, n: int, width: int = WIDTH):
    """The recursion step by step in torch ops (the JAX scan's body as a
    Python loop over t): (T, 360) float32 -> (T,) int32 path."""
    t_len, n_bins = log_obs.shape
    dev = log_obs.device
    if t_len == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    n = max(1, min(int(n), t_len))
    half = width - 1
    band = torch.from_numpy(band_table(width)).to(dev)
    gidx = (torch.arange(n_bins, device=dev)[:, None]
            + torch.arange(2 * half + 1, device=dev)[None, :])
    src0 = torch.arange(n_bins, device=dev) - half
    log_eps = torch.tensor(LOG_EPS, device=dev)
    dp = torch.tensor(LOG_INIT, device=dev) + log_obs[0]
    back = torch.empty((max(n - 1, 0), n_bins), dtype=torch.int16, device=dev)
    for t in range(1, n):
        m = torch.argmax(dp)  # first index on ties
        eps_cand = dp[m] + log_eps
        dp_pad = torch.nn.functional.pad(dp, (half, half), value=-float("inf"))
        cand = dp_pad[gidx] + band  # (bins, 2*half + 1), d ascending
        bi_d = torch.argmax(cand, dim=1)  # lowest d on ties
        best = torch.gather(cand, 1, bi_d[:, None])[:, 0]
        bi = bi_d + src0
        take = (eps_cand > best) | ((eps_cand == best) & (m < bi))
        best = torch.where(take, eps_cand, best)
        bi = torch.where(take, m, bi)
        dp_new = best + log_obs[t]
        dp = dp_new - torch.max(dp_new)
        back[t - 1] = bi.to(torch.int16)
    end = int(torch.argmax(dp))
    path = _backtrack(back.cpu().numpy(), end, t_len, n)
    return torch.from_numpy(path).to(dev)


def viterbi_path(log_obs, n: int, width: int = WIDTH):
    """(T, 360) contiguous float32 log observations, n valid rows ->
    (T,) int32 path on the same device."""
    if (log_obs.dim() != 2 or log_obs.shape[1] != PITCH_BINS
            or log_obs.dtype != torch.float32 or not log_obs.is_contiguous()
            or width != WIDTH):
        raise ValueError(f"viterbi_path: log_obs {tuple(log_obs.shape)} "
                         f"{log_obs.dtype} (contiguous: {log_obs.is_contiguous()}), "
                         f"width={width}: takes contiguous float32 (T, "
                         f"{PITCH_BINS}) and width {WIDTH}")
    if log_obs.device.type == "cpu":
        return viterbi_path_plain(log_obs, n, width)
    if log_obs.device.type != "cuda":
        raise ValueError(f"viterbi_path: unsupported device {log_obs.device}")
    t_len = log_obs.shape[0]
    if t_len == 0:
        return torch.empty(0, dtype=torch.int32, device=log_obs.device)
    n = max(1, min(int(n), t_len))
    rows = _forward(log_obs, n)
    back, maps = _backpointers(rows, n)
    path = _walk(rows, back, maps, t_len, n)
    viterbi_path.launches += 1
    return path


def _forward(log_obs, n: int):
    """The forward kernel: (n, 360) fp32 rows, row t = best + log_obs[t]
    of step t before its renormalization (row 0 = dp[0])."""
    rows = torch.empty((n, PITCH_BINS), dtype=torch.float32, device=log_obs.device)
    fn = cuda_build.bind("viterbi", "viterbi_forward", 3,
                         (ctypes.c_int, ctypes.c_float, ctypes.c_float))
    cuda_build.launch(fn, *(cuda_build.ptr(a) for a in
                            (log_obs, _band_on(log_obs.device), rows)),
                      n, float(LOG_EPS), float(LOG_INIT))
    return rows


def _backpointers(rows, n: int):
    """The backpointer kernel: (n, 360) int16 back, row t (1 <= t < n)
    from rows[t - 1] (row 0 unused), and each span's map, (spans, 360)
    int16: path[lo - 1] for path[hi - 1] = b over rows lo .. hi - 1."""
    back = torch.empty((n, PITCH_BINS), dtype=torch.int16, device=rows.device)
    maps = torch.empty((-(-(n - 1) // SPAN), PITCH_BINS), dtype=torch.int16,
                       device=rows.device)
    fn = cuda_build.bind("viterbi", "viterbi_backpointers", 4,
                         (ctypes.c_int, ctypes.c_float))
    cuda_build.launch(fn, *(cuda_build.ptr(a) for a in
                            (rows, _band_on(rows.device), back, maps)),
                      n, float(LOG_EPS))
    return back, maps


def _walk(rows, back, maps, t_len: int, n: int):
    """The walk kernel: the (T,) int32 path from the last row's argmax,
    the span maps and the backpointers."""
    path = torch.empty(t_len, dtype=torch.int32, device=rows.device)
    fn = cuda_build.bind("viterbi", "viterbi_walk", 4, (ctypes.c_int, ctypes.c_int))
    cuda_build.launch(fn, *(cuda_build.ptr(a) for a in (rows, back, maps, path)),
                      t_len, n)
    return path


viterbi_path.launches = 0
