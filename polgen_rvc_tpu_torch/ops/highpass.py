"""The song's conversion head on the device: the zero-phase 5th-order 48 Hz
Butterworth high-pass (scipy's ``filtfilt``), the float32 cast, the reflect
pad and the int16 quantize against the padded signal's own max, and the
dequantized float32 buffer that the F0 pass and the chunk rows read.

What it computes is ops/filters.py's ``highpass_pad_quant`` (the host
reference, scipy in float64) followed by the dequantize the engine did on
the device: ``filtfilt(b, a, x)`` with ``padtype="odd"``, ``padlen = 18``,
the initial state ``lfilter_zi(b, a)`` scaled by each pass's first input
sample, the forward pass, then the backward pass over its reversed output;
in float64 throughout, as the configuration states (the poles lie at radii
0.981-0.994: a float32 recurrence gives another signal).

The filter is ``lfilter``'s direct form II transposed in state-space form,
z[n+1] = A z[n] + B x[n], y[n] = z0[n] + b0 x[n], run as a blocked scan
over tiles of TILE samples:

    (a) each tile runs the recurrence from a zero state and keeps its end
        state E_k;
    (b) the start states are carried across tiles, S_{k+1} = A^TILE S_k +
        E_k, from S_0 = zi * (the pass's first sample): each of SCAN_GROUPS
        groups of g consecutive tiles composes its own tiles, a
        Hillis-Steele scan over the groups joins them with the powers
        A^(g TILE 2^d), and each group walks its tiles again to give every
        tile its start state;
    (c) each tile reruns the recurrence from its start state and gives its
        outputs.

Each step is lfilter's, operation for operation (y = z0 + x b0, then
z_i = (z_{i+1} + x b_{i+1}) - y a_{i+1}), so within a tile only the start
state separates the result from scipy's. TILE is set by A's transient, not
by its poles: with five poles near 1, the entries of A^k reach 1.7e7 (k =
193) and fall below 1 only from k = 2,608, so at a shorter tile the
carry's products cancel and its rounding reaches the output amplified.
At 4,096 they are below 1.9e-3: the carry rounds like one step of the
recurrence. The powers of A are computed to 60 digits on the host, rounded
to float64 and cached (repeated squaring in float64 diverges here).

No evaluation but scipy's own sequential one reproduces its roundings,
and scipy's float64 filtfilt is itself 8e-8 of the peak from an
extended-precision evaluation of the same recurrence (the DF2T state's
transient amplifies each step's rounding): the blocked scan agrees with
scipy to that order, not to float64 rounding, and its float32 cast and
int16 buffer differ from the host's where that error crosses a rounding
boundary (a 1-count step on up to ~1e-3 of the samples). On the card the
engine feeds this buffer to the F0 pass and the chunk rows, and plans a
song long enough to be cut from the host's own float32 signal, made
meanwhile on a worker thread (pipeline/engine.py: ``_prepare_song``): the
planner's cut points are near-ties that the two roundings decide
differently.

On a CUDA tensor ``highpass_pad_quant`` launches the sm_90a kernels of
csrc/highpass.cu (eight launches, counted once: ``launches.highpass``) on
the current stream, with no host sync: the max, the scale and its inverse
stay on the device.
On a CPU tensor it runs ``highpass_pad_quant_plain``, the same blocked
algorithm: (a) and (c) are scipy's lfilter over the tiles as rows, (b) is
float64 torch ops in the kernel's order, so the kernel's outputs are the
twin's bit for bit. The JAX package has no TPU kernel here: its conversion
head is the host's scipy (or its C++ twin, native/dsp.cpp).
"""

from __future__ import annotations

import ctypes
import decimal
import functools

import numpy as np
import torch
from scipy import signal as _sps

from ..utils.tracing import count
from . import cuda_build
from .filters import F0_FRAME_BUCKET, butter_highpass

ORDER = 5
PADLEN = 3 * (ORDER + 1)  # scipy filtfilt's default for padtype "odd"
TILE = 4096               # samples a tile (csrc/highpass.cu: TILE)
SCAN_GROUPS = 1024        # threads of the carry kernel (SCAN_THREADS)
SCAN_STEPS = 10           # log2(SCAN_GROUPS): the Hillis-Steele steps


@functools.lru_cache(maxsize=1)
def _filter():
    """(b, a, zi, A): float64 numpy, a[0] == 1; A is lfilter's state
    transition with no input."""
    b, a = butter_highpass()
    if a[0] != 1.0:
        raise ValueError("highpass: the Butterworth denominator is not monic")
    zi = _sps.lfilter_zi(b, a)
    trans = np.zeros((ORDER, ORDER))
    trans[:, 0] = -a[1:]
    trans[np.arange(ORDER - 1), np.arange(1, ORDER)] = 1.0
    return b, a, zi, trans


def _power(trans: np.ndarray, k: int) -> np.ndarray:
    """trans^k to 60 digits, rounded to float64."""
    def mul(x, y):
        return [[sum(x[i][m] * y[m][j] for m in range(ORDER)) for j in range(ORDER)]
                for i in range(ORDER)]

    with decimal.localcontext() as ctx:
        ctx.prec = 60
        base = [[decimal.Decimal(float(v)) for v in row] for row in trans]
        out = [[decimal.Decimal(int(i == j)) for j in range(ORDER)] for i in range(ORDER)]
        while k:
            if k & 1:
                out = mul(out, base)
            base = mul(base, base)
            k >>= 1
        return np.array([[float(v) for v in row] for row in out])


def _group(n_tiles: int) -> int:
    """Tiles a group of the carry: every group but the last non-empty one
    full."""
    return max(1, -(-n_tiles // SCAN_GROUPS))


@functools.lru_cache(maxsize=32)
def _params(group: int) -> np.ndarray:
    """The kernel's constants as one float64 array: b (6), a (6), zi (5),
    A^TILE (5 x 5, row-major), then A^(group TILE 2^d) for d < SCAN_STEPS."""
    b, a, zi, trans = _filter()
    powers = [_power(trans, TILE)]
    powers += [_power(trans, group * TILE * 2 ** d) for d in range(SCAN_STEPS)]
    out = np.concatenate([b, a, zi] + [p.ravel() for p in powers])
    out.setflags(write=False)
    return out


def bucket_length(n: int, t_pad: int, window: int) -> int:
    """The quantized buffer: the padded signal's length rounded up to a
    multiple of F0_FRAME_BUCKET frames (ops/filters.quantize_int16)."""
    step = F0_FRAME_BUCKET * window
    return max(-(-(n + 2 * t_pad) // step), 1) * step


def reflect_index(j: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``mode="reflect"`` pad as an index into the signal, for any
    pad width: the signal mirrored without repeating its edges, period
    2 (n - 1)."""
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * (n - 1)
    m = torch.remainder(j, period)
    return torch.where(m < n, m, period - m)


# ----------------------------------------------------------------------
# the plain twin
# ----------------------------------------------------------------------

def _check(x: torch.Tensor):
    if x.dim() != 1 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"highpass: x {tuple(x.shape)} {x.dtype}: takes a 1-D "
                         "float32 or float64 signal")
    if x.shape[0] <= PADLEN:
        raise ValueError(f"highpass: the signal has {x.shape[0]} samples; "
                         f"filtfilt needs more than padlen = {PADLEN}")


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(5, 5) @ (5, K), each row summed over j = 0..4 in order, as the
    kernel sums it."""
    acc = m[:, 0:1] * v[0:1]
    for j in range(1, ORDER):
        acc = acc + m[:, j:j + 1] * v[j:j + 1]
    return acc


def _carry(ends: torch.Tensor, s0: torch.Tensor, group: int) -> torch.Tensor:
    """Each tile's start state (5, n_tiles) from the zero-start end states
    (5, n_tiles) and the pass's start state s0 (5,): the carry kernel's
    three steps, over SCAN_GROUPS groups of `group` tiles."""
    p = torch.from_numpy(_params(group).copy())
    a_tile = p[17:42].reshape(ORDER, ORDER)
    powers = p[42:].reshape(SCAN_STEPS, ORDER, ORDER)
    n_tiles = ends.shape[1]
    first = torch.arange(SCAN_GROUPS, device=ends.device) * group
    u = torch.zeros((ORDER, SCAN_GROUPS), dtype=torch.float64, device=ends.device)
    u[:, 0] = s0
    for k in range(group):
        tile = first + k
        live = tile < n_tiles
        e = ends[:, tile.clamp(max=n_tiles - 1)]
        u = torch.where(live, _matvec(a_tile, u) + e, u)
    for d in range(SCAN_STEPS):
        off = 1 << d
        u = torch.cat([u[:, :off], u[:, off:] + _matvec(powers[d], u[:, :-off])], dim=1)
    st = torch.cat([s0[:, None], u[:, :-1]], dim=1)
    starts = torch.empty_like(ends)
    for k in range(group):
        tile = first + k
        live = tile < n_tiles
        starts[:, tile[live]] = st[:, live]
        e = ends[:, tile.clamp(max=n_tiles - 1)]
        st = torch.where(live, _matvec(a_tile, st) + e, st)
    return starts


def _lfilter_pass(s: np.ndarray) -> np.ndarray:
    """One pass of lfilter over the float64 signal s from zi * s[0], as
    the blocked scan: (a) and (c) are lfilter itself over the tiles as
    rows (the samples past the end read as 0)."""
    b, a, zi, _ = _filter()
    n = s.shape[0]
    n_tiles = -(-n // TILE)
    tiles = np.zeros(n_tiles * TILE)
    tiles[:n] = s
    tiles = tiles.reshape(n_tiles, TILE)
    _, ends = _sps.lfilter(b, a, tiles, axis=1, zi=np.zeros((n_tiles, ORDER)))
    starts = _carry(torch.from_numpy(ends.T.copy()), torch.from_numpy(zi * s[0]),
                    _group(n_tiles))
    out, _ = _sps.lfilter(b, a, tiles, axis=1, zi=starts.T.numpy())
    return out.reshape(-1)[:n]


def filtfilt_plain(x: torch.Tensor) -> torch.Tensor:
    """scipy's filtfilt(b, a, x) with the odd extension, as the blocked
    scan in float64 on the host: (n,) float32 or float64 -> (n,) float64
    on x's device."""
    _check(x)
    xd = x.detach().cpu().double().numpy()
    ext = np.concatenate([2 * xd[0] - xd[PADLEN:0:-1], xd,
                          2 * xd[-1] - xd[-2:-PADLEN - 2:-1]])
    fwd = _lfilter_pass(ext)
    out = _lfilter_pass(fwd[::-1].copy())[::-1][PADLEN:-PADLEN]
    return torch.from_numpy(out.copy()).to(x.device)


def pad_quant_plain(audio: torch.Tensor, t_pad: int, window: int = 160):
    """The float32 signal's reflect pad by t_pad and its int16 quantize
    into a zero-tailed bucket (ops/filters.quantize_int16, with numpy's
    float32 rounding), and the dequantized buffer:
    (int16 (bucket,), inv_scale float32 0-dim, buf float32 (bucket,))."""
    n = audio.shape[0]
    t = n + 2 * t_pad
    bucket = bucket_length(n, t_pad, window)
    amax = float(audio.abs().max())
    scale = 32767.0 / amax if amax > 0 else 1.0
    idx = reflect_index(torch.arange(t, device=audio.device) - t_pad, n)
    scaled = audio[idx] * torch.tensor(scale, dtype=torch.float32)
    q = torch.zeros(bucket, dtype=torch.int16, device=audio.device)
    q[:t] = torch.round(scaled).to(torch.int16)
    inv = torch.tensor(np.float32(1.0 / scale), device=audio.device)
    return q, inv, q.float() * inv


def highpass_pad_quant_plain(x: torch.Tensor, t_pad: int, window: int = 160):
    """The op's plain twin: (audio float32 (n,), q int16 (bucket,),
    inv_scale float32 0-dim, buf float32 (bucket,))."""
    audio = filtfilt_plain(x).float()
    return (audio, *pad_quant_plain(audio, t_pad, window))


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------

def highpass_pad_quant(x: torch.Tensor, t_pad: int, window: int = 160):
    """Raw 16 kHz signal (n,) float32 or float64, contiguous -> (audio, q,
    inv_scale, buf) on its device, as highpass_pad_quant_plain gives them:
    the high-passed float32 signal, the int16 buffer of its reflect-padded
    copy (n + 2 t_pad valid samples, then zeros), the inverse
    scale, and buf = q * inv_scale."""
    _check(x)
    if t_pad < 0 or window <= 0:
        raise ValueError(f"highpass: t_pad {t_pad}, window {window}")
    if x.device.type == "cpu":
        return highpass_pad_quant_plain(x, t_pad, window)
    if x.device.type != "cuda":
        raise ValueError(f"highpass: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("highpass: x must be contiguous")
    dev, n = x.device, x.shape[0]
    ext = n + 2 * PADLEN
    n_tiles = -(-ext // TILE)
    group = _group(n_tiles)
    params = _params(group)
    bucket = bucket_length(n, t_pad, window)
    f64 = dict(dtype=torch.float64, device=dev)
    fwd = torch.empty(ext, **f64)
    ends = torch.empty((n_tiles, ORDER), **f64)
    starts = torch.empty((n_tiles, ORDER), **f64)
    audio = torch.empty(n, dtype=torch.float32, device=dev)
    amax = torch.empty(1, dtype=torch.int32, device=dev)
    q = torch.empty(bucket, dtype=torch.int16, device=dev)
    buf = torch.empty(bucket, dtype=torch.float32, device=dev)
    inv = torch.empty((), dtype=torch.float32, device=dev)
    fn = cuda_build.bind("highpass", "highpass_pad_quant", 10,
                         (ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_int))
    cuda_build.launch(fn, dev, cuda_build.ptr(x),
                      ctypes.c_void_p(params.ctypes.data),
                      *(cuda_build.ptr(t) for t in (fwd, ends, starts, audio, amax,
                                                     q, buf, inv)),
                      int(x.dtype == torch.float64), n, t_pad, bucket, group)
    count("launches.highpass")
    return audio, q, inv, buf
