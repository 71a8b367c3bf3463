"""fcpe_roofline (%): FCPE's F0 pass (models/fcpe.py, pipeline/fcpe_method.py:
the mel, the input stack, the PCmer layers, the head, the decode and the
resize) against its roofline: the least time for its valid work over the
device time of the kernels launched inside VoiceConverter._prepare_song,
which in an fcpe cell are that pass's (the high-pass upload is a copy).
FCPE has no hand-written kernel: this is the layer's share, the number a
change to FCPE's kernels must move.

Work on a song's valid frames, n = padded length // hop + 1 (not the
zero-tailed buffer's): the operations of benchmark/f0/fcpe.py's count,
all float32 (TF32 off); bytes: each layer's activations (n x n_chans)
read and written once in float32, the log-mel read and the salience
written once, and every weight once a song."""

from benchmark import peaks
from benchmark.f0 import fcpe

PHASE = "_prepare_song"


def weight_count(m: dict) -> int:
    """FCPE's parameters at the configuration's widths (fcpe.pt's layout)."""
    c, inner, attn = m["n_chans"], m["n_chans"] * m["expansion"], m["n_heads"] * m["dim_head"]
    stack = 3 * c * (m["input_channel"] + c) + 2 * c + 2 * c
    layer = (2 * c + 3 * (attn * c + attn) + c * attn + c + m["n_features"] * m["dim_head"]
             + 2 * c + 2 * inner * c + 2 * inner + inner * m["kernel"] + inner + c * inner + c)
    head = 2 * c + m["out_dims"] * c + 2 * m["out_dims"]
    return stack + m["n_layers"] * layer + head


def work(config, engine, window):
    """(float32 operations, bytes) of the window's FCPE passes."""
    m = config["fcpe"]
    flops = nbytes = 0.0
    for song in window.songs:
        n = song["padded_len"] // m["hop_size"] + 1
        flops += fcpe.flops(config, engine, song["padded_len"])["float32"]
        per_frame = m["num_mels"] + m["n_chans"] + 2 * m["n_layers"] * m["n_chans"] + m["out_dims"]
        nbytes += 4 * n * per_frame + 4 * weight_count(m)
    return flops, nbytes


def read(ctx):
    if "fcpe" not in ctx.config:
        return None
    seconds = ctx.trace.kernel_ns(phase=PHASE) * 1e-9
    if seconds <= 0:
        return None
    flops, nbytes = work(ctx.config, ctx.engine, ctx.traced)
    return 100.0 * peaks.bound_s({"float32": flops}, nbytes) / seconds
