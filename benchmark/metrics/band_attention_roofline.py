"""band_attention_roofline (%): enc_p's windowed relative-position
attention (ops/band_attention.py, csrc/band_attention.cu, K4): the least
time for its valid work over the device time of its kernel.

Work per layer on a chunk of T valid frames, width H over its heads,
window w: the scores and the value product, 2 * 2 T^2 H, and the
relative key and value terms, 2 * 2 T (2w + 1) H, bf16 operations;
bytes: q, k, v and the output once each in bf16, the relative tables
once per chunk batch."""

from benchmark import peaks
from benchmark.work import chunk_frames, chunks

KERNELS = ("band_attention_kernel",)
WINDOW = 10


def work(config, engine, window):
    cfg = config["synthesizer"]["config"]
    hidden, heads, layers = cfg[3], cfg[5], cfg[6]
    band = 2 * WINDOW + 1
    flops = nbytes = 0.0
    for length in chunks(window):
        t = chunk_frames(length, config, engine)
        flops += layers * (4 * t * t * hidden + 4 * t * band * hidden)
        nbytes += layers * 2 * 4 * t * hidden
    return flops, nbytes + window.batches * layers * 2 * 2 * band * (hidden // heads)


def read(ctx):
    seconds = ctx.trace.kernel_ns(KERNELS) * 1e-9
    if seconds <= 0:
        return None
    flops, nbytes = work(ctx.config, ctx.engine, ctx.traced)
    return 100.0 * peaks.bound_s({"bfloat16": flops}, nbytes) / seconds
