"""resblock_roofline (%): the decoder's ResBlock groups (ops/resblock_group.py,
csrc/resblock_group.cu, K1+K2): the least time the card could take for
their valid work over the device time of the kernels that compute it.

Work, from the valid frames of each chunk and the published widths: per
stage of C channels at T samples, every ResBlock1 of kernel k and
dilations d runs 2 len(d) convs of 2 C^2 k T operations in bf16. Bytes:
each stage's input read once and output written once in the compute
dtype, and the stage's weights (bf16) and biases (fp32) once per chunk
batch."""

from benchmark import peaks
from benchmark.work import chunk_frames, chunks

KERNELS = ("pair_kernel",)


def work(config, engine, window):
    """(bf16 operations, bytes) of the window's ResBlock groups."""
    cfg = config["synthesizer"]["config"]
    res_k, res_d, rates, up0 = cfg[10], cfg[11], cfg[12], cfg[13]
    elem = 2 if engine.compute_dtype == "bfloat16" else 4
    per_tc = 4 * sum(k * len(d) for k, d in zip(res_k, res_d))  # ops / (C^2 T)
    flops = nbytes = 0.0
    for length in chunks(window):
        t = chunk_frames(length, config, engine)
        for i, u in enumerate(rates):
            t *= u
            c = up0 // 2 ** (i + 1)
            flops += per_tc * c * c * t
            nbytes += 2 * elem * c * t
    weights = sum(2 * len(d) * (c * c * k * 2 + 4 * c)
                  for i in range(len(rates)) for c in [up0 // 2 ** (i + 1)]
                  for k, d in zip(res_k, res_d))
    return flops, nbytes + window.batches * weights


def read(ctx):
    seconds = ctx.trace.kernel_ns(KERNELS) * 1e-9
    if seconds <= 0:
        return None
    flops, nbytes = work(ctx.config, ctx.engine, ctx.traced)
    return 100.0 * peaks.bound_s({"bfloat16": flops}, nbytes) / seconds
