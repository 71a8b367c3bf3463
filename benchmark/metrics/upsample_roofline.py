"""upsample_roofline (%): the decoder's upsampling ConvTranspose1d
(ops/conv_transpose.py, csrc/conv_transpose.cu, K3): the least time for
its valid work over the device time of its kernel.

Work per stage (C_in -> C_out, kernel k, stride u) on T_in valid input
samples: 2 C_in C_out k T_in bf16 operations; bytes: the input read once
and the u-times-longer output written once in the compute dtype, and
the weights (bf16) and bias (fp32) once per chunk batch."""

from benchmark import peaks
from benchmark.work import chunk_frames, chunks

KERNELS = ("convt_kernel",)


def work(config, engine, window):
    cfg = config["synthesizer"]["config"]
    rates, up0, up_k = cfg[12], cfg[13], cfg[14]
    elem = 2 if engine.compute_dtype == "bfloat16" else 4
    flops = nbytes = 0.0
    for length in chunks(window):
        t = chunk_frames(length, config, engine)
        for i, (u, k) in enumerate(zip(rates, up_k)):
            c_in, c_out = up0 // 2 ** i, up0 // 2 ** (i + 1)
            flops += 2 * c_in * c_out * k * t
            nbytes += elem * (c_in * t + c_out * t * u)
            t *= u
    weights = sum(2 * (up0 // 2 ** i) * (up0 // 2 ** (i + 1)) * k + 4 * (up0 // 2 ** (i + 1))
                  for i, k in enumerate(up_k))
    return flops, nbytes + window.batches * weights


def read(ctx):
    seconds = ctx.trace.kernel_ns(KERNELS) * 1e-9
    if seconds <= 0:
        return None
    flops, nbytes = work(ctx.config, ctx.engine, ctx.traced)
    return 100.0 * peaks.bound_s({"bfloat16": flops}, nbytes) / seconds
