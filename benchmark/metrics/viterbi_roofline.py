"""viterbi_roofline (%): the mangio-crepe Viterbi decode (ops/viterbi.py,
csrc/viterbi.cu, K6: forward, backpointer and walk kernels): the least
time for its work over the device time of its kernels.

Work on a song's n = padded length // hop + 1 CREPE frames: each step
and bin weighs 2w - 1 in-band candidates and the out-of-band one (an add
and a compare each) and renormalizes (a subtract), fp32 operations off
the tensor cores; bytes: the (n, 360) fp32 log observations read once,
the int32 path written once, the band table once per song."""

from benchmark import peaks

KERNELS = ("viterbi_forward_kernel", "viterbi_back_kernel", "viterbi_walk_kernel")
BINS, WIDTH = 360, 12


def work(config, engine, window):
    hop = int(config["options"]["hop_length"])
    per_bin = 2 * (2 * WIDTH - 1 + 1) + 1
    flops = nbytes = 0.0
    for song in window.songs:
        n = song["padded_len"] // hop + 1
        flops += n * BINS * per_bin
        nbytes += 4 * n * BINS + 4 * n + 4 * BINS * (2 * WIDTH - 1)
    return flops, nbytes


def read(ctx):
    seconds = ctx.trace.kernel_ns(KERNELS) * 1e-9
    if seconds <= 0:
        return None
    flops, nbytes = work(ctx.config, ctx.engine, ctx.traced)
    return 100.0 * peaks.bound_s({"float32": flops}, nbytes) / seconds
