"""unet_roofline (%): RMVPE's U-Net ConvBlockRes chains (ops/unet_chain.py,
csrc/unet_chain.cu, K5): the least time for their valid work over the
device time of their kernel.

Work on a song's valid F0 frames (padded length // 160 + 1, not the
zero-tailed buffer): per level at T frames and W mel columns, each block
of C_in -> C channels runs two 3x3 convs, 2 * 9 C_in C T W and
2 * 9 C C T W bf16 operations, and a 1x1 shortcut, 2 C_in C T W, where
it changes the width. Bytes: each level's input read once and its output
written once in fp32 (the F0 pass's dtype), its weights (bf16) and biases
(fp32) once per song."""

from benchmark import peaks

KERNELS = ("unet_conv3x3_kernel",)
N_BLOCKS = 4


def levels(frames: float):
    """[(C_in, C, T, W)] of every chain of RMVPE's U-Net (E2E(4, 1, (2, 2)))."""
    out = []
    c_in, c = 1, 16
    for i in range(5):
        out.append((c_in, c, frames / 2 ** i, 128 / 2 ** i))
        c_in, c = c, c * 2
    for i in range(4):
        out.append((256 if i == 0 else 512, 512, frames / 32, 4))
    c = 512
    for i in range(5):
        oc = c // 2
        out.append((2 * oc, oc, frames / 2 ** (4 - i), 8 * 2 ** i))
        c = oc
    return out


def chain_work(c_in, c, t, w):
    """(operations, weight bytes) of one level's chain."""
    flops = wbytes = 0.0
    for j in range(N_BLOCKS):
        cin = c_in if j == 0 else c
        flops += 2 * 9 * cin * c * t * w + 2 * 9 * c * c * t * w
        wbytes += 2 * 9 * (cin * c + c * c) + 8 * c
        if cin != c:
            flops += 2 * cin * c * t * w
            wbytes += 2 * cin * c + 4 * c
    return flops, wbytes


def work(config, engine, window):
    flops = nbytes = 0.0
    for song in window.songs:
        n = song["padded_len"] // engine.window + 1
        for c_in, c, t, w in levels(n):
            f, wb = chain_work(c_in, c, t, w)
            flops += f
            nbytes += 4 * t * w * (c_in + c) + wb
    return flops, nbytes


def read(ctx):
    seconds = ctx.trace.kernel_ns(KERNELS) * 1e-9
    if seconds <= 0:
        return None
    flops, nbytes = work(ctx.config, ctx.engine, ctx.traced)
    return 100.0 * peaks.bound_s({"bfloat16": flops}, nbytes) / seconds
