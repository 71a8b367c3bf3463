"""launches_per_audio_min (launches/min): device kernels in the traced
window per minute of input audio its calls converted; the engine's
host launch path (pipeline/engine.py, ops/cuda_build.py, ops/rnn.py)."""


def read(ctx):
    n = len(ctx.trace.kernels)
    if n == 0 or ctx.traced.audio_s <= 0:
        return None
    return n / (ctx.traced.audio_s / 60.0)
