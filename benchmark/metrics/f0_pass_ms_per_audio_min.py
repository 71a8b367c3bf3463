"""f0_pass_ms_per_audio_min (ms/min): device time of the kernels launched
inside VoiceConverter._prepare_song (high-pass upload, the F0 pass:
models/rmvpe.py, or models/crepe.py with pipeline/crepe_method.py), per
minute of input audio of the traced window."""

PHASE = "_prepare_song"


def read(ctx):
    ns = ctx.trace.kernel_ns(phase=PHASE)
    if ns <= 0 or ctx.traced.audio_s <= 0:
        return None
    return ns * 1e-6 / (ctx.traced.audio_s / 60.0)
