"""chunk_batches_ms_per_audio_min (ms/min): device time of the kernels
launched inside VoiceConverter._convert_rows (one chunk batch: HuBERT,
retrieval, the synthesizer and the decoder), per minute of input audio of
the traced window."""

PHASE = "_convert_rows"


def read(ctx):
    ns = ctx.trace.kernel_ns(phase=PHASE)
    if ns <= 0 or ctx.traced.audio_s <= 0:
        return None
    return ns * 1e-6 / (ctx.traced.audio_s / 60.0)
