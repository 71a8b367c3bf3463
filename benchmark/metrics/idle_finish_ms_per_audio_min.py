"""idle_finish_ms_per_audio_min (ms/min): the card's idle time while the
host was finishing a song (the polgen.finish span: the envelope, the
readback, the host's finalize), or inside a request span
(polgen.convert, polgen.convert_batch) but in none of its phases, per
minute of input audio of the traced window (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_audio_min(ctx, "finish")
