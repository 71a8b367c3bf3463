"""idle_between_calls_ms_per_audio_min (ms/min): the card's idle time
outside every request span of the port (polgen.convert,
polgen.convert_batch): the caller's time, here the client making the
next input, per minute of input audio of the traced window
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_audio_min(ctx, "between_calls")
