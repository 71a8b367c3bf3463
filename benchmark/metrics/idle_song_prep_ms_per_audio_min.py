"""idle_song_prep_ms_per_audio_min (ms/min): the card's idle time while
the host was preparing a song outside its F0 pass (the polgen.prepare
span: polgen.highpass, polgen.plan, polgen.upload), per minute of input
audio of the traced window (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_audio_min(ctx, "song_prep")
