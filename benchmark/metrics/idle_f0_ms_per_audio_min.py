"""idle_f0_ms_per_audio_min (ms/min): the card's idle time while the host
was inside the port's F0 pass (the polgen.f0 and polgen.f0_file spans,
with RMVPE's mel, U-Net, BiGRU and decode, or CREPE's net and Viterbi
decode, or FCPE, inside), per minute of input audio of the traced window
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_audio_min(ctx, "f0")
