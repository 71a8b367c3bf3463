"""idle_chunk_batch_ms_per_audio_min (ms/min): the card's idle time while
the host was inside a chunk batch (the polgen.chunk_batch span: rows,
noise, HuBERT, retrieval, the protect mix, enc_p, the flow, the decoder
and the trim), per minute of input audio of the traced window
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_audio_min(ctx, "chunk_batch")
