"""padding_share (%): the share of the synthesizer frames the chunk
batches computed that hold no chunk's valid frames (a row's bucket past
its chunk, and empty rows): 100 x (1 - frames_valid / frames_computed),
from the port's counters (polgen_rvc_tpu_torch/utils/tracing.py). They
count every request of the process, which are the timed and traced
windows' calls (prewarm counts none)."""


def read(ctx):
    try:
        from polgen_rvc_tpu_torch.utils.tracing import counters
    except ImportError:   # a port without the counters
        return None
    now = counters()
    computed = now.get("frames_computed", 0)
    if computed <= 0:
        return None
    return 100.0 * (1.0 - now.get("frames_valid", 0) / computed)
