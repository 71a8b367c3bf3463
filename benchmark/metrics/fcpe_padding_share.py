"""fcpe_padding_share (%): the share of the mel frames FCPE's net ran over
that hold no signal (the zero tail of the song's buffer, a multiple of
1,024 frames): 100 x (1 - fcpe_frames_valid / fcpe_frames_computed), from
the port's counters (pipeline/fcpe_method.py). They count every FCPE pass
of the process, prewarm's once per item of the cycle too, and the windows
run whole cycles of the same items, so the share is the cycle's."""


def read(ctx):
    try:
        from polgen_rvc_tpu_torch.utils.tracing import counters
    except ImportError:   # a port without the counters
        return None
    now = counters()
    computed = now.get("fcpe_frames_computed", 0)
    if computed <= 0:
        return None
    return 100.0 * (1.0 - now.get("fcpe_frames_valid", 0) / computed)
