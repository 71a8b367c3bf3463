"""F0 files: a user's "time,Hz" track that overrides the computed F0, the
port of the JAX package's ``F0DispatchMixin._apply_f0_file`` with its
quirks, and the host coarse bins that go with it (``coarse_f0_np``).

The override runs on the host after the F0 pass and the pitch shift and
before the coarse bins, for every F0 method, as in the JAX package
(``pipeline/f0_dispatch.py:compute_f0``): the file's Hz are not shifted.
The coarse bins of an overridden track are computed here in numpy, with
float32 Hz against float64 mel bounds, as the JAX package computes them:
a file's smooth ramp lands on .5 boundaries, where the device's float32
rounding (ops/f0_utils.py:coarse_f0) can pick the other bin.
"""

from __future__ import annotations

import numpy as np


def coarse_f0_np(f0, f0_min=50.0, f0_max=1100.0):
    """Host coarse bins (the JAX package's coarse_f0_np): Hz -> int32 1..255."""
    mel_min = 1127 * np.log(1 + f0_min / 700)
    mel_max = 1127 * np.log(1 + f0_max / 700)
    mel = 1127 * np.log(1 + f0 / 700)
    mel[mel > 0] = (mel[mel > 0] - mel_min) * 254 / (mel_max - mel_min) + 1
    mel = np.clip(mel, 1, 255)
    return np.rint(mel).astype(np.int32)


def apply_f0_file(f0: np.ndarray, path: str, engine) -> np.ndarray:
    """Overwrite f0 (float32 (p_len,), the padded signal's frames) in place
    from the file at `path` and return it. Quirks kept from the JAX package:

    - lines split on "," after a strip("\\n"); a read or parse error
      prints "failed to read f0 file: ..." and leaves f0 unchanged;
    - tf0 = sample_rate // window frames a second;
    - delta_t = round((max t - min t) * tf0 + 1) cast to int16, so a file
      spanning more than 327.67 s wraps and overrides nothing;
    - np.interp over range(delta_t) against time * 100 (not time * tf0);
    - writes start at x_pad * tf0 and stop at the end of f0."""
    try:
        with open(path) as f:
            lines = f.read().strip("\n").split("\n")
        inp = np.array(
            [[float(v) for v in line.split(",")] for line in lines],
            dtype=np.float32,
        )
    except Exception as e:  # any unreadable file leaves F0 as computed
        print(f"failed to read f0 file: {e}")
        return f0
    tf0 = engine.sample_rate // engine.window
    delta_t = np.round((inp[:, 0].max() - inp[:, 0].min()) * tf0 + 1).astype("int16")
    replace = np.interp(list(range(delta_t)), inp[:, 0] * 100, inp[:, 1])
    start = engine.x_pad * tf0
    shape = f0[start : start + len(replace)].shape[0]
    f0[start : start + len(replace)] = replace[:shape]
    return f0
