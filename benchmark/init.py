"""The fan-in rule that every weight maker shares (``weights.py`` and the
F0 modules in ``f0/``): a leaf of standard normals scaled by
1/sqrt(fan-in). A leaf module, so that the F0 modules and ``weights.py``,
which looks them up, import nothing of each other."""

from __future__ import annotations

import math


def fan(*dims) -> float:
    return 1.0 / max(math.sqrt(math.prod(dims)), 1.0)


def linear(nrm, sd, prefix, out_c, in_c, bias=True):
    sd[f"{prefix}.weight"] = nrm(out_c, in_c) * fan(in_c)
    if bias:
        sd[f"{prefix}.bias"] = nrm(out_c) * 0.02
