"""RMVPE's bidirectional GRU on ``torch.nn.GRU``.

The parameters are torch-layout tensors (w_ih_l0, w_hh_l0, b_ih_l0, b_hh_l0
and the *_reverse set), so the gate order is torch's own (reset, update,
new), the order the JAX package's lax.scan GRU (ops/rnn.py) reproduces.
"""

from __future__ import annotations

import torch

from ..utils.tracing import spanned

_GRU_NAMES = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


@spanned("polgen.rmvpe.bigru")
def bigru(x, params: dict):
    """(B, T, I) -> (B, T, 2H): concat(forward, backward) hidden states."""
    hdim = params["w_hh_l0"].shape[1]
    gru = torch.nn.GRU(x.shape[-1], hdim, batch_first=True,
                       bidirectional=True, device=x.device, dtype=x.dtype)
    with torch.no_grad():
        for suffix in ("", "_reverse"):
            for name in _GRU_NAMES:
                key = name.replace("weight", "w").replace("bias", "b")
                getattr(gru, name + suffix).copy_(params[key + suffix])
        out, _ = gru(x)
    return out
