"""PolGen-RVC on PyTorch and CUDA: voice conversion with the rmvpe+,
mangio-crepe and fcpe F0 methods, for f0 and no-f0, v1 and v2 models at
32, 40 and 48 kHz, on one NVIDIA H100 (sm_90a).

A second implementation of the system beside the JAX package, held against
it by the tests. It imports torch, numpy and scipy, never jax, and keeps its
own copy of every helper it needs.

Layer map (mirrors the JAX package so each counterpart is easy to find):
    ops/        torch-semantics convs, STFT/mel, GRU, F0 decode, high-pass,
                and the five hand-written CUDA kernels with their plain twins
    csrc/       the kernels' CUDA C++ sources, built with nvcc at first use
    models/     synthesizer / NSF decoder / HuBERT / RMVPE / CREPE / FCPE as
                functions of parameter dictionaries
    convert/    synthetic checkpoints and state-dict -> parameter dictionaries
    retrieval/  exact top-k feature retrieval
    pipeline/   chunk planner, converter engine, output path, builders

Precision: float32 matmuls and convolutions run in full float32 (TF32 off,
set by ``resolve_device``). The F0 pass and the VITS latent run in float32
(CREPE's conv operands excepted, as in the JAX package); everything else
follows ``EngineConfig.compute_dtype``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (or defaulted to) and absent: nothing
    falls back to the CPU on its own. Also pins float32 math to full
    precision (no TF32 in matmuls or cuDNN convolutions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
