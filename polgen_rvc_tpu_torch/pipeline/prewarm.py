"""prewarm(): a convert's first-call setup, done before the first request.

Mixin half of VoiceConverter (pipeline/engine.py), the port of the JAX
package's pipeline/prewarm.py. There, prewarm overlaps the XLA graph loads
of a convert from a thread pool. Eager PyTorch loads no graphs. On the
card, the first convert pays instead for the nvcc builds and ctypes loads
of the hand-written kernels (ops/cuda_build.py), the CUDA modules' lazy
load, the cuBLAS, cuDNN and cuFFT handles and plans, and the caching
allocator's first allocations at each bucket's sizes. prewarm does that
work with the song's own shapes, so that a convert of the same song after
it builds and loads no kernel. It discards every output and draws no noise
state that convert would see (the default noise is keyed by seed and chunk
id), so a prewarmed converter gives the bytes of one never prewarmed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_build
from ..utils.tracing import spanned
from .config import ConversionOptions

SYNTH_KERNELS = ("resblock_group", "conv_transpose", "band_attention")
RMVPE_KERNELS = ("unet_chain", "gru_scan")
F0_KERNELS = {"rmvpe+": RMVPE_KERNELS, "rmvpe": RMVPE_KERNELS, "mangio-crepe": ("viterbi",)}


class PrewarmMixin:
    """Prewarm half of VoiceConverter (engine.py hosts the converter)."""

    def prewarm_kernels(self, opts: ConversionOptions) -> tuple:
        """The kernels a convert with these options launches, in its order:
        the song's high-pass always, RMVPE's U-Net chain and BiGRU scan for
        rmvpe+ and rmvpe, the Viterbi decode for mangio-crepe (f0 models
        only), the synthesizer's three always."""
        f0 = F0_KERNELS.get(opts.f0_method, ()) if self.synth_cfg.use_f0 else ()
        return ("highpass",) + f0 + SYNTH_KERNELS

    @torch.inference_mode()
    @spanned("polgen.prewarm")
    def prewarm(self, audio16k: np.ndarray,
                opts: ConversionOptions = ConversionOptions(),
                max_workers: int = 8) -> int:
        """Run once, in convert's order, everything a convert of this song
        sets up on first use, and discard the outputs:

        1. on the card, build (at most max_workers nvcc processes at a time)
           and load every kernel library the convert launches;
        2. the song's F0 pass (``_prepare_song``: rmvpe+, fcpe or
           mangio-crepe, then the F0 file where opts name one);
        3. ``_convert_rows`` once for each distinct bucket of the song's
           chunk batches (``_batch_geometry``);
        4. ``_finish_song`` on those rows when opts.volume_envelope != 1,
           for the RMS-envelope gain.

        Its chunk batches add nothing to the frame counters
        (utils/tracing.py): its work is no request.

        The device work runs in order on each device's current stream; only
        the nvcc builds run in parallel. On a mesh the chunk batches run
        through the sharded path, so every distinct mesh device launches
        each of its kernels once (CUDA loads a module per device at its
        first launch there). Returns the number of items warmed: the
        kernel libraries of step 1 (none on the CPU, where the wrappers run
        their plain twins), plus 1 for the F0 pass of an f0 model, plus one
        per distinct bucket, plus 1 for the gain."""
        warmed = 0
        if self.device.type == "cuda":
            names = self.prewarm_kernels(opts)
            cuda_build.build_all(names, max_workers=max_workers)
            for name in names:
                cuda_build.load(name)
            warmed += len(names)
        song = self._prepare_song(audio16k, opts)
        warmed += int(self.synth_cfg.use_f0)
        segments, seen = [], set()
        for idxs, bucket in zip(*self._batch_geometry(song.plan)):
            if bucket in seen:
                continue
            seen.add(bucket)
            segments += self._convert_rows(
                [(song.plan.chunks[ci], ci, song) for ci in idxs], bucket, opts,
                counted=False)
        warmed += len(seen)
        if opts.volume_envelope != 1.0:
            self._finish_song(song, segments, opts)
            warmed += 1
        if self.device.type == "cuda":
            for dev in (self.mesh.distinct() if self.mesh else [self.device]):
                torch.cuda.synchronize(dev)
        return warmed
