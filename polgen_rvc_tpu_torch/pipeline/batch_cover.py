"""Batch covers: chunks of several songs packed into shared chunk batches,
the port of the JAX package's pipeline/batch_cover.py.

Each song is prepared as ``convert`` prepares it (host high-pass, pad and
quantize, chunk plan, one F0 pass on the device); then a global work list
of (song, chunk) pairs, sorted by each chunk's own bucket class, runs
``chunk_batch`` rows at a time, each batch padded to its largest chunk;
then each song's rows, in chunk order, take the whole-song RMS gain, int16
pack and host finalize that ``convert`` applies. On a mesh the packed
batches shard over the data rows as ``convert``'s do (``_convert_rows``). Noise is drawn per (seed,
song-local chunk id), so a row renders the same whatever rides beside it:
a song whose chunks ride the buckets they ride in ``convert`` comes out
byte for byte as ``convert`` gives it. A chunk on a larger bucket gives
the same bytes on the card too (the masked models are pad-invariant, and
the decoder's conv_pre, whose cuDNN algorithm changes with the length,
runs at one fixed length); on the CPU the plain twins' convolutions pick
their algorithms by length, and such a chunk differs by rounding only.

The JAX package groups chunks by bucket class instead, which bounds the
shapes XLA compiles. Eager PyTorch compiles nothing per shape, so the
port fills the rows that grouping would leave empty: a batch's work
scales with its bucket times ``chunk_batch`` rows, real or not.

Every F0 method packs, with or without an F0 file: the port's F0 pass is
one device call per song for rmvpe+, mangio-crepe and fcpe alike, and an
F0 file overrides a song's F0 before any row is assembled (the JAX
package converts crepe, fcpe and F0-file songs serially because its F0
for them runs on the host).
"""

from __future__ import annotations

import torch

from ..utils.progress import NULL_PROGRESS, ProgressReporter
from ..utils.tracing import spanned
from .config import ConversionOptions


def bucket_class(chunk, engine) -> int:
    """The smallest bucket of the engine's grid that holds this chunk."""
    step = engine.bucket_step_s * engine.sample_rate
    return -(-(chunk.slice_end - chunk.slice_start) // step) * step


def pack_work(plans, engine) -> list:
    """Chunk plans of several songs -> [(bucket, [(song, chunk id), ...]), ...]:
    every chunk sorted by its bucket class, largest first (ties in song
    then chunk order), cut chunk_batch at a time, each batch padded to its
    first chunk's class. That is the fewest batches, and of the ways to
    fill that many, the one with the least bucket length summed over them:
    only the last batch can have empty rows, and it holds the smallest
    chunks."""
    work = sorted(((bucket_class(c, engine), si, ci)
                   for si, plan in enumerate(plans)
                   for ci, c in enumerate(plan.chunks)),
                  key=lambda w: (-w[0], w[1], w[2]))
    B = engine.chunk_batch
    return [(work[g0][0], [(si, ci) for _, si, ci in work[g0:g0 + B]])
            for g0 in range(0, len(work), B)]


class BatchCoverMixin:
    """convert_batch half of VoiceConverter (pipeline/engine.py)."""

    @torch.inference_mode()
    @spanned("polgen.convert_batch", request=True)
    def convert_batch(self, audios: list, opts: ConversionOptions = None,
                      progress: ProgressReporter = NULL_PROGRESS) -> list:
        """Float mono 16 kHz songs -> [(int16 audio, output sample rate)],
        one per song, in order."""
        opts = opts or ConversionOptions()
        n_songs = len(audios)
        if n_songs == 0:
            return []
        progress(0.05, f"planning {n_songs} songs and their F0")
        songs = [self._prepare_song(audio, opts) for audio in audios]
        batches = pack_work([song.plan for song in songs], self.engine)
        outputs = [{} for _ in songs]
        total = sum(len(group) for _, group in batches)
        done = 0
        for bucket, group in batches:
            segs = self._convert_rows(
                [(songs[si].plan.chunks[ci], ci, songs[si]) for si, ci in group],
                bucket, opts)
            for (si, ci), seg in zip(group, segs):
                outputs[si][ci] = seg
            done += len(group)
            progress(0.2 + 0.6 * done / total, f"converting {done}/{total} chunks")
        progress(0.85, "RMS envelope and output")
        results = [self._finish_song(song, [out[ci] for ci in sorted(out)], opts)
                   for song, out in zip(songs, outputs)]
        progress(1.0, "batch done")
        return results
