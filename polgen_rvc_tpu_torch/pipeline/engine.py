"""The conversion engine: the port of polgen_rvc_tpu/pipeline/engine.py's
``VoiceConverter.convert`` on the rmvpe+, mangio-crepe and fcpe F0 paths
and for no-f0 models, in eager PyTorch on one device or a mesh; ``convert_batch``
(pipeline/batch_cover.py) packs chunks of several songs into its batches,
and ``prewarm`` (pipeline/prewarm.py) does a convert's first-call setup.

Per song (``_prepare_song``): the float64 high-pass, reflect pad, int16
quantize and dequantize (on the card by ops/highpass.py's kernel, from
the raw signal's upload); one full-signal F0 pass (f0 models only) over
that buffer: RMVPE (fp32), CREPE (conv operands in the compute dtype,
decode in fp32) or FCPE (fp32); quiet-point chunk planning, for a song
long enough to be cut on the host's own high-passed signal, made on a
worker thread during the F0 pass. Per batch of ``chunk_batch`` chunks, padded to that batch's own
bucket (``_convert_rows``): HuBERT -> top-k retrieval blend -> 2x frame repeat ->
protect mix (f0 models) -> synthesizer, then the pad trim; each row reads
its samples and pitch from its own song. Last, per song
(``_finish_song``): the RMS-envelope gain over the whole song, per-chunk
int16 pack, the optional output resample and the final normalize.

Each phase is a span of utils/tracing.py: ``polgen.convert`` (the
request), ``polgen.prepare`` (``polgen.upload``, ``polgen.highpass``,
``polgen.f0``, ``polgen.f0_file``, ``polgen.plan``), ``polgen.chunk_batch``
(``polgen.rows``, ``polgen.noise``, ``polgen.hubert``, ``polgen.retrieval``,
``polgen.protect``, the synthesizer's ``polgen.enc_p``, ``polgen.flow`` and
``polgen.decoder``, ``polgen.trim``) and ``polgen.finish``
(``polgen.envelope``, ``polgen.readback``, ``polgen.host_finalize``). A
request's chunk batches count their computed and valid synthesizer frames
(``frames_computed``, ``frames_valid``).

Semantics follow the JAX engine: the same buckets (``_batch_geometry``),
row assembly (``_assemble_rows``), masks and trim, and noise drawn at the
fixed ``_noise_frames()`` length per song-local chunk id, so a chunk
renders the same in any batch slot and bucket. The decoder's conv_pre runs
at that same fixed length (models/nsf.py), so on the card too a chunk's
bytes do not depend on its bucket. Noise comes from a
provider: by default a ``torch.Generator`` seeded from (seed, chunk id);
the tests inject the JAX package's own draws instead.

On a mesh (parallel/mesh.py, ``mesh=``) the per-song work stays on the
mesh's primary device, and so do a batch's rows and noise, drawn as
without a mesh; each data shard then takes its rows to its own device
and runs HuBERT, retrieval and the synthesizer there, and the trimmed
rows come back in row order.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..convert.params import params_to_torch
from ..models.crepe import pack_crepe_weights
from ..models.hubert import HubertConfig, hubert_extract
from ..models.nsf import pack_decoder_weights
from ..models.rmvpe import pack_rmvpe_weights, pad_frames_to_32, rmvpe_mel, rmvpe_salience
from ..models.synthesizer import SynthesizerConfig, synthesizer_infer
from ..ops.f0_utils import coarse_f0, salience_to_f0
from ..ops.filters import highpass_filtfilt
from ..ops.highpass import highpass_pad_quant, pad_quant_plain
from ..parallel.mesh import Mesh, replicate, shard_batch
from ..retrieval.topk import retrieval_blend
from ..utils.progress import NULL_PROGRESS, ProgressReporter
from ..utils.tracing import count, span, spanned
from .batch_cover import BatchCoverMixin, bucket_class
from .chunking import ChunkPlan, is_cut, plan_chunks
from .config import ConversionOptions, EngineConfig
from .crepe_method import crepe_f0
from .f0_file import apply_f0_file, coarse_f0_np
from .fcpe_method import fcpe_f0, fcpe_f0_device
from .output import change_rms, host_finalize, pack_int16, rows_to_audio
from .prewarm import PrewarmMixin

# (seed, chunk id, latent shape (C, frames), nsf length, device)
#   -> (eps (C, frames), nsf noise (length,)), standard normal float32
NoiseProvider = Callable[[int, int, tuple, int, torch.device], tuple]


def torch_noise(seed: int, chunk_id: int, lat_shape: tuple, nsf_len: int,
                device: torch.device):
    """Default noise: one generator per (seed, chunk id) on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 1_000_003 + int(chunk_id))
    eps = torch.randn(lat_shape, generator=g, device=device)
    nsf = torch.randn(nsf_len, generator=g, device=device)
    return eps, nsf


def _raw_signal(audio16k) -> np.ndarray:
    """The song as it came, contiguous: float32 stays, else float64."""
    a = np.asarray(audio16k)
    return np.ascontiguousarray(a if a.dtype == np.float32 else a.astype(np.float64))


def _host_signal(audio16k) -> np.ndarray:
    """The host's high-passed signal (scipy, float64), as float32."""
    return highpass_filtfilt(np.asarray(audio16k, np.float64)).astype(np.float32)


def _plan_on_host(audio16k, eng: EngineConfig):
    """The host's high-passed float32 signal and its chunk plan."""
    audio = _host_signal(audio16k)
    return audio, plan_chunks(audio, eng)


@dataclasses.dataclass
class DataShard:
    """What one data shard runs its chunk rows with: its device, and the
    synthesizer's parameters (kernel layouts included), the index bank and
    HuBERT's parameters there."""

    device: torch.device
    synth_params: dict
    index_bank: Optional[torch.Tensor]
    hubert_params: dict


@dataclasses.dataclass
class SongPrep:
    """One song on its way through the engine: the high-passed 16 kHz audio,
    its chunk plan, the dequantized padded signal on the device and, for an
    f0 model, its full-signal coarse pitch and pitchf on the device."""

    audio: np.ndarray
    plan: ChunkPlan
    buf: torch.Tensor
    pitch: Optional[torch.Tensor]
    pitchf: Optional[torch.Tensor]


class VoiceConverter(BatchCoverMixin, PrewarmMixin):
    """Voice conversion over one (synthesizer, HuBERT, RMVPE, index) model
    set, plus CREPE weights for the mangio-crepe method and FCPE weights
    and config for fcpe. A no-f0 model (``synth_cfg.use_f0`` false) runs no
    F0 pass and may come without RMVPE weights. Parameters arrive as numpy
    dictionaries (the convert/ builders' output) and live on ``device`` in
    float32, with the kernels' packed weight layouts and the CREPE convs'
    compute-dtype operands beside them."""

    def __init__(self, *, synth_cfg: SynthesizerConfig, synth_params: dict,
                 hubert_cfg: HubertConfig, hubert_params: dict,
                 rmvpe_params: Optional[dict] = None,
                 index_bank: Optional[np.ndarray] = None,
                 engine: EngineConfig = EngineConfig(), device=None,
                 noise_provider: NoiseProvider = torch_noise,
                 crepe_params: Optional[dict] = None,
                 fcpe_params: Optional[dict] = None, fcpe_cfg=None,
                 mesh: Optional[Mesh] = None):
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None and resolve_device(device) != mesh.primary:
                raise ValueError(f"device {device} is not the mesh's primary "
                                 f"device {mesh.primary}")
            if engine.chunk_batch % len(mesh.devices):
                raise ValueError(f"chunk_batch {engine.chunk_batch} does not split "
                                 f"over {len(mesh.devices)} data shards")
            self.device = mesh.primary
        self.mesh = mesh
        self.synth_cfg = synth_cfg
        self.hubert_cfg = hubert_cfg
        self.engine = engine
        self.tgt_sr = synth_cfg.sr
        self.version = "v2" if synth_cfg.input_dim == 768 else "v1"
        self.compute_dtype = getattr(torch, engine.compute_dtype)
        self.noise_provider = noise_provider
        sp = params_to_torch(synth_params, self.device)
        # the kernels' weight layouts are made here, once, not per launch
        self.synth_params = {**sp, "dec": pack_decoder_weights(sp["dec"], synth_cfg)}
        self.hubert_params = params_to_torch(hubert_params, self.device)
        self.rmvpe_params = (None if rmvpe_params is None else pack_rmvpe_weights(
            params_to_torch(rmvpe_params, self.device)))
        self.index_bank = (None if index_bank is None
                           else params_to_torch(np.asarray(index_bank), self.device))
        self.crepe_params = (None if crepe_params is None else pack_crepe_weights(
            params_to_torch(crepe_params, self.device), self.compute_dtype))
        self.fcpe_params = (None if fcpe_params is None
                            else params_to_torch(fcpe_params, self.device))
        self.fcpe_cfg = fcpe_cfg
        self._mesh_shards = None if mesh is None else self._place_on_mesh(mesh)

    def _place_on_mesh(self, mesh: Mesh) -> list:
        """One DataShard per data shard, on its device: the synthesizer's
        parameters, the index bank and HuBERT replicated there. A repeated
        device shares one copy."""
        reps = replicate({"synth": self.synth_params, "bank": self.index_bank,
                          "hubert": self.hubert_params}, mesh)
        return [DataShard(dev, reps[dev]["synth"], reps[dev]["bank"], reps[dev]["hubert"])
                for dev in mesh.devices]

    def _data_shards(self) -> list:
        """The DataShards a chunk batch's rows split over: without a mesh,
        one on self.device over the converter's own parameters."""
        if self._mesh_shards is not None:
            return self._mesh_shards
        return [DataShard(self.device, self.synth_params, self.index_bank,
                          self.hubert_params)]

    # ------------------------------------------------------------------
    # geometry (identical to the JAX engine's)
    # ------------------------------------------------------------------

    def _noise_frames(self) -> int:
        """Noise-draw frame count: the p_len of the config's largest bucket."""
        mb = self.engine.max_bucket_len
        return min(mb // self.engine.window, 2 * self.hubert_cfg.num_frames(mb))

    def _batch_geometry(self, plan):
        """Consecutive chunk_batch-sized batches, each padded to the smallest
        bucket_step_s multiple that holds its own longest chunk."""
        eng = self.engine
        n = len(plan.chunks)
        batch_idxs = [list(range(g0, min(g0 + eng.chunk_batch, n)))
                      for g0 in range(0, n, eng.chunk_batch)]
        batch_bucket = [max(bucket_class(plan.chunks[ci], eng) for ci in idxs)
                        for idxs in batch_idxs]
        return batch_idxs, batch_bucket

    def _assemble_rows(self, entries, p_len: int):
        """Host arrays for one batch from (chunk, song-local chunk id,
        samples, pitch, pitchf) entries of any songs: samples is the row's
        song's dequantized padded signal on the device, pitch and pitchf
        its full-signal F0 (None for a no-f0 model). ``sources`` holds the
        batch's distinct songs' (samples, pitch, pitchf) and ``song`` each
        row's index into it. Rows past len(entries) are padding."""
        eng = self.engine
        B = eng.chunk_batch
        rows = {name: np.zeros(B, np.int64) for name in
                ("starts", "samp_starts", "samp_lens", "hub_valid", "ids", "song")}
        mask = np.zeros((B, p_len), np.float32)
        valid_frames = []
        sources, source_of = [], {}
        for row, (c, ci, samples, pitch, pitchf) in enumerate(entries):
            if id(samples) not in source_of:
                source_of[id(samples)] = len(sources)
                sources.append((samples, pitch, pitchf))
            rows["song"][row] = source_of[id(samples)]
            slice_len = c.slice_end - c.slice_start
            rows["samp_starts"][row] = c.slice_start
            rows["samp_lens"][row] = slice_len
            rows["hub_valid"][row] = max(self.hubert_cfg.num_frames(slice_len), 0)
            v = min(slice_len // eng.window,
                    2 * self.hubert_cfg.num_frames(slice_len), p_len)
            valid_frames.append(v)
            mask[row, :v] = 1.0
            rows["starts"][row] = c.slice_start // eng.window
            rows["ids"][row] = ci
        rows["mask"] = mask
        rows["valid_frames"] = valid_frames
        rows["sources"] = sources
        return rows

    # ------------------------------------------------------------------
    # F0: one full-signal pass
    # ------------------------------------------------------------------

    def compute_f0(self, buf, opts: ConversionOptions,
                   padded_len: Optional[int] = None):
        """(bucket,) float32 signal, its first padded_len samples valid ->
        (coarse pitch (P,), pitchf (P,)) with P = bucket // 160 + 1 frames.
        mangio-crepe and fcpe need padded_len; rmvpe+ reads the whole
        bucket."""
        if opts.f0_method == "mangio-crepe":
            if self.crepe_params is None:
                raise RuntimeError(
                    "crepe weights not loaded (assets/predictors/crepe_full.pth)")
            if padded_len is None:
                raise ValueError("mangio-crepe needs the padded signal length")
            return crepe_f0(self.crepe_params, buf, padded_len, opts,
                            window=self.engine.window,
                            compute_dtype=self.compute_dtype)
        if opts.f0_method == "fcpe":
            if self.fcpe_params is None or self.fcpe_cfg is None:
                raise RuntimeError("fcpe weights not loaded (assets/predictors/fcpe.pt)")
            if padded_len is None:
                raise ValueError("fcpe needs the padded signal length")
            with span("polgen.fcpe"):
                return self._fcpe_f0(buf, opts, padded_len)
        if opts.f0_method not in ("rmvpe+", "rmvpe"):
            raise ValueError(f"unknown f0 method: {opts.f0_method}")
        if self.rmvpe_params is None:
            raise RuntimeError("rmvpe weights not loaded")
        mel, n = pad_frames_to_32(rmvpe_mel(buf[None].float()))
        sal = rmvpe_salience(self.rmvpe_params, mel)[:, :n]
        with span("polgen.rmvpe.decode"):
            f0_raw = salience_to_f0(sal, 0.03)
            f0 = torch.where((f0_raw < opts.f0_min) | (f0_raw > opts.f0_max),
                             torch.zeros_like(f0_raw), f0_raw)
            pitchf = f0 * float(np.float32(2.0 ** (opts.pitch / 12.0)))
            pitch = coarse_f0(pitchf, opts.f0_min, opts.f0_max)
        return pitch[0], pitchf[0]

    def _fcpe_f0(self, buf, opts: ConversionOptions, padded_len: int):
        """fcpe: at an FCPE hop equal to the engine's window, the JAX
        package's device path (the mel over the whole zero-tailed bucket,
        padded_len // hop + 1 frames as n_valid, the decode, the resize and
        gap-fill onto padded_len // window frames); at another hop, the host
        path on buf[:padded_len]. Then the pitch shift and coarse bins."""
        cfg, window = self.fcpe_cfg, self.engine.window
        p_len = padded_len // window
        size = buf.shape[0] // 160 + 1
        if cfg.hop_size == window:
            f0 = fcpe_f0_device(self.fcpe_params, cfg, buf, padded_len, p_len)
            pitchf = f0 * float(np.float32(2.0 ** (opts.pitch / 12.0)))
        else:
            f0 = fcpe_f0(self.fcpe_params, cfg, buf[:padded_len], p_len)
            f0 = np.pad(f0, (0, max(size - p_len, 0)))[:size]
            pitchf = torch.from_numpy(
                (f0 * (2.0 ** (opts.pitch / 12.0))).astype(np.float32)).to(buf.device)
        return coarse_f0(pitchf, opts.f0_min, opts.f0_max), pitchf

    def _apply_f0_file(self, pitchf, opts: ConversionOptions, p_len: int):
        """An F0 file over the shifted F0 of the padded signal's p_len
        frames (pipeline/f0_file.py): pitchf comes to the host, the file
        overrides its frames, the coarse bins of every frame are computed
        in numpy as the JAX package computes them, and both go back to the
        device. Frames from p_len on, which no chunk reads, keep the F0
        pass's values."""
        f0 = pitchf.cpu().numpy().copy()
        apply_f0_file(f0[:p_len], opts.f0_file, self.engine)
        pitch = coarse_f0_np(f0.copy(), opts.f0_min, opts.f0_max)
        return (torch.from_numpy(pitch.astype(np.int64)).to(self.device),
                torch.from_numpy(f0).to(self.device))

    # ------------------------------------------------------------------
    # one chunk batch
    # ------------------------------------------------------------------

    def _batch_inputs(self, rows, bucket: int, p_len: int):
        """A batch's rows on self.device: {"wav" (B, bucket), "samp_lens",
        "hub_valid" (B,), "pitch", "pitchf" (B, p_len) or None without F0,
        "mask" (B, p_len)}, and "ids", the rows' chunk ids (host ints) that
        key their noise."""
        dev = self.device

        def put(a):
            return torch.as_tensor(a, device=dev)

        # one gather of each row's samples and F0 from its own song: the
        # batch's songs laid end to end, each followed by a bucket of zero
        # samples and p_len frames of unvoiced pitch
        srcs, song = rows["sources"], rows["song"]
        span = torch.arange(bucket, device=dev)
        base = np.cumsum([0] + [x.shape[0] + bucket for x, _, _ in srcs])
        buf_ext = torch.cat([t for x, _, _ in srcs for t in (x, x.new_zeros(bucket))])
        wav = buf_ext[put(base[song] + rows["samp_starts"])[:, None] + span[None, :]]
        samp_lens = put(rows["samp_lens"])
        wav = torch.where(span[None, :] < samp_lens[:, None], wav, torch.zeros_like(wav))
        frame_mask = put(rows["mask"])
        pitch = pitchf = None
        if self.synth_cfg.use_f0:
            fbase = np.cumsum([0] + [p.shape[0] + p_len for _, p, _ in srcs])
            cols = (put(fbase[song] + rows["starts"])[:, None]
                    + torch.arange(p_len, device=dev)[None, :])
            pitch = torch.cat([t for _, p, _ in srcs for t in (p, p.new_ones(p_len))])[cols]
            pitchf = torch.cat([t for _, _, f in srcs for t in (f, f.new_zeros(p_len))])[cols]
            valid = frame_mask > 0
            pitch = torch.where(valid, pitch, torch.ones_like(pitch))
            pitchf = torch.where(valid, pitchf, torch.zeros_like(pitchf))
        return {"wav": wav, "samp_lens": samp_lens, "hub_valid": put(rows["hub_valid"]),
                "pitch": pitch, "pitchf": pitchf, "mask": frame_mask,
                "ids": np.asarray(rows["ids"][:self.engine.chunk_batch])}

    def _split_rows(self, inputs: dict) -> list:
        """The batch's inputs -> each data shard's B / n_data rows of them, on
        that shard's device (shard_batch; the chunk ids stay on the host);
        without a mesh, the inputs."""
        if self.mesh is None:
            return [inputs]
        parts = [{} for _ in self.mesh.devices]
        for name, value in inputs.items():
            if value is None:
                blocks = [None] * len(parts)
            elif name == "ids":
                blocks = np.split(value, len(parts))
            else:
                blocks = shard_batch(value, self.mesh)
            for part, block in zip(parts, blocks):
                part[name] = block
        return parts

    def _shard_rows(self, shard: "DataShard", inp: dict, bucket: int, p_len: int,
                    opts: ConversionOptions, use_index: bool, use_protect: bool):
        """One data shard's rows, on its device: HuBERT -> retrieval -> 2x
        frame repeat -> protect mix -> synthesizer -> pad trim. (rows,
        out_len) float32.
        The calls whose algorithm the card picks by row count run at
        chunk_batch rows (ops/conv.py:at_rows), so a shard's rows get the
        unsharded batch's bytes."""
        eng, dev, cdt = self.engine, shard.device, self.compute_dtype
        v1 = self.version == "v1"
        n_layers = self.hubert_cfg.n_layers
        with span("polgen.hubert"):
            hub_pad = (torch.arange(self.hubert_cfg.num_frames(bucket), device=dev)[None, :]
                       >= inp["hub_valid"][:, None])
            feats = hubert_extract(
                shard.hubert_params, self.hubert_cfg, inp["wav"],
                output_layer=9 if (v1 and n_layers >= 9) else n_layers,
                final_proj=v1, compute_dtype=cdt, padding_mask=hub_pad,
                valid_samples=inp["samp_lens"], rows=eng.chunk_batch,
            )
        feats0 = feats
        if use_index:
            with span("polgen.retrieval"):
                feats = retrieval_blend(feats, shard.index_bank, float(opts.index_rate),
                                        k=eng.retrieval_k)
        feats = feats.repeat_interleave(2, dim=1)[:, :p_len]
        pitch, pitchf, frame_mask = inp["pitch"], inp["pitchf"], inp["mask"]
        if use_protect:
            with span("polgen.protect"):
                feats0 = feats0.repeat_interleave(2, dim=1)[:, :p_len]
                pff = torch.where(pitchf > 0, 1.0,
                                  float(opts.protect)).to(feats.dtype)[..., None]
                feats = feats * pff + feats0 * (1.0 - pff)

        # each row's noise drawn on self.device by (seed, chunk id), as
        # without a mesh, then moved with the row; a no-f0 model draws the
        # source noise too and leaves it unused, as the JAX engine splits and
        # drops its source key
        nf = self._noise_frames()
        upp = self.synth_cfg.upp
        with span("polgen.noise"):
            draws = [self.noise_provider(opts.seed, int(ci),
                                         (self.synth_cfg.inter_channels, nf), nf * upp,
                                         self.device)
                     for ci in inp["ids"]]
            eps = torch.stack([e for e, _ in draws]).to(dev)
            nsf = torch.stack([n for _, n in draws]).to(dev)
        sid = torch.full((frame_mask.shape[0],), opts.speaker_id, dtype=torch.long,
                         device=dev)
        audio = synthesizer_infer(
            shard.synth_params, self.synth_cfg, feats,
            frame_mask[:, None, :], pitch, pitchf, sid, eps=eps, nsf_noise=nsf,
            noise_scale=eng.noise_scale, compute_dtype=cdt, dec_frames=nf,
            rows=eng.chunk_batch,
        ).float()

        with span("polgen.trim"):
            t_pad_tgt = self.tgt_sr * eng.x_pad
            out_len = p_len * upp - 2 * t_pad_tgt
            nvalid = torch.clamp(frame_mask.sum(1).long() * upp - 2 * t_pad_tgt, min=0)
            trimmed = audio[:, t_pad_tgt:t_pad_tgt + out_len]
            idx = torch.arange(out_len, device=dev)[None, :]
            return torch.where(idx < nvalid[:, None], trimmed, torch.zeros_like(trimmed))

    def _chunk_batch(self, rows, bucket: int, p_len: int,
                     opts: ConversionOptions, use_index: bool, use_protect: bool):
        """Rows of trimmed, valid-masked float32 audio (B, out_len) on
        self.device. The rows and their noise are assembled there; each data
        shard runs its rows on its own devices, every shard's work issued
        before any shard's result is read back, and the rows come back in
        row order (one shard's rows as they are: no copy)."""
        with span("polgen.rows"):
            parts = self._split_rows(self._batch_inputs(rows, bucket, p_len))
        outs = [self._shard_rows(shard, part, bucket, p_len, opts, use_index, use_protect)
                for shard, part in zip(self._data_shards(), parts)]
        if len(outs) == 1:
            return outs[0]
        with span("polgen.trim"):
            return torch.cat([out.to(self.device) for out in outs])

    # ------------------------------------------------------------------
    # per song, per batch, and the full pipeline
    # ------------------------------------------------------------------

    @spanned("polgen.prepare")
    def _prepare_song(self, audio16k: np.ndarray, opts: ConversionOptions) -> SongPrep:
        """High-pass, pad, quantize and dequantize the song into the F0
        pass's buffer, issue the F0 pass, then the F0 file's override where
        opts name one, and plan the chunks.

        On the card the buffer comes from the card's own high-pass
        (ops/highpass.py), uploaded raw from pinned memory, and the F0 pass
        is issued with no wait on the device. A song long enough to be cut
        is planned on the host's high-passed signal (ops/filters.py: scipy),
        made meanwhile by a worker thread that is joined last: the cut
        points are near-ties that the two filters' rounding (~1e-7 of the
        peak apart) decide differently. A shorter signal's plan does not
        read its values; it takes the card's signal, copied back while the
        F0 pass runs. On the CPU everything is the host's, as the CPU tests
        hold the buffer against the JAX package."""
        eng = self.engine
        if self.device.type != "cuda":
            with span("polgen.highpass"):
                audio = _host_signal(audio16k)
                q, inv, _ = pad_quant_plain(torch.from_numpy(audio), eng.t_pad, eng.window)
            with span("polgen.upload"):
                buf = q.to(self.device).float() * inv
            pitch, pitchf = self._f0_pass(buf, len(audio16k), opts)
            with span("polgen.plan"):
                plan = plan_chunks(audio, eng)
            return SongPrep(audio, plan, buf, pitch, pitchf)
        with contextlib.ExitStack() as stack:
            planned = None
            if is_cut(len(audio16k), eng):
                worker = stack.enter_context(concurrent.futures.ThreadPoolExecutor(1))
                planned = worker.submit(_plan_on_host, audio16k, eng)
            with span("polgen.upload"):
                x = torch.from_numpy(_raw_signal(audio16k)).pin_memory()
                x = x.to(self.device, non_blocking=True)
            with span("polgen.highpass"):
                card_audio, _, _, buf = highpass_pad_quant(x, eng.t_pad, eng.window)
                if planned is None:
                    card_audio = card_audio.to("cpu", non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(torch.cuda.current_stream(self.device))
            pitch, pitchf = self._f0_pass(buf, len(audio16k), opts)
            with span("polgen.plan"):
                if planned is None:
                    copied.synchronize()
                    audio = card_audio.numpy()
                    plan = plan_chunks(audio, eng)
                else:
                    audio, plan = planned.result()
        return SongPrep(audio, plan, buf, pitch, pitchf)

    def _f0_pass(self, buf, n: int, opts: ConversionOptions):
        """The F0 pass over the song's buffer (n samples before the pad),
        then the F0 file's override: (coarse pitch, pitchf), or (None,
        None) for a no-f0 model."""
        if not self.synth_cfg.use_f0:
            return None, None
        padded_len = n + 2 * self.engine.t_pad
        with span("polgen.f0"):
            pitch, pitchf = self.compute_f0(buf, opts, padded_len)
        if opts.f0_file:
            with span("polgen.f0_file"):
                pitch, pitchf = self._apply_f0_file(pitchf, opts,
                                                    padded_len // self.engine.window)
        return pitch, pitchf

    @spanned("polgen.chunk_batch")
    def _convert_rows(self, entries, bucket: int, opts: ConversionOptions,
                      counted: bool = True):
        """One chunk batch padded to `bucket`: (chunk, song-local chunk id,
        SongPrep) entries -> each entry's trimmed output samples on the
        device (possibly empty). A counted batch (a request's; prewarm's
        are not) adds its frames to ``frames_computed`` and ``frames_valid``."""
        eng = self.engine
        p_len = min(bucket // eng.window, 2 * self.hubert_cfg.num_frames(bucket))
        with span("polgen.rows"):
            rows = self._assemble_rows(
                [(c, ci, song.buf, song.pitch, song.pitchf) for c, ci, song in entries],
                p_len)
        if counted:
            count("frames_computed", eng.chunk_batch * p_len)
            count("frames_valid", sum(rows["valid_frames"]))
        use_f0 = self.synth_cfg.use_f0
        use_index = self.index_bank is not None and opts.index_rate > 0
        use_protect = use_f0 and opts.protect < 0.5
        out = self._chunk_batch(rows, bucket, p_len, opts, use_index, use_protect)
        t_pad_tgt = self.tgt_sr * eng.x_pad
        upp = self.synth_cfg.upp
        return [out[row, :max(v * upp - 2 * t_pad_tgt, 0)]
                for row, v in enumerate(rows["valid_frames"])]

    @spanned("polgen.finish")
    def _finish_song(self, song: SongPrep, segments, opts: ConversionOptions):
        """A song's chunk outputs in chunk order -> (int16 audio, rate): the
        RMS-envelope gain over the whole song, the per-chunk int16 pack, and
        on the host the optional resample and the final normalize."""
        eng = self.engine
        with span("polgen.envelope"):
            segments = [seg for seg in segments if seg.shape[0]]
            lens = [seg.shape[0] for seg in segments]
            out = torch.cat(segments) if segments else song.buf.new_zeros(0)
            if opts.volume_envelope != 1.0 and out.numel():
                src = song.buf[eng.t_pad:eng.t_pad + song.audio.shape[0]]
                out = change_rms(src, eng.sample_rate, out, self.tgt_sr,
                                 float(opts.volume_envelope))
            packed = [pack_int16(seg) for seg in torch.split(out, lens)]
        with span("polgen.readback"):
            host = [(seg.cpu().numpy(), float(am)) for seg, am in packed]
        with span("polgen.host_finalize"):
            return host_finalize(rows_to_audio(host), self.tgt_sr, opts.resample_sr,
                                 eng.sample_rate)

    @torch.inference_mode()
    @spanned("polgen.convert", request=True)
    def convert(self, audio16k: np.ndarray,
                opts: ConversionOptions = ConversionOptions(),
                progress: ProgressReporter = NULL_PROGRESS):
        """Float mono 16 kHz -> (int16 audio, output sample rate)."""
        progress(0.05, "high-pass filtering and F0")
        song = self._prepare_song(audio16k, opts)
        segments = []
        batch_idxs, batch_bucket = self._batch_geometry(song.plan)
        for k, (idxs, bucket) in enumerate(zip(batch_idxs, batch_bucket)):
            progress(0.2 + 0.6 * k / len(batch_idxs),
                     f"converting chunk batch {k + 1}/{len(batch_idxs)}")
            segments += self._convert_rows(
                [(song.plan.chunks[ci], ci, song) for ci in idxs], bucket, opts)
        progress(0.85, "RMS envelope and output")
        result = self._finish_song(song, segments, opts)
        progress(1.0, "done")
        return result
