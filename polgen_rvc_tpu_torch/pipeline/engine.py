"""The conversion engine: the port of polgen_rvc_tpu/pipeline/engine.py's
``VoiceConverter.convert`` on the rmvpe+, mangio-crepe and fcpe F0 paths
and for no-f0 models, in eager PyTorch on one device.

Per song: host high-pass, reflect pad and int16 quantize (one upload);
quiet-point chunk planning; one full-signal F0 pass (f0 models only):
RMVPE (fp32), CREPE (conv operands in the compute dtype, decode in fp32)
or FCPE (fp32). Per batch of ``chunk_batch`` chunks, padded to that
batch's own bucket: HuBERT -> top-k retrieval blend -> 2x frame repeat ->
protect mix (f0 models) -> synthesizer, then the pad trim. Last, the
RMS-envelope gain, per-chunk int16 pack and the final normalize.

Semantics follow the JAX engine: the same buckets (``_batch_geometry``),
row assembly (``_assemble_rows``), masks and trim, and noise drawn at the
fixed ``_noise_frames()`` length per chunk id, so a chunk renders the same
in any batch slot and bucket. Noise comes from a provider: by default a
``torch.Generator`` seeded from (seed, chunk id); the tests inject the JAX
package's own draws instead.
"""

from __future__ import annotations

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
from ..ops.filters import highpass_pad_quant
from ..retrieval.topk import retrieval_blend
from .chunking import plan_chunks
from .config import ConversionOptions, EngineConfig
from .crepe_method import crepe_f0
from .fcpe_method import fcpe_f0, fcpe_f0_device
from .output import change_rms, finalize_int16, pack_int16, rows_to_audio

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


class VoiceConverter:
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
                 fcpe_params: Optional[dict] = None, fcpe_cfg=None):
        self.device = resolve_device(device)
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
        step = eng.bucket_step_s * eng.sample_rate
        batch_idxs = [list(range(g0, min(g0 + eng.chunk_batch, n)))
                      for g0 in range(0, n, eng.chunk_batch)]
        batch_bucket = [
            max(int(np.ceil((plan.chunks[ci].slice_end
                             - plan.chunks[ci].slice_start) / step)) * step
                for ci in idxs)
            for idxs in batch_idxs
        ]
        return batch_idxs, batch_bucket

    def _assemble_rows(self, plan, idxs, p_len: int):
        """Host arrays for one batch; rows past len(idxs) are padding."""
        eng = self.engine
        B = eng.chunk_batch
        rows = {name: np.zeros(B, np.int64) for name in
                ("starts", "samp_starts", "samp_lens", "hub_valid", "ids")}
        mask = np.zeros((B, p_len), np.float32)
        valid_frames = []
        for row, ci in enumerate(idxs):
            c = plan.chunks[ci]
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
            return self._fcpe_f0(buf, opts, padded_len)
        if opts.f0_method not in ("rmvpe+", "rmvpe"):
            raise ValueError(f"unknown f0 method: {opts.f0_method}")
        if self.rmvpe_params is None:
            raise RuntimeError("rmvpe weights not loaded")
        mel, n = pad_frames_to_32(rmvpe_mel(buf[None].float()))
        sal = rmvpe_salience(self.rmvpe_params, mel)[:, :n]
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

    # ------------------------------------------------------------------
    # one chunk batch
    # ------------------------------------------------------------------

    def _chunk_batch(self, buf, pitch_full, pitchf_full, rows, bucket: int,
                     p_len: int, opts: ConversionOptions, use_index: bool,
                     use_protect: bool):
        """Rows of trimmed, valid-masked float32 audio (B, out_len)."""
        eng, dev, cdt = self.engine, self.device, self.compute_dtype
        B = eng.chunk_batch
        hub_frames = self.hubert_cfg.num_frames(bucket)

        def put(a):
            return torch.as_tensor(a, device=dev)

        samp_starts, samp_lens = put(rows["samp_starts"]), put(rows["samp_lens"])
        span = torch.arange(bucket, device=dev)
        buf_ext = torch.cat([buf, buf.new_zeros(bucket)])
        wav = buf_ext[samp_starts[:, None] + span[None, :]]
        wav = torch.where(span[None, :] < samp_lens[:, None], wav,
                          torch.zeros_like(wav))
        frame_mask = put(rows["mask"])
        pitch = pitchf = None
        if pitch_full is not None:
            cols = put(rows["starts"])[:, None] + torch.arange(p_len, device=dev)[None, :]
            pitch = torch.cat([pitch_full, pitch_full.new_ones(p_len)])[cols]
            pitchf = torch.cat([pitchf_full, pitchf_full.new_zeros(p_len)])[cols]
            valid = frame_mask > 0
            pitch = torch.where(valid, pitch, torch.ones_like(pitch))
            pitchf = torch.where(valid, pitchf, torch.zeros_like(pitchf))

        v1 = self.version == "v1"
        n_layers = self.hubert_cfg.n_layers
        hub_pad = (torch.arange(hub_frames, device=dev)[None, :]
                   >= put(rows["hub_valid"])[:, None])
        feats = hubert_extract(
            self.hubert_params, self.hubert_cfg, wav,
            output_layer=9 if (v1 and n_layers >= 9) else n_layers,
            final_proj=v1, compute_dtype=cdt, padding_mask=hub_pad,
            valid_samples=samp_lens,
        )
        feats0 = feats
        if use_index:
            feats = retrieval_blend(feats, self.index_bank, float(opts.index_rate),
                                    k=eng.retrieval_k)
        feats = feats.repeat_interleave(2, dim=1)[:, :p_len]
        if use_protect:
            feats0 = feats0.repeat_interleave(2, dim=1)[:, :p_len]
            pff = torch.where(pitchf > 0, 1.0, float(opts.protect)).to(feats.dtype)[..., None]
            feats = feats * pff + feats0 * (1.0 - pff)

        # a no-f0 model draws the source noise too and leaves it unused, as
        # the JAX engine splits and drops its source key
        nf = self._noise_frames()
        upp = self.synth_cfg.upp
        draws = [self.noise_provider(opts.seed, int(ci),
                                     (self.synth_cfg.inter_channels, nf),
                                     nf * upp, dev)
                 for ci in rows["ids"][:B]]
        eps = torch.stack([e for e, _ in draws]).to(dev)
        nsf = torch.stack([n for _, n in draws]).to(dev)
        sid = torch.full((B,), opts.speaker_id, dtype=torch.long, device=dev)
        audio = synthesizer_infer(
            self.synth_params, self.synth_cfg, feats,
            frame_mask[:, None, :], pitch, pitchf, sid, eps=eps, nsf_noise=nsf,
            noise_scale=eng.noise_scale, compute_dtype=cdt,
        ).float()

        t_pad_tgt = self.tgt_sr * eng.x_pad
        out_len = p_len * upp - 2 * t_pad_tgt
        nvalid = torch.clamp(frame_mask.sum(1).long() * upp - 2 * t_pad_tgt, min=0)
        trimmed = audio[:, t_pad_tgt:t_pad_tgt + out_len]
        idx = torch.arange(out_len, device=dev)[None, :]
        return torch.where(idx < nvalid[:, None], trimmed, torch.zeros_like(trimmed))

    # ------------------------------------------------------------------
    # full pipeline
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def convert(self, audio16k: np.ndarray,
                opts: ConversionOptions = ConversionOptions()):
        """Float mono 16 kHz -> (int16 audio, output sample rate)."""
        if opts.f0_file or opts.resample_sr:
            raise NotImplementedError("f0 files and output resampling are not ported yet")
        eng, dev = self.engine, self.device
        audio, qbuf, inv_scale, padded_len = highpass_pad_quant(
            np.asarray(audio16k, np.float64), eng.t_pad, eng.window
        )
        plan = plan_chunks(audio, eng)
        buf = torch.from_numpy(qbuf).to(dev).float() * float(inv_scale)
        use_f0 = self.synth_cfg.use_f0
        pitch_full = pitchf_full = None
        if use_f0:
            pitch_full, pitchf_full = self.compute_f0(buf, opts, padded_len)

        use_index = self.index_bank is not None and opts.index_rate > 0
        use_protect = use_f0 and opts.protect < 0.5
        upp = self.synth_cfg.upp
        t_pad_tgt = self.tgt_sr * eng.x_pad
        segments = []
        batch_idxs, batch_bucket = self._batch_geometry(plan)
        for idxs, bucket in zip(batch_idxs, batch_bucket):
            p_len = min(bucket // eng.window, 2 * self.hubert_cfg.num_frames(bucket))
            rows = self._assemble_rows(plan, idxs, p_len)
            out = self._chunk_batch(buf, pitch_full, pitchf_full, rows, bucket,
                                    p_len, opts, use_index, use_protect)
            for row, v in enumerate(rows["valid_frames"]):
                n = max(v * upp - 2 * t_pad_tgt, 0)
                if n:
                    segments.append(out[row, :n])

        lens = [s.shape[0] for s in segments]
        out = torch.cat(segments) if segments else buf.new_zeros(0)
        if opts.volume_envelope != 1.0 and out.numel():
            src = buf[eng.t_pad:eng.t_pad + audio.shape[0]]
            out = change_rms(src, eng.sample_rate, out, self.tgt_sr,
                             float(opts.volume_envelope))
        packed = [pack_int16(seg) for seg in torch.split(out, lens)]
        host = [(seg.cpu().numpy(), float(am)) for seg, am in packed]
        return finalize_int16(rows_to_audio(host)), self.tgt_sr
