#!/usr/bin/env python3
"""Drive the PyTorch port once on one CUDA card and check it.

    python3 chip_smoke.py

It drives five paths: rmvpe+ (the main path), mangio-crepe, fcpe, a no-f0
model and a v1 32 kHz model, and holds each of the five kernels against
its plain twin. Phases, each printing one JSON line (any failure raises;
exit code != 0):
  1. card:     nvidia-smi name and power limit, torch/CUDA versions, the
               parallel nvcc build of every kernel from csrc/ and its time,
               and the g++ build of the native FLAC codec and effects
               chain (native/) into build/native/ and its time.
  2. main:     the main path, as bench.py times it on an accelerator:
               build_synthetic_converter(tiny=False, sr=48000,
               index_vectors=65536, bf16 engine at bench's tiers) and
               convert() of bench's synthetic 60 s song with
               index_rate=0.5, protect=0.33, volume_envelope=0.25. One
               warm-up convert, then every kernel's launch count is set to
               0, one timed convert runs, and the counts are read: every
               kernel of the path must have launched (all but viterbi), the
               resblock-group kernel exactly 36 times (4 stages x 9 conv
               pairs, one chunk batch), the U-Net chain kernel exactly 112
               times (14 levels x 4 blocks x 2 convs).
               The output must have the planned length, not be silent,
               and repeat the warm-up convert's bytes.
  profile:     one more convert under torch.profiler: the device's busy
               and idle share of the wall time, and kernels by device time.
  batch:       convert_batch on the main path's converter over four songs
               cut from the song (60, 41, 23 and 9 s), the chunks sorted by
               bucket class and packed two rows a batch, each batch at its
               largest chunk's bucket: launches per packed batch (resblock group
               36, conv-transpose 4, band attention 6) and per song (U-Net
               chain 112); every song equal to its serial convert byte for
               byte, also where a chunk rides another bucket packed (the
               decoder's conv_pre runs at one fixed length); wall, RTF and
               kernel time of the packed call and of the four serial
               converts, peak memory; conv_pre's time at each packed
               bucket's frames, at the fixed length and at its own.
  f0_file:     the main path's converter with an F0 file of 10 ms lines
               covering 20 s: the coarse pitch over the overridden frames
               equals the host coarse_f0_np of the file's interpolation
               exactly; one warm-up, the counts set to 0, a timed convert
               of the 60 s song (the main path's launches), which repeats
               the warm-up's bytes; its profile; then convert_batch over
               the batch phase's songs with the file, each song equal to
               its serial convert byte for byte.
  checkpoint:  the main path's model set written as files (torch.save'd
               RVC .pth, fairseq-layout HuBERT, RMVPE state dict, a
               65,536-vector IVF-Flat index) into a temporary directory,
               loaded by build_converter on the card: its convert of the
               60 s song equals the main path's output byte for byte; each
               file's size and load time.
  cli:         in that directory as the working directory, rvc_cli.main on
               a 20 s stereo 44.1 kHz WAV (-ir 0.5 -f wav, the CLI's
               default float32 engine): output/Voice_Converted.wav at
               48 kHz, of the planned length within one frame, not silent,
               every main-path kernel launched; then -f mp3 (libmp3lame or
               the WAV fallback).
  cover:       the cover maker's path through the app modules, in that
               directory: upload_zip_file of a zip holding the checkpoint
               phase's .pth and .index; voice_pipeline on the cli phase's
               WAV with output_format="flac" (counts set to 0 before, the
               main-path kernels launched); process_audio of that vocal
               and a synthetic 20 s 44.1 kHz stereo instrumental with the
               effects on (reverb, compressor and chorus away from
               neutral), output_format="flac". Both files must be FLAC
               (magic fLaC) that the port's codec decodes at 48 kHz (the
               vocal mono, the mix stereo and as long as the vocal), the
               vocal to the int16 samples written, bit for bit. Each
               step's host seconds.
  serve:       the port's UI server (app/ui/server.py's Handler in a
               ThreadingHTTPServer on 127.0.0.1, from a thread), in that
               directory: POST /api/upload (multipart, the cli phase's
               WAV), /api/convert of the zip-installed model (index_rate
               0.5, output_format "wav"), /api/job/<id> polled every 20 ms
               to done, GET /audio/Voice_Converted.wav (counts set to 0
               before, the main-path kernels launched): the bytes a direct
               voice_pipeline call on the same cached converter writes. A
               second request, then two posted back to back: both done, one
               after the other, equal bytes. /api/process with the cover
               phase's vocal, instrumental and effects, to FLAC: the cover
               phase's mix bytes. Request-to-done walls (the first with the
               model load) against the direct call's.
  prewarm:     two fresh child processes (python3 chip_smoke.py
               --prewarm-child cold|warm DIR: cold CUDA context, handles,
               ctypes libraries and allocator), each loading the checkpoint
               phase's files with build_converter (bf16, bench's tiers).
               cold: its first and second convert of the 60 s song, timed;
               warm: prewarm timed, then its first and second convert.
               After prewarm, no kernel is built or loaded (cuda_build's
               counts); all four outputs equal the main path's byte for
               byte. The cold and prewarmed first converts' walls beside
               the steady (second) ones.
  crepe:       the same, with full-width CREPE weights
               (with_crepe=True) and f0_method="mangio-crepe" at hop 128:
               viterbi launches exactly once a convert, the resblock group
               36 times, the synthesizer's other kernels launch,
               unet_chain (RMVPE's) does not; then its
               profile (crepe_profile), with each CREPE layer's conv and
               epilogue timed alone on one 2,048-frame slab.
  3. kernels:  right after the crepe path, every kernel's wrapper again
               on the very inputs its path gives it (recorded during one
               more, untimed convert of the main and crepe paths), held
               against its plain PyTorch twin on the same inputs in the
               kernel's working precision, with the tolerance
               printed (the Viterbi path exactly), and one launch of each
               conv kernel against its plain twin at fp32 summation order
               (the resblock group: one conv pair; the U-Net chain: one
               conv into bf16 h, into the fp32 block output and into x's
               dtype; conv-transpose and the resblock group: the fp32
               route beside the bf16 one);
               timed beside the plain twin, a single PyTorch call where one
               computes the same function, and the bound (bytes over
               3.35 TB/s or operations over the peak rate of the operands'
               type). Per shape numbers included; for the resblock group
               and the U-Net chain (per level) also their TFLOP/s, the HBM
               bytes their design moves, and a cuDNN yardstick (the
               group's 18 convs as bf16 F.conv1d calls, the level's 8 3x3
               convs and its 1x1 shortcut as bf16 F.conv2d calls); for the
               U-Net chain the tile and grid of each level's launches; for
               the Viterbi decode its three launches timed apart (forward,
               backpointers, walk); for band attention its TFLOP/s, its
               CTAs and those that exit early (rows all past the length),
               and a flash-SDPA yardstick on the same q, k, v over each
               row's valid length (no relative terms).
  fcpe:        as the crepe path, with the full FCPE (12 layers x 512 channels,
               with_fcpe=True) and f0_method="fcpe": the resblock group 36
               times, conv-transpose 4, band attention, neither unet_chain
               nor viterbi; then its profile (fcpe_profile), with the FCPE
               pass's share of the convert's kernel time.
  nof0:        the 48 kHz v2 model built with use_f0=False: the same
               launch counts, and no F0 pass runs.
  v1_32k:      a v1 32 kHz f0 model of RVC-Project's configs/v1/32k.json
               shape (upsample rates 10, 4, 2, 2, 2, kernels 16, 16, 4, 4,
               4 from 512 channels; HuBERT's final_proj into the 256-wide
               content input; the port's factory builds version "v1" at
               those published rates), on rmvpe+: the resblock group 45
               times (5 stages x 9 pairs), conv-transpose 5, unet_chain
               112. Its second stage has padding 6 > stride 4
               (conv-transpose offsets -2..2) and its fifth is 16 wide,
               padded to 32 at load.
  kernels_v1_32k: the conv-transpose and resblock-group kernels the same
               way on the v1_32k path's inputs (u = 4, k = 16, padding 6;
               the padded 16 -> 32 stage), whose padded channels must come
               out exactly zero; per shape, not added to the kernels line.
  4. reference: the same full-width models on a 2 s input, on the card
               (bf16) and on the CPU (float32 plain twins), same noise.
               The two rmvpe+ F0 passes agree on >= 90% of coarse bins, and
               on one F0 (as tests/test_quality.py pins it) the renditions
               stay below the repo's 0.5 dB mel-distortion gate. The two
               mangio-crepe F0 passes (float16 salience on both) stay in
               the bf16 bounds of tests/test_f0_methods.py; the two fcpe
               passes (float32 on both) in its fcpe bounds (median relative
               error < 1e-4, > 95% of frames below 1e-2, > 95% of coarse
               bins equal). The no-f0 renditions, and the v1 32 kHz
               renditions on one F0, stay below 0.5 dB.
  discriminators: multi_period_discriminator v2 (models/discriminators.py,
               plain convs, no kernel) at full width on 2 x 1 x 48,000
               samples of real and generated audio, float32 with TF32 off,
               on the card and on the CPU: 9 heads each, every logit and
               feature map within 1e-4 of the CPU map's largest |value|;
               the card's wall time of one call.
Then a "total" line with the script's seconds, the {"kernels": [...]}
line, the nvidia-smi line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor core / CUDA core
SONG_SECONDS = 60.0
BENCH_OPTS = dict(index_rate=0.5, protect=0.33, volume_envelope=0.25)
BENCH_TIERS = dict(x_pad=1, x_query=6, x_center=30, x_max=32, chunk_batch=2,
                   bucket_step_s=4)


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries the script's time so far."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def bench_song(seconds: float, sr: int = 16000) -> np.ndarray:
    """bench.py's synthetic song: vibrato sine + octave + light noise."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * sr)) / sr
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    return (0.4 * np.sin(2 * np.pi * 220.0 * t * vibrato)
            + 0.1 * np.sin(2 * np.pi * 440.0 * t)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


class Recorder:
    """Wraps the model modules' kernel entry points for one run: keeps a
    clone of the inputs of each distinct call signature and counts its
    calls; forwards every call unchanged (counting stays in the wrapper)."""

    SITES = (
        ("resblock_group", "polgen_rvc_tpu_torch.models.nsf", "fused_resblock_group"),
        ("conv_transpose", "polgen_rvc_tpu_torch.models.nsf", "conv_transpose1d"),
        ("band_attention", "polgen_rvc_tpu_torch.models.synthesizer", "band_attention"),
        ("unet_chain", "polgen_rvc_tpu_torch.models.rmvpe", "convblock_chain"),
        ("viterbi", "polgen_rvc_tpu_torch.models.crepe", "viterbi_path"),
    )

    def __init__(self, names=None):
        import importlib

        sites = [s for s in self.SITES if names is None or s[0] in names]
        self.calls = {name: {} for name, _, _ in sites}
        self._saved = []
        for name, mod_name, attr in sites:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))

    def _wrap(self, name, fn):
        import torch

        def recorded(*args, **kwargs):
            key = tuple(
                (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
                and a.dim() > 1 else
                (tuple(a.tolist()) if isinstance(a, torch.Tensor) else None)
                for a in args
            )
            entry = self.calls[name].get(key)
            if entry is None:
                kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args)
                entry = self.calls[name][key] = {"args": kept, "kwargs": kwargs,
                                                 "count": 0}
            entry["count"] += 1
            return fn(*args, **kwargs)

        return recorded

    def restore(self):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps runs after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn) -> float:
    """Device time in ms of one call of fn(): for the slow plain twins (the
    Viterbi's step loop), timed on the call after the one that gave the
    reference, so warm as cuda_ms(fn, reps=1) times it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tree_tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)


def profile_convert(vc, song, opts) -> dict:
    """One more convert under torch.profiler: the device's busy share of the
    wall time (sum of kernel times; one stream, so kernels do not overlap)
    and the kernels by device time. The port's kernels show under their
    mangled names (pair_kernel, convt_kernel, band_attention_kernel,
    unet_conv3x3_kernel)."""
    return profile_call(lambda: vc.convert(song, opts))


def profile_call(fn) -> dict:
    """fn() once under torch.profiler, tracing the device only (host ops
    untraced, which keeps the tracing cost off the host): wall time, kernel
    time, idle share and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append({"name": evt.key[:80], "calls": evt.count, "ms": us / 1e3})
    kernels.sort(key=lambda k: -k["ms"])
    busy_ms = sum(k["ms"] for k in kernels)
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no device time")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / (wall * 1e3)) if busy_ms else None,
            "kernels": kernels}


def crepe_layer_times(params, compute_dtype) -> list:
    """Each CREPE layer on one full 2,048-frame slab (random frames): the
    cuDNN conv alone, with its rate, and the fp32 epilogue after it
    (upcast, bias, ReLU, affine, pool), as models/crepe.py runs them."""
    import torch
    import torch.nn.functional as F

    from polgen_rvc_tpu_torch.models.crepe import FULL_LAYERS
    from polgen_rvc_tpu_torch.pipeline.crepe_method import _FRAME_BUCKET

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(_FRAME_BUCKET, 1, 1024, device="cuda", generator=g)
    rows = []
    for i, (p, (c_out, k, stride, pt, pb)) in enumerate(zip(params["convs"], FULL_LAYERS)):
        xin = F.pad(x, (pt, pb)).to(compute_dtype)
        w = p["w_conv"]
        conv_ms = cuda_ms(lambda: F.conv1d(xin, w, stride=stride), reps=3)
        y = F.conv1d(xin, w, stride=stride)

        def epilogue():
            z = y.float().add_(p["b"][:, None]).relu_()
            return F.max_pool1d(z.mul_(p["s"][:, None]).add_(p["t"][:, None]), 2)

        epi_ms = cuda_ms(epilogue, reps=3)
        flops = 2.0 * _FRAME_BUCKET * c_out * xin.shape[1] * k * y.shape[-1]
        rows.append({"layer": i + 1, "c_in": xin.shape[1], "c_out": c_out, "k": k,
                     "rows_out": y.shape[-1], "conv_ms": conv_ms,
                     "conv_tflop_per_s": flops / conv_ms / 1e9, "epilogue_ms": epi_ms})
        x = epilogue()
        del xin, y
    return rows


def packed_tensors(tree, keys=("w_taps", "w_mat", "b")):
    """The tensors a kernel reads from a packed parameter tree: the packed
    weight layouts and the biases (not the fp32 originals beside them)."""
    import torch

    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in keys and isinstance(v, torch.Tensor):
                yield v
            else:
                yield from packed_tensors(v, keys)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from packed_tensors(v, keys)


def abs_stats(ref) -> dict:
    a = ref.abs().float().flatten()
    return {"max_abs_ref": float(a.max()), "median_abs_ref": float(a.median())}


def resblock_design_bytes(x, dilations) -> int:
    """HBM bytes one resblock group moves in the pair kernel's design: per
    launch its input read once (x's type for a resblock's first pair, else
    the fp32 stream), its result written once (the fp32 stream or running
    sum; x's type for the group's output), the fp32 running sum read where
    it is added. The residual's second read of the input is counted as an
    L2 hit, the weights apart."""
    n, xs = x.numel(), x.element_size()
    total = 0
    for r, dils in enumerate(dilations):
        for i in range(len(dils)):
            total += n * (xs if i == 0 else 4)
            if i < len(dils) - 1:
                total += 4 * n
            else:
                total += (xs if r == len(dilations) - 1 else 4) * n + (4 * n if r else 0)
    return total


def unet_design_bytes(x, blocks) -> int:
    """HBM bytes one U-Net level moves in the chain kernel's design: per
    launch its input read once (x's type for the first block, bf16 h for
    every conv2, the fp32 block output after), the residual or shortcut
    input read once (x's type, then fp32), and its output written once
    (bf16 h, the fp32 block output, x's type for the last). The halo and
    per-tile restaging of the input count as L2 hits, the weights apart."""
    b, c, t, w = x.shape
    n, xs = b * t * w, x.element_size()
    total, ci, cs = 0, c, xs
    for i, blk in enumerate(blocks):
        co = blk["conv1"]["w"].shape[0]
        last = i == len(blocks) - 1
        total += n * (ci * cs + co * 2)                              # conv1
        total += n * (co * 2 + ci * cs + co * (xs if last else 4))   # conv2
        ci, cs = co, 4
    return total


def structured_log_obs(t: int, n: int, seed: int = 0):
    """(t, 360) Viterbi log observations: a random-walk peak over low noise,
    masked edges, a block of all-tie frames, garbage rows past n."""
    import torch

    rng = np.random.default_rng(seed)
    probs = rng.random((t, 360)).astype(np.float32) * 0.01
    c = np.clip(180 + np.cumsum(rng.integers(-3, 4, t)), 0, 359)
    probs[np.arange(t), c] = 0.9
    probs[:, :40] = 0.0
    probs[:, 300:] = 0.0
    probs[t // 3:t // 3 + 20] = 0.0
    probs[n:] = rng.random((t - n, 360)).astype(np.float32)
    obs = probs / np.maximum(probs.sum(1, keepdims=True), 1e-20)
    return torch.from_numpy(np.log(obs + 1e-20).astype(np.float32))


def check_kernels(calls: dict) -> dict:
    """Phase 3: kernel vs plain twin on every recorded input of its path
    (calls: Recorder.calls of both paths' recorders).

    Each kernel is held to its plain twin over its whole call (a resblock
    group of 18 convs, a U-Net level of 8) in the kernel's working
    precision, and one launch of it (one conv, or one conv pair of the
    resblock group; the same bf16-rounded operands both sides) to its plain
    twin at fp32 summation order.
    The Viterbi path must equal the twin's exactly."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from polgen_rvc_tpu_torch.ops import band_attention as ba
    from polgen_rvc_tpu_torch.ops import conv_transpose as ct
    from polgen_rvc_tpu_torch.ops import resblock_group as rg
    from polgen_rvc_tpu_torch.ops import unet_chain as uc
    from polgen_rvc_tpu_torch.ops import viterbi as vt

    bf16 = torch.bfloat16
    out = {}
    calls = {name: calls.get(name, {}) for name in
             ("resblock_group", "conv_transpose", "band_attention", "unet_chain", "viterbi")}

    def rnd(t):
        return t.to(bf16).float()

    def single(got, ref):
        """One launch against one plain op: fp32 summation order only."""
        err = float((got - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max()) + 1e-5
        if not err <= tol:
            raise AssertionError(f"single launch: max_abs_err {err} > {tol}")
        return {"max_abs_err": err, "tolerance": tol, **abs_stats(ref)}

    def add(name, err, tol, ref, ms, plain_ms, lib_ms, flops, byts, dtype,
            count, shape, one=None):
        dtype = str(dtype).removeprefix("torch.")
        bytes_ms = byts / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        s = out.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                  "library_ms": None if lib_ms is None else 0.0,
                                  "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                                  "flops": 0.0, "bytes": 0.0, "shapes": []})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", max(bytes_ms, ops_ms)), ("bytes_ms", bytes_ms),
                     ("ops_ms", ops_ms), ("flops", flops), ("bytes", byts)):
            s[k] += v * count
        if lib_ms is not None:
            s["library_ms"] += lib_ms * count
        s["bound_by"] = "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations"
        s["shapes"].append({"shape": shape, "calls": count, "max_abs_err": err,
                            "tolerance": tol, **abs_stats(ref), "ms": ms,
                            "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": max(bytes_ms, ops_ms),
                            "peak": dtype, "checks": one})
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: max_abs_err {err} > {tol}")

    cudnn_convs_ms = 0.0
    for e in calls["resblock_group"].values():
        x, params, ks, ds = e["args"]
        b, c, t = x.shape
        # bf16 operands on both sides; an intermediate near a bf16 rounding
        # boundary may round one ulp apart before the next of 18 convs. The
        # fp32 route first, then the route the decoder takes (x's dtype,
        # bf16 in a bf16 engine; its one rounding of the output is inside)
        x32 = x.float().contiguous()
        ref = rg.resblock_group_plain(x32, params, ks, ds, operand_dtype=bf16)
        got = rg.fused_resblock_group(x32, params, ks, ds)
        fp32_err, fp32_tol = float((got - ref).abs().max()), 1e-2 * float(ref.abs().max())
        if not fp32_err <= fp32_tol:
            raise AssertionError(f"resblock_group fp32 route: {fp32_err} > {fp32_tol}")
        ref = rg.resblock_group_plain(x, params, ks, ds, operand_dtype=bf16).float()
        got = rg.fused_resblock_group(x, params, ks, ds).float()
        err, tol = float((got - ref).abs().max()), 1e-2 * float(ref.abs().max())
        # one launch: the widest-halo pair (k = 11, d = 5) at fp32 x, against
        # its twin on the same bf16 operands: fp32 order, plus one bf16 ulp
        # of h (<= 2^-7 |h|) where the two round h apart, through conv2
        c1, c2, k, d = params[-1]["convs1"][-1], params[-1]["convs2"][-1], ks[-1], ds[-1][-1]
        pair_ref = rg.resblock_pair_plain(x32, c1, c2, k, d, operand_dtype=bf16)
        pair_got = rg.resblock_pair(x32, c1, c2, k, d)
        h = F.leaky_relu(F.conv1d(rnd(F.leaky_relu(x32, rg.LRELU_SLOPE)), rnd(c1["w"]),
                                  c1["b"], padding=d * (k - 1) // 2, dilation=d),
                         rg.LRELU_SLOPE)
        limit = (1e-4 * float(pair_ref.abs().max())
                 + F.conv1d(2.0 ** -7 * rnd(h).abs(), rnd(c2["w"]).abs(),
                            padding=(k - 1) // 2))
        pair_err = (pair_got - pair_ref).abs()
        if not bool((pair_err <= limit).all()):
            raise AssertionError("resblock_group one pair: error above fp32 order "
                                 "+ one bf16 ulp of h through conv2")
        del h, limit
        one = {"fp32_route": {"max_abs_err": fp32_err, "tolerance": fp32_tol},
               "one_pair_k11_d5": {"max_abs_err": float(pair_err.max()),
                                   **abs_stats(pair_ref)}}
        del pair_ref, pair_got, pair_err
        convs = [(p[key][i]["w"].to(bf16), p[key][i]["b"].to(bf16), kk,
                  dd if key == "convs1" else 1)
                 for p, kk, dils in zip(params, ks, ds) for i, dd in enumerate(dils)
                 for key in ("convs1", "convs2")]
        xb = x.to(bf16)

        def cudnn_convs():
            for w, bb, kk, dd in convs:
                F.conv1d(xb, w, bb, padding=dd * (kk - 1) // 2, dilation=dd)

        cudnn_ms = cuda_ms(cudnn_convs)
        cudnn_convs_ms += cudnn_ms * e["count"]
        flops = sum(2.0 * b * c * c * k * t * 2 * len(d) for k, d in zip(ks, ds))
        ms = cuda_ms(lambda: rg.fused_resblock_group(x, params, ks, ds))
        moved = resblock_design_bytes(x, ds) + nbytes(*packed_tensors(params))
        one.update({"cudnn_18_convs_ms": cudnn_ms, "tflop_per_s": flops / ms / 1e9,
                    "design_hbm_bytes": moved, "design_tb_per_s": moved / ms / 1e9})
        byts = 2 * nbytes(x) + nbytes(*packed_tensors(params))
        add("resblock_group", err, tol, ref, ms,
            cuda_ms(lambda: rg.resblock_group_plain(x, params, ks, ds,
                                                    operand_dtype=bf16)),
            None, flops, byts, bf16, e["count"], [b, c, t, str(x.dtype)], one)
    if "resblock_group" in out:
        out["resblock_group"]["cudnn_convs_ms"] = cudnn_convs_ms

    for e in calls["conv_transpose"].values():
        x, w, bias = e["args"][:3]
        kw = e["kwargs"]
        geo = dict(stride=kw["stride"], padding=kw["padding"])
        b, c_in, t = x.shape
        c_out, k = w.shape[1], w.shape[2]
        ref = ct.conv_transpose1d_plain(x.float(), w, bias, operand_dtype=bf16, **geo)
        # the fp32 route: the same bf16-rounded operands, fp32 order only
        one = {"fp32_route": single(ct.conv_transpose1d(x.float(), w, bias, **kw), ref)}
        # the route the decoder takes (x in its dtype, bf16 in a bf16
        # engine): one rounding of the fp32 result, plus fp32 order
        got = ct.conv_transpose1d(x, w, bias, **kw).float()
        limit = 2.0 ** -8 * ref.abs() + 1e-4 * float(ref.abs().max())
        if not bool(((got - ref).abs() <= limit).all()):
            raise AssertionError("conv_transpose: error above one rounding of the result")
        err, tol = float((got - ref).abs().max()), float(limit.max())
        wb, bb = w.to(x.dtype), bias.to(x.dtype)
        add("conv_transpose", err, tol, ref,
            cuda_ms(lambda: ct.conv_transpose1d(x, w, bias, **kw)),
            cuda_ms(lambda: ct.conv_transpose1d_plain(x, w, bias,
                                                      operand_dtype=bf16, **geo)),
            cuda_ms(lambda: F.conv_transpose1d(x, wb, bb, **geo)),
            2.0 * b * c_in * c_out * k * t,
            nbytes(x, kw["taps"], bias) + b * c_out * t * kw["stride"] * x.element_size(),
            bf16, e["count"], [b, c_in, c_out, t, kw["stride"], str(x.dtype)], one)

    for e in calls["band_attention"].values():
        q, k, v, rk, rv, lens, window = e["args"]
        bh, t, dk = q.shape
        # compare in fp32 out (the kernel rounds fp32 inputs to its bf16
        # operands; the main path's are bf16 already)
        f32 = [a.float() for a in (q, k, v, rk, rv)]
        got = ba.band_attention(*f32, lens, window)
        ref = ba.band_attention_plain(*f32, lens, window, operand_dtype=bf16)
        valid = torch.arange(t, device=q.device)[None, :, None] < lens[:, None, None]
        err = float(((got - ref) * valid).abs().max())
        # the kernel rounds p to bf16 (unit roundoff 2^-8) before the value
        # product: per element |err| <= 2^-8 sum_u p_u |v_u|, plus fp32 order
        zero_rv = torch.zeros_like(f32[4])
        p_abs_v = ba.band_attention_plain(f32[0], f32[1], f32[2].abs(), f32[3], zero_rv,
                                          lens, window, operand_dtype=bf16)
        limit = (2.0 ** -8 * p_abs_v + 1e-4 * float(ref.abs().max())) * valid
        if not bool(((got - ref).abs() * valid <= limit).all()):
            raise AssertionError("band_attention: error above 2^-8 sum p|v| + 1e-4 max|ref|")
        tol = float(limit.max())
        # the rel-value band term alone: the difference of two launches that
        # differ only in rel_v (p and the value product are the same in
        # both), against the plain twin's, at fp32 order
        band_got = got - ba.band_attention(*f32[:4], zero_rv, lens, window)
        band_ref = ref - ba.band_attention_plain(*f32[:4], zero_rv, lens, window,
                                                 operand_dtype=bf16)
        band_err = float(((band_got - band_ref) * valid).abs().max())
        # (1e-3: p's fp32 order; 4e-6 of the largest output: a few fp32 ulps
        # of the two outputs whose difference this is)
        band_tol = (1e-3 * float((band_ref * valid).abs().max())
                    + 4e-6 * float(ref.abs().max()))
        if not band_err <= band_tol:
            raise AssertionError(f"band_attention rel-value term: {band_err} > {band_tol}")
        lens_l = [min(int(n), t) for n in lens.tolist()]
        flops = sum(4.0 * n * n * dk for n in lens_l)
        ms = cuda_ms(lambda: ba.band_attention(q, k, v, rk, rv, lens, window))
        # yardstick: flash SDPA on the same q, k, v over each row's valid
        # keys and queries, rows of one length in one call, no relative terms
        groups = {}
        for i, n_valid in enumerate(lens_l):
            groups.setdefault(n_valid, []).append(i)
        sdpa_in = [tuple(a[idx, :n_valid].to(bf16).contiguous()[None] for a in (q, k, v))
                   for n_valid, idx in groups.items()]
        # the wrapper's copies of q, k, v into the kernel's (BH, T, dk)
        # layout where the caller's tensors are views in another
        copies_ms = cuda_ms(lambda: [ba._operand(a) for a in (q, k, v)])
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            sdpa_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(*a, scale=1.0)
                                       for a in sdpa_in])
        # clusters of two CTAs a block of rows; those past the row's length
        # exit before any key tile
        blocks = -(-t // ba.BLOCK_ROWS)
        early = sum(2 * (blocks - -(-n_valid // ba.BLOCK_ROWS)) for n_valid in lens_l)
        # the bound takes the peak of the type the main path hands the
        # function (bf16 in a bf16 engine)
        add("band_attention", err, tol, ref * valid, ms,
            cuda_ms(lambda: ba.band_attention_plain(q, k, v, rk, rv, lens, window)),
            None, flops, nbytes(q, k, v, rk, rv, lens) + nbytes(q),
            q.dtype, e["count"], [bh, t, dk, lens_l],
            {"rel_value_term": {"max_abs_err": band_err, "tolerance": band_tol,
                                **abs_stats(band_ref * valid)},
             "tflop_per_s": flops / ms / 1e9, "sdpa_flash_ms": sdpa_ms,
             "operand_copies_ms": copies_ms,
             "contiguous": [a.is_contiguous() for a in (q, k, v)],
             "ctas": 2 * blocks * bh, "early_exit_ctas": early})
        out["band_attention"]["sdpa_flash_ms"] = (
            out["band_attention"].get("sdpa_flash_ms", 0.0) + sdpa_ms * e["count"])

    unet_cudnn_ms = 0.0
    for e in calls["unet_chain"].values():
        x, blocks = e["args"]
        b, c, t, w = x.shape
        c_out = blocks[-1]["conv2"]["w"].shape[0]
        # bf16 operands both sides; one-ulp re-rounding between 8 convs (and
        # for a bf16 x its one rounding of the output, inside the 1%)
        ref = uc.convblock_chain_plain(x, blocks, operand_dtype=bf16).float()
        got = uc.convblock_chain(x, blocks)
        if got.dtype != x.dtype:
            raise AssertionError(f"unet_chain returned {got.dtype} for {x.dtype} x")
        err, tol = float((got.float() - ref).abs().max()), 1e-2 * float(ref.abs().max())
        # one launch of each output kind against unet_conv3x3_plain on the
        # same input: the first block's conv1 into bf16 h (fp32 order plus
        # one rounding of the output, 2^-8 |ref|), its conv2 with the
        # residual or 1x1 shortcut of the block input into the fp32 block
        # output, and the last block's conv2 into x's dtype
        # (a direct launch takes a contiguous x; the chain makes it so)
        xc = x.contiguous()
        blk = blocks[0]
        c1, c2, sc = blk["conv1"], blk["conv2"], blk.get("shortcut")
        h_ref = uc.unet_conv3x3_plain(xc, c1)
        h_got = uc.unet_conv3x3(xc, c1, out_dtype=bf16)
        h_lim = 2.0 ** -8 * h_ref.abs() + 1e-4 * float(h_ref.abs().max()) + 1e-5
        if h_got.dtype != bf16 or not bool(((h_got.float() - h_ref).abs() <= h_lim).all()):
            raise AssertionError("unet_chain conv1 -> bf16 h: error above fp32 order "
                                 "+ one bf16 rounding")
        one = {"conv1_bf16_h": {"max_abs_err": float((h_got.float() - h_ref).abs().max()),
                                **abs_stats(h_ref)},
               "conv2_fp32_cur": single(uc.unet_conv3x3(h_got, c2, res=xc, shortcut=sc),
                                        uc.unet_conv3x3_plain(h_got, c2, res=xc,
                                                              shortcut=sc))}
        last = blocks[-1]
        h_last = torch.randn(b, c_out, t, w, device=x.device).to(bf16)
        cur_in = torch.randn(b, c_out, t, w, device=x.device) if len(blocks) > 1 else xc
        l_ref = uc.unet_conv3x3_plain(h_last, last["conv2"], res=cur_in,
                                      shortcut=last.get("shortcut"))
        l_got = uc.unet_conv3x3(h_last, last["conv2"], res=cur_in,
                                shortcut=last.get("shortcut"), out_dtype=x.dtype).float()
        l_lim = (2.0 ** -8 * l_ref.abs() if x.dtype == bf16 else 0.0) + \
            1e-4 * float(l_ref.abs().max()) + 1e-5
        if not bool(((l_got - l_ref).abs() <= l_lim).all()):
            raise AssertionError("unet_chain last conv2 -> x's dtype: error above "
                                 "fp32 order (+ one rounding)")
        one["conv2_last_x_dtype"] = {"max_abs_err": float((l_got - l_ref).abs().max()),
                                     **abs_stats(l_ref)}
        del xc, h_ref, h_got, h_last, cur_in, l_ref, l_got
        flops = 0.0
        convs = []
        ci = c
        for blk in blocks:
            co = blk["conv1"]["w"].shape[0]
            flops += 2.0 * 9 * b * t * w * (ci * co + co * co)
            convs += [(blk["conv1"]["w"].to(bf16), blk["conv1"]["b"].to(bf16), 1),
                      (blk["conv2"]["w"].to(bf16), blk["conv2"]["b"].to(bf16), 1)]
            if "shortcut" in blk:
                flops += 2.0 * b * t * w * ci * co
                convs.append((blk["shortcut"]["w"].to(bf16),
                              blk["shortcut"]["b"].to(bf16), 0))
            ci = co
        xb = x.to(bf16)
        cin_of = [cv[0].shape[1] for cv in convs]
        inputs = {ci: xb if ci == c else torch.randn(b, ci, t, w, device=x.device,
                                                     dtype=bf16) for ci in set(cin_of)}

        def cudnn_convs():
            for (wt, bb, pad), ci in zip(convs, cin_of):
                F.conv2d(inputs[ci], wt, bb, padding=pad)

        cudnn_ms = cuda_ms(cudnn_convs)
        unet_cudnn_ms += cudnn_ms * e["count"]
        ms = cuda_ms(lambda: uc.convblock_chain(x, blocks))
        tile = uc.unet_conv3x3_tile(c_out, w)
        moved = unet_design_bytes(x, blocks) + nbytes(*packed_tensors(blocks))
        one.update({"cudnn_convs_ms": cudnn_ms, "tflop_per_s": flops / ms / 1e9,
                    "tile": tile, "grid": [-(-t // tile["tt"]), c_out // tile["bm"], b],
                    "design_hbm_bytes": moved, "design_tb_per_s": moved / ms / 1e9})
        del inputs
        add("unet_chain", err, tol, ref, ms,
            cuda_ms(lambda: uc.convblock_chain_plain(x, blocks, operand_dtype=bf16)),
            None, flops,
            nbytes(x, *packed_tensors(blocks)) + b * c_out * t * w * x.element_size(),
            bf16, e["count"], [b, c, c_out, t, w, str(x.dtype)], one)
    if "unet_chain" in out:
        out["unet_chain"]["cudnn_convs_ms"] = unet_cudnn_ms

    for e in calls["viterbi"].values():
        log_obs, n = e["args"]
        t_len, bins = log_obs.shape
        got = vt.viterbi_path(log_obs, n)
        ref = vt.viterbi_path_plain(log_obs, n)
        plain_ms = timed_once(lambda: vt.viterbi_path_plain(log_obs, n))
        mismatches = int((got != ref).sum())
        # per step and bin: 23 candidate adds and compares, the teleport
        # compare, + obs, the block max's compare and the renorm subtract,
        # over the n - 1 steps this input runs; log_obs rows < n read once,
        # the int32 path written once
        steps = max(min(n, t_len) - 1, 0)
        # the three launches of one call timed alone, each on its
        # predecessor's output: the forward recursion, the backpointers,
        # the walk
        rows = vt._forward(log_obs, n)
        back, maps = vt._backpointers(rows, n)
        split = {"forward_ms": cuda_ms(lambda: vt._forward(log_obs, n)),
                 "backpointers_ms": cuda_ms(lambda: vt._backpointers(rows, n)),
                 "walk_ms": cuda_ms(lambda: vt._walk(rows, back, maps, t_len, n))}
        split["forward_us_per_step"] = 1e3 * split["forward_ms"] / max(steps, 1)
        add("viterbi", float((got - ref).abs().max()), 0.0, ref,
            cuda_ms(lambda: vt.viterbi_path(log_obs, n)), plain_ms,
            None, 50.0 * steps * bins, min(n, t_len) * bins * 4 + t_len * 4,
            torch.float32, e["count"], [t_len, bins, n],
            {"path_mismatches": mismatches, **split})
        # random CREPE weights give a path that barely moves: the same shape
        # again on a random-walk track with all-tie frames (not a launch of
        # the path, so it adds to no per-convert total)
        walk = structured_log_obs(t_len, n).to(log_obs.device)
        got = vt.viterbi_path(walk, n)
        ref = vt.viterbi_path_plain(walk, n)
        plain_ms = timed_once(lambda: vt.viterbi_path_plain(walk, n))
        add("viterbi", float((got - ref).abs().max()), 0.0, ref,
            cuda_ms(lambda: vt.viterbi_path(walk, n)), plain_ms, None, 0.0, 0.0,
            torch.float32, 0, [t_len, bins, n, "random walk"],
            {"path_mismatches": int((got != ref).sum()),
             "distinct_bins": int(ref.unique().numel())})
    return out


def model_bytes(vc) -> int:
    """Device bytes of the converter's parameters (packed layouts included)."""
    seen = {}
    for tree in (vc.synth_params, vc.hubert_params, vc.rmvpe_params, vc.index_bank,
                 vc.crepe_params, vc.fcpe_params):
        for t in tree_tensors(tree):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def zero_launches(wrappers: dict):
    for fn in wrappers.values():
        fn.launches = 0


def read_launches(wrappers: dict) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def drive(vc, song, opts, wrappers: dict) -> dict:
    """One warm-up convert; then every kernel's launch count set to 0, one
    timed convert, the counts read. Returns its numbers and output, and
    whether the two converts gave the same bytes (repeatable). Peak
    memory: max_memory_allocated counts whatever the script still holds
    on the card (the main path's recorded kernel inputs, once recorded);
    peak_own_bytes counts only this converter's weights and the convert."""
    import torch

    t0 = time.perf_counter()
    warm_out, _ = vc.convert(song, opts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    zero_launches(wrappers)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, sr = vc.convert(song, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    weights = model_bytes(vc)
    return {"warmup_s": warm_s, "wall_s": wall,
            "realtime_factor": SONG_SECONDS / wall,
            "max_memory_allocated": peak, "resident_before_bytes": resident,
            "model_bytes": weights, "peak_own_bytes": peak - resident + weights,
            "launches": read_launches(wrappers),
            "repeatable": bool(np.array_equal(warm_out, out)), "out": out, "sr": sr}


def check_output(run: dict, expected: int, path: str, launched, idle,
                 sample_rate: int = 48000):
    """The path's output has the planned length and is not silent; the
    kernels in `launched` ran in its timed convert, those in `idle` not."""
    out, sr = run["out"], run["sr"]
    if out.shape[0] != expected or sr != sample_rate:
        raise AssertionError(f"{path}: output {out.shape[0]} samples @ {sr}, "
                             f"expected {expected} @ {sample_rate}")
    if int(np.abs(out.astype(np.int32)).max()) < 1000 or not np.all(np.isfinite(out)):
        raise AssertionError(f"{path}: output is silent")
    missing = [k for k in launched if run["launches"][k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    extra = [k for k in idle if run["launches"][k] != 0]
    if extra:
        raise AssertionError(f"{path}: kernels of another path launched: {extra}")


def check_resblock_launches(run: dict, path: str, stages: int = 4):
    """One launch per conv pair: decoder stages x 9 pairs, one chunk batch."""
    if run["launches"]["resblock_group"] != 9 * stages:
        raise AssertionError(f"{path}: resblock_group launched "
                             f"{run['launches']['resblock_group']} times, not {9 * stages}")


def check_convt_launches(run: dict, path: str, stages: int = 4):
    """One conv-transpose launch per decoder stage, one chunk batch."""
    if run["launches"]["conv_transpose"] != stages:
        raise AssertionError(f"{path}: conv_transpose launched "
                             f"{run['launches']['conv_transpose']} times, not {stages}")


def expected_samples(vc, song, eng, sr: int) -> int:
    """The output length convert plans for this song."""
    from polgen_rvc_tpu_torch.ops.filters import highpass_pad_quant
    from polgen_rvc_tpu_torch.pipeline.chunking import plan_chunks

    audio, _, _, _ = highpass_pad_quant(song, eng.t_pad, eng.window)
    plan = plan_chunks(audio, eng)
    upp = vc.synth_cfg.upp
    return sum(
        max(min((c.slice_end - c.slice_start) // eng.window,
                2 * vc.hubert_cfg.num_frames(c.slice_end - c.slice_start))
            * upp - 2 * sr * eng.x_pad, 0)
        for c in plan.chunks
    )


def padding_stays_zero(calls: dict) -> dict:
    """On the recorded inputs of a path with a padded decoder stage: where a
    conv-transpose's weight and bias are zero from channel c on, its kernel
    output is exactly zero there; where a resblock group's input is zero
    from channel c on, so is its kernel output."""
    from polgen_rvc_tpu_torch.ops import conv_transpose as ct
    from polgen_rvc_tpu_torch.ops import resblock_group as rg

    def live_channels(nonzero):
        idx = nonzero.nonzero()
        return int(idx.max()) + 1 if idx.numel() else 0

    seen = []
    for e in calls.get("conv_transpose", {}).values():
        x, w, bias = e["args"][:3]
        c = live_channels((w.abs().amax(dim=(0, 2)) > 0) | (bias != 0))
        if c < w.shape[1]:
            y = ct.conv_transpose1d(x, w, bias, **e["kwargs"])
            if bool(y[:, c:].any()):
                raise AssertionError("conv_transpose: padded channels not zero")
            seen.append({"kernel": "conv_transpose", "channels": [c, w.shape[1]]})
    for e in calls.get("resblock_group", {}).values():
        x, params, ks, ds = e["args"]
        c = live_channels(x.abs().amax(dim=(0, 2)) > 0)
        if c < x.shape[1]:
            y = rg.fused_resblock_group(x, params, ks, ds)
            if bool(y[:, c:].any()):
                raise AssertionError("resblock_group: padded channels not zero")
            seen.append({"kernel": "resblock_group", "channels": [c, x.shape[1]]})
    if len(seen) != 2:
        raise AssertionError(f"expected one padded stage of each kernel, saw {seen}")
    return {"padded_stages": seen}


def check_unet_launches(run: dict, path: str):
    """One launch per 3x3 conv: 14 U-Net levels x 4 blocks x 2 convs."""
    if run["launches"]["unet_chain"] != 112:
        raise AssertionError(f"{path}: unet_chain launched "
                             f"{run['launches']['unet_chain']} times, not 112")


def chunk_spans(vc, plan) -> list:
    """Each chunk's (start, end) in the song's output samples."""
    eng = vc.engine
    spans, at = [], 0
    for c in plan.chunks:
        n = c.slice_end - c.slice_start
        v = min(n // eng.window, 2 * vc.hubert_cfg.num_frames(n))
        out = max(v * vc.synth_cfg.upp - 2 * vc.tgt_sr * eng.x_pad, 0)
        spans.append((at, at + out))
        at += out
    return spans


def batch_phase(vc, song, opts, wrappers, smi, seconds=(60, 41, 23, 9)) -> dict:
    """convert_batch over four songs cut from the bench song (60, 41, 23 and
    9 s) on the main path's converter, against each song's serial convert.

    One warm-up of each route; then the packed call with the launch counts
    set to 0 before it and read after it (resblock group 36 and
    conv-transpose 4 per packed batch, band attention 6 per batch, the
    U-Net chain 112 per song), and the four serial converts, each timed on
    the host clock and profiled for device time. A song all of whose chunks
    ride the same bucket in both routes must come out byte for byte; any
    other song's difference is printed, per chunk too, and must stay below
    0.5 dB of mel distortion (the whole-song RMS gain spreads a chunk's
    difference into its neighbours' samples)."""
    import torch

    from polgen_rvc_tpu_torch.pipeline.batch_cover import pack_work
    from polgen_rvc_tpu_torch.utils.metrics import mel_distortion_db

    eng = vc.engine
    songs = [song[:s * eng.sample_rate] for s in seconds]
    plans = [vc._prepare_song(x, opts).plan for x in songs]
    work = pack_work(plans, eng)
    packed_bucket = [[0] * len(plan.chunks) for plan in plans]
    for bk, group in work:
        for si, ci in group:
            packed_bucket[si][ci] = bk
    serial_bucket = []
    for plan in plans:
        by_chunk = {}
        for idxs, bucket in zip(*vc._batch_geometry(plan)):
            by_chunk.update({ci: bucket for ci in idxs})
        serial_bucket.append([by_chunk[ci] for ci in range(len(plan.chunks))])

    batches = []
    orig = vc._chunk_batch

    def counted(rows, bucket, *a, **k):
        batches.append(bucket)
        return orig(rows, bucket, *a, **k)

    vc.convert_batch(songs, opts)
    for x in songs:
        vc.convert(x, opts)
    torch.cuda.synchronize()
    vc._chunk_batch = counted
    try:
        zero_launches(wrappers)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = vc.convert_batch(songs, opts)
        torch.cuda.synchronize()
        packed_s = time.perf_counter() - t0
        launches = read_launches(wrappers)
    finally:
        del vc._chunk_batch
    peak = torch.cuda.max_memory_allocated()
    serial, serial_s = [], 0.0
    for x in songs:
        t0 = time.perf_counter()
        serial.append(vc.convert(x, opts))
        torch.cuda.synchronize()
        serial_s += time.perf_counter() - t0
    packed_prof = profile_call(lambda: vc.convert_batch(songs, opts))
    serial_prof = profile_call(lambda: [vc.convert(x, opts) for x in songs])

    conv_pre_ms = conv_pre_times(vc, sorted(set(batches)))
    b, n_songs = len(batches), len(songs)
    want = {"resblock_group": 36 * b, "conv_transpose": 4 * b, "band_attention": 6 * b,
            "unet_chain": 112 * n_songs, "viterbi": 0}
    per_song = []
    for si, (plan, (out, sr), (ref, ref_sr)) in enumerate(zip(plans, packed, serial)):
        same = packed_bucket[si] == serial_bucket[si]
        if sr != ref_sr or out.shape != ref.shape:
            raise AssertionError(f"batch song {si}: {out.shape} @ {sr} against "
                                 f"{ref.shape} @ {ref_sr}")
        d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
        chunks = [{"packed_bucket_s": pb / eng.sample_rate,
                   "serial_bucket_s": sb / eng.sample_rate,
                   "max_abs_diff": int(d[a:e].max()) if e > a else 0,
                   "share_differing": float((d[a:e] > 0).mean()) if e > a else 0.0}
                  for pb, sb, (a, e) in zip(packed_bucket[si], serial_bucket[si],
                                            chunk_spans(vc, plan))]
        entry = {"seconds": seconds[si], "chunks": chunks, "same_buckets": same,
                 "identical": bool(np.array_equal(out, ref)),
                 "max_abs_diff": int(d.max()), "share_differing": float((d > 0).mean()),
                 "mel_distortion_db": mel_distortion_db(out, ref, sr),
                 "peak_int16": int(np.abs(out.astype(np.int32)).max())}
        per_song.append(entry)
    total_s = float(sum(seconds))
    result = {"phase": "batch", "songs_s": list(seconds), "seconds_audio": total_s,
              "chunks": sum(len(p.chunks) for p in plans),
              "packed_batches": b, "packed_buckets_s": [x / eng.sample_rate for x in batches],
              "planned": [[bk / eng.sample_rate, g] for bk, g in work],
              "serial_batches": sum(len(vc._batch_geometry(p)[0]) for p in plans),
              "launches": launches, "launches_expected": want,
              "packed_wall_s": packed_s, "packed_realtime_factor": total_s / packed_s,
              "serial_wall_s": serial_s, "serial_realtime_factor": total_s / serial_s,
              "packed_kernel_ms": packed_prof["device_busy_ms"],
              "serial_kernel_ms": serial_prof["device_busy_ms"],
              "packed_profiled_wall_ms": packed_prof["wall_ms"],
              "serial_profiled_wall_ms": serial_prof["wall_ms"],
              "max_memory_allocated": peak, "songs": per_song,
              "conv_pre_ms": conv_pre_ms, "card": smi}
    emit(result)
    if launches != want:
        raise AssertionError(f"batch: launches {launches}, expected {want}")
    if b != len(work):
        raise AssertionError(f"batch: {b} packed batches ran, {len(work)} planned")
    if not any(len({si for si, _ in g}) > 1 for _, g in work):
        raise AssertionError("batch: no batch mixed songs")
    if not any(bk < max(serial_bucket[si]) for bk, g in work for si, _ in g):
        raise AssertionError("batch: no batch ran below a song's largest bucket")
    if all(entry["same_buckets"] for entry in per_song):
        raise AssertionError("batch: no chunk rode another bucket packed than serial")
    for entry in per_song:
        if not entry["identical"]:
            raise AssertionError(f"batch: the {entry['seconds']} s song differs from "
                                 f"its serial convert: {entry}")
        if entry["peak_int16"] < 1000:
            raise AssertionError(f"batch: the {entry['seconds']} s song is silent")
    return result


F0_FILE_SECONDS = 20


def write_f0_file(path: str, seconds: int = F0_FILE_SECONDS):
    """An F0 file of 10 ms "time,Hz" lines covering `seconds`: half-second
    notes stepping up a scale from 220 Hz, with a 5 Hz vibrato. Returns the
    (times, Hz) written, as float32 the way the engine parses them."""
    t = np.arange(seconds * 100) / 100
    hz = (220.0 * 2.0 ** ((np.floor(t / 0.5) % 8) / 12.0)
          * (1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)))
    with open(path, "w") as f:
        f.write("\n".join(f"{a:.2f},{b:.4f}" for a, b in zip(t, hz)))
    data = np.loadtxt(path, delimiter=",", dtype=np.float32)
    return data[:, 0], data[:, 1]


def f0_file_phase(vc, song, opts, main_out, wrappers, smi,
                  seconds=(60, 41, 23, 9)) -> dict:
    """The main path's converter with an F0 file of 10 ms lines covering
    20 s (pipeline/f0_file.py). The song's coarse pitch over the file's
    frames (from x_pad * 100 on) must equal coarse_f0_np of the file's own
    np.interp onto the frames, computed here on the host; one warm-up, the
    counts set to 0, a timed convert (drive), which must launch as the
    main path does and repeat its bytes, and differ from the main path's
    output; its profile; then convert_batch over the batch phase's songs
    with the file, each song byte-equal to its serial convert."""
    import torch

    from polgen_rvc_tpu_torch.ops.filters import highpass_pad_quant
    from polgen_rvc_tpu_torch.pipeline.f0_file import coarse_f0_np

    eng = vc.engine
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f0_") as tmp:
        path = os.path.join(tmp, "f0.txt")
        times, hz = write_f0_file(path)
        fopts = dataclasses.replace(opts, f0_file=path)
        tf0 = eng.sample_rate // eng.window
        start = eng.x_pad * tf0
        p_len = highpass_pad_quant(song, eng.t_pad, eng.window)[3] // eng.window
        n = int(np.round((times.max() - times.min()) * tf0 + 1))
        interp = np.interp(np.arange(n), times * 100, hz).astype(np.float32)
        stop = min(start + n, p_len)
        want = coarse_f0_np(interp[:stop - start].copy(), opts.f0_min, opts.f0_max)
        prep = vc._prepare_song(song, fopts)
        got = prep.pitch[start:stop].cpu().numpy()
        got_hz = prep.pitchf[start:stop].cpu().numpy()
        run = drive(vc, song, fopts, wrappers)
        profile = profile_convert(vc, song, fopts)
        songs = [song[:s * eng.sample_rate] for s in seconds]
        t0 = time.perf_counter()
        packed = vc.convert_batch(songs, fopts)
        torch.cuda.synchronize()
        packed_s = time.perf_counter() - t0
        serial = [vc.convert(x, fopts) for x in songs]
    per_song = [{"seconds": s, "identical": bool(np.array_equal(out, ref)),
                 "max_abs_diff": int(np.abs(out.astype(np.int32) - ref.astype(np.int32)).max())
                 if out.shape == ref.shape else None}
                for s, (out, _), (ref, _) in zip(seconds, packed, serial)]
    result = {"phase": "f0_file", "file_seconds": F0_FILE_SECONDS, "file_lines": int(times.size),
              "override_frames": [start, stop], "coarse_exact": bool(np.array_equal(got, want)),
              "pitchf_exact": bool(np.array_equal(got_hz, interp[:stop - start])),
              "voiced_bins": sorted(set(int(b) for b in want)),
              **{k: v for k, v in run.items() if k != "out"},
              "out_samples": int(run["out"].shape[0]),
              "differs_from_main": not np.array_equal(run["out"], main_out),
              "kernel_ms": profile["device_busy_ms"], "profiled_wall_ms": profile["wall_ms"],
              "batch_songs_s": list(seconds), "batch_packed_wall_s": packed_s,
              "batch": per_song, "card": smi}
    emit(result)
    if not (result["coarse_exact"] and result["pitchf_exact"]):
        raise AssertionError("f0_file: the overridden frames are not the file's")
    check_output(run, main_out.shape[0], "f0_file path",
                 launched=("resblock_group", "conv_transpose", "band_attention",
                           "unet_chain"), idle=("viterbi",))
    check_resblock_launches(run, "f0_file path")
    check_unet_launches(run, "f0_file path")
    if not run["repeatable"] or not result["differs_from_main"]:
        raise AssertionError(f"f0_file: repeatable {run['repeatable']}, "
                             f"differs from main {result['differs_from_main']}")
    if not all(e["identical"] for e in per_song):
        raise AssertionError(f"f0_file: packed songs differ from serial: {per_song}")
    return result


def conv_pre_times(vc, buckets) -> dict:
    """The decoder's conv_pre on two rows of bf16 input at each bucket's
    frames: at the engine's fixed length (the route the decoder takes) and
    at the row's own length (cuDNN's choice per length), in ms a call."""
    import torch

    from polgen_rvc_tpu_torch.models.nsf import conv_pre

    conv = vc.synth_params["dec"]["conv_pre"]
    fixed = vc._noise_frames()
    out = {"fixed_frames": fixed}
    for bucket in buckets:
        p_len = min(bucket // vc.engine.window, 2 * vc.hubert_cfg.num_frames(bucket))
        x = torch.randn(2, conv["w"].shape[1], p_len, device="cuda").to(torch.bfloat16)
        out[f"{bucket // vc.engine.sample_rate}s"] = {
            "frames": p_len, "fixed_ms": cuda_ms(lambda: conv_pre(conv, x, fixed), reps=50),
            "own_length_ms": cuda_ms(lambda: conv_pre(conv, x), reps=50)}
    return out


def checkpoint_phase(root, eng, song, opts, main_out, wrappers, smi) -> dict:
    """Write the main path's full-width model set as the files a user has
    (torch.save'd RVC v2 48 kHz f0 .pth, fairseq-layout HuBERT, RMVPE's raw
    state dict, a 65,536 x 768 IVF-Flat index in one list) under root, load
    them with build_converter on the card, and convert the 60 s song: the
    output must equal, byte for byte, the synthetic converter's of the main
    path (same seeds, same default noise)."""
    import torch

    from polgen_rvc_tpu_torch.convert.hubert_ckpt import load_hubert_checkpoint
    from polgen_rvc_tpu_torch.convert.rmvpe_ckpt import load_rmvpe_checkpoint
    from polgen_rvc_tpu_torch.convert.rvc_ckpt import load_rvc_checkpoint
    from polgen_rvc_tpu_torch.pipeline.factory import build_converter, write_synthetic_files
    from polgen_rvc_tpu_torch.retrieval.topk import load_index_bank

    t0 = time.perf_counter()
    paths = write_synthetic_files(root, "voice", tiny=False, sr=48000, index_vectors=65536)
    write_s = time.perf_counter() - t0
    files = {}
    for key, loader in (("rvc", load_rvc_checkpoint), ("hubert", load_hubert_checkpoint),
                        ("rmvpe", load_rmvpe_checkpoint), ("index", load_index_bank)):
        t0 = time.perf_counter()
        loader(paths[key])
        files[key] = {"path": os.path.relpath(paths[key], root),
                      "bytes": os.path.getsize(paths[key]),
                      "load_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    cvc = build_converter(paths["rvc"], paths["hubert"], paths["rmvpe"], paths["index"],
                          engine=eng, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    zero_launches(wrappers)
    t0 = time.perf_counter()
    out, sr = cvc.convert(song, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers)
    d = np.abs(out.astype(np.int32) - main_out.astype(np.int32)) \
        if out.shape == main_out.shape else None
    result = {"phase": "checkpoint", "files": files, "write_s": write_s,
              "build_converter_s": build_s, "convert_wall_s": wall, "sr": sr,
              "launches": launches, "out_samples": int(out.shape[0]),
              "equal_to_synthetic": bool(np.array_equal(out, main_out)),
              "max_abs_diff": None if d is None else int(d.max()), "card": smi}
    emit(result)
    del cvc
    if not result["equal_to_synthetic"]:
        raise AssertionError("checkpoint: the converter loaded from files differs "
                             "from the synthetic one")
    missing = [k for k in ("resblock_group", "conv_transpose", "band_attention",
                           "unet_chain") if launches[k] == 0]
    if missing:
        raise AssertionError(f"checkpoint: kernels never launched: {missing}")
    return result


def cli_phase(root, wrappers, smi) -> dict:
    """In a working directory holding models/voice/ and assets/ (the
    checkpoint phase's files), a 20 s stereo 44.1 kHz WAV of the bench song
    through rvc_cli.main with -ir 0.5 -f wav, on the CLI's default engine
    (float32 compute, the kernels' fp32-x routes): output/Voice_Converted.wav
    at 48 kHz, of the length convert plans for the 16 kHz input within one
    frame, finite and not silent, every
    main-path kernel launched (counts set to 0 just before, read after).
    Then -f mp3: libmp3lame where the machine has it, else the WAV
    fallback."""
    import torch

    from polgen_rvc_tpu_torch.app import rvc_cli, voice_conversion
    from polgen_rvc_tpu_torch.utils import mp3_codec
    from polgen_rvc_tpu_torch.utils.audio_io import _write_wav, load_audio, read_audio

    seconds, in_sr = 20, 44100
    x = bench_song(seconds, sr=in_sr)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _write_wav("song.wav", np.stack([x, 0.8 * x], 1), in_sr)
        argv = ["-i", "song.wav", "-m", "voice", "-p", "0", "-ir", "0.5"]
        zero_launches(wrappers)
        t0 = time.perf_counter()
        path = rvc_cli.main(argv + ["-f", "wav"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(wrappers)
        y, sr = read_audio(path)
        (vc,) = voice_conversion._CONVERTER_CACHE.values()
        expected = expected_samples(vc, load_audio("song.wav", 16000), vc.engine, 48000)
        t0 = time.perf_counter()
        mp3_path = rvc_cli.main(argv + ["-f", "mp3"])
        torch.cuda.synchronize()
        mp3_wall = time.perf_counter() - t0
        mp3 = {"path": mp3_path, "wall_s": mp3_wall,
               "encoder": "libmp3lame" if mp3_path.endswith(".mp3") else "wav fallback",
               "bytes": os.path.getsize(mp3_path)}
        if mp3_path.endswith(".mp3") and mp3_codec.available():
            m, msr = read_audio(mp3_path)
            mp3.update(decoded_samples=int(m.shape[0]), decoded_sr=msr)
    finally:
        os.chdir(cwd)
    result = {"phase": "cli", "input": {"seconds": seconds, "sr": in_sr, "channels": 2},
              "path": path, "sr": sr, "samples": int(y.shape[0]),
              "expected_samples": expected, "peak": float(np.abs(y).max()),
              "wall_s": wall, "realtime_factor": seconds / wall,
              "compute_dtype": vc.engine.compute_dtype, "launches": launches,
              "mp3": mp3, "card": smi}
    emit(result)
    voice_conversion._CONVERTER_CACHE.clear()
    del vc
    if path != os.path.join("output", "Voice_Converted.wav") or sr != 48000:
        raise AssertionError(f"cli: wrote {path} at {sr} Hz")
    if abs(int(y.shape[0]) - expected) > 480 or not np.isfinite(y).all() \
            or not result["peak"] > 0.03:
        raise AssertionError(f"cli: output {y.shape} peak {result['peak']}")
    missing = [k for k in ("resblock_group", "conv_transpose", "band_attention",
                           "unet_chain") if launches[k] == 0]
    if missing:
        raise AssertionError(f"cli: kernels never launched: {missing}")
    return result


COVER_EFFECTS = dict(reverb_rm_size=0.5, reverb_wet=0.25, reverb_dry=0.7,
                     compressor_ratio=4.0, compressor_threshold=-18.0,
                     chorus_rate_hz=1.2, chorus_depth=0.25,
                     chorus_centre_delay_ms=8.0, chorus_mix=0.3)


def instrumental(seconds: int, sr: int = 44100) -> np.ndarray:
    """A synthetic stereo backing track: a bass line and a chord pad."""
    t = np.arange(seconds * sr) / sr
    root = 55.0 * 2.0 ** ((np.floor(t) % 4) * 5 / 12.0)
    bass = 0.3 * np.sin(2 * np.pi * root * t)
    pad = sum(0.08 * np.sin(2 * np.pi * 220.0 * r * t) for r in (1.0, 1.26, 1.5))
    return np.stack([bass + pad, bass + 0.8 * pad], 1).astype(np.float32)


def cover_phase(root, wrappers, smi) -> dict:
    """The cover maker's path through the app modules, in `root` (the
    checkpoint phase's files, the cli phase's song.wav): install the
    checkpoint's .pth and .index from a zip (upload_zip_file), convert the
    song with voice_pipeline to FLAC (counts set to 0 just before, read
    after), and mix that vocal with a synthetic 20 s 44.1 kHz stereo
    instrumental through process_audio with the effects on, to FLAC. Both
    outputs must be FLAC that the port's codec decodes at 48 kHz (vocal
    mono, mix stereo and as long as the vocal), the vocal to the very int16
    samples the pipeline wrote."""
    import zipfile

    import torch

    from polgen_rvc_tpu_torch.app import model_manager, voice_conversion
    from polgen_rvc_tpu_torch.app.audio_processing import process_audio
    from polgen_rvc_tpu_torch.native import flac
    from polgen_rvc_tpu_torch.utils.audio_io import _write_wav

    steps, written = {}, []
    cwd = os.getcwd()
    os.chdir(root)
    real_write = voice_conversion.write_audio

    def keep(path, samples, sr):
        written.append(np.array(samples))
        return real_write(path, samples, sr)

    try:
        t0 = time.perf_counter()
        with zipfile.ZipFile("cover.zip", "w") as z:
            for name in ("voice.pth", "voice.index"):
                z.write(os.path.join("models", "voice", name), f"exported/{name}")
        steps["zip_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        msg = model_manager.upload_zip_file("cover.zip", "cover", models_dir="models")
        steps["install_s"] = time.perf_counter() - t0
        installed = sorted(os.listdir(os.path.join("models", "cover")))
        voice_conversion.write_audio = keep
        zero_launches(wrappers)
        t0 = time.perf_counter()
        vocal = voice_conversion.voice_pipeline("song.wav", "cover", 0, index_rate=0.5,
                                                output_format="flac",
                                                output_dir="output_cover")
        torch.cuda.synchronize()
        steps["voice_pipeline_s"] = time.perf_counter() - t0
        launches = read_launches(wrappers)
        voice_conversion.write_audio = real_write
        _write_wav("instrumental.wav", instrumental(20), 44100)
        t0 = time.perf_counter()
        mix = process_audio(vocal, "instrumental.wav", output_format="flac",
                            use_effects=True, output_dir="output_cover", **COVER_EFFECTS)
        steps["process_audio_s"] = time.perf_counter() - t0
        magic = {p: open(p, "rb").read(4) for p in (vocal, mix)}
        t0 = time.perf_counter()
        v, vsr = flac.decode(vocal)
        m, msr = flac.decode(mix)
        steps["decode_s"] = time.perf_counter() - t0
        sizes = {p: os.path.getsize(p) for p in (vocal, mix)}
    finally:
        voice_conversion.write_audio = real_write
        voice_conversion._CONVERTER_CACHE.clear()
        os.chdir(cwd)
    (want,) = written
    result = {"phase": "cover", "installed": installed, "install_message": msg,
              "vocal": {"path": vocal, "bytes": sizes[vocal], "sr": vsr,
                        "shape": list(v.shape), "bitwise": bool(
                            v.shape == (want.shape[0], 1)
                            and np.array_equal((v[:, 0] * 32768).astype(np.int16), want))},
              "mix": {"path": mix, "bytes": sizes[mix], "sr": msr, "shape": list(m.shape),
                      "peak": float(np.abs(m).max()), "finite": bool(np.isfinite(m).all())},
              "effects": COVER_EFFECTS, "steps": steps, "launches": launches, "card": smi}
    emit(result)
    if installed != ["voice.index", "voice.pth"]:
        raise AssertionError(f"cover: installed {installed}")
    if any(mg != b"fLaC" for mg in magic.values()):
        raise AssertionError(f"cover: not FLAC: {magic}")
    if vsr != 48000 or not result["vocal"]["bitwise"]:
        raise AssertionError(f"cover: the vocal FLAC is not the samples written: {result['vocal']}")
    if msr != 48000 or m.shape != (want.shape[0], 2) or not result["mix"]["finite"] \
            or not result["mix"]["peak"] > 0.03:
        raise AssertionError(f"cover: mix {result['mix']}")
    missing = [k for k in ("resblock_group", "conv_transpose", "band_attention",
                           "unet_chain") if launches[k] == 0]
    if missing:
        raise AssertionError(f"cover: kernels never launched: {missing}")
    return result


def prewarm_child(mode: str, root: str) -> int:
    """python3 chip_smoke.py --prewarm-child cold|warm ROOT: a fresh process
    (cold CUDA context, library handles, ctypes libraries and allocator)
    loads ROOT's model files (the checkpoint phase's) with build_converter
    on the card, bf16 at bench's tiers. cold: times its first and second
    convert of the 60 s song; warm: times prewarm, then its first and
    second convert. Prints one JSON line (the walls, prewarm's return
    value, the kernel builds and loads so far after each step) and writes
    each convert's samples to ROOT/prewarm_<mode>_<i>.npy."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from polgen_rvc_tpu_torch.ops import cuda_build
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_converter

    def join(*parts):
        return os.path.join(root, *parts)

    t0 = time.perf_counter()
    vc = build_converter(join("models", "voice", "voice.pth"),
                         join("assets", "embedders", "hubert_base.pt"),
                         join("assets", "predictors", "rmvpe.pt"),
                         join("models", "voice", "voice.index"),
                         engine=EngineConfig(**BENCH_TIERS, compute_dtype="bfloat16"),
                         device="cuda")
    torch.cuda.synchronize()
    out = {"phase": "prewarm_child", "mode": mode,
           "build_converter_s": time.perf_counter() - t0,
           "counts_after_load": cuda_build.counts()}
    song = bench_song(SONG_SECONDS)
    opts = ConversionOptions(**BENCH_OPTS)
    if mode == "warm":
        t0 = time.perf_counter()
        out["prewarm_returned"] = vc.prewarm(song, opts)
        torch.cuda.synchronize()
        out["prewarm_s"] = time.perf_counter() - t0
        out["counts_after_prewarm"] = cuda_build.counts()
    walls = []
    for i in range(2):
        t0 = time.perf_counter()
        y, _ = vc.convert(song, opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        np.save(join(f"prewarm_{mode}_{i}.npy"), y)
        out[f"counts_after_convert_{i}"] = cuda_build.counts()
    out.update(first_convert_s=walls[0], second_convert_s=walls[1],
               device=torch.cuda.get_device_name(0))
    emit(out)
    return 0


def prewarm_phase(root, main_out, smi) -> dict:
    """Two fresh child processes on the checkpoint phase's files (see
    prewarm_child): after prewarm, the warm child's converts build and load
    no kernel; all four converts equal the main path's output byte for
    byte. Prints the cold first convert's wall, the prewarmed first
    convert's and the steady (second) converts' side by side."""
    children = {}
    for mode in ("cold", "warm"):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--prewarm-child",
                            mode, root], capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"prewarm: the {mode} child failed:\n{r.stdout}\n{r.stderr}")
        children[mode] = json.loads(r.stdout.strip().splitlines()[-1])
    equal = {f"{mode}_{i}": bool(np.array_equal(np.load(os.path.join(
        root, f"prewarm_{mode}_{i}.npy")), main_out)) for mode in children for i in range(2)}
    warm = children["warm"]
    after = warm["counts_after_prewarm"]
    extra = {k: warm["counts_after_convert_1"][k] - after[k] for k in after}
    result = {"phase": "prewarm", "cold": children["cold"], "warm": warm,
              "first_convert_cold_s": children["cold"]["first_convert_s"],
              "first_convert_prewarmed_s": warm["first_convert_s"],
              "steady_convert_s": [children["cold"]["second_convert_s"],
                                   warm["second_convert_s"]],
              "builds_and_loads_after_prewarm": extra, "equal_to_main": equal,
              "card": smi}
    emit(result)
    if any(extra.values()):
        raise AssertionError(f"prewarm: converts after prewarm built or loaded kernels: "
                             f"{extra}")
    if not all(equal.values()):
        raise AssertionError(f"prewarm: outputs differ from the main path's: {equal}")
    return result


def http_json(url: str, body=None, content_type: str = "application/json"):
    import urllib.request

    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type},
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def wait_job(base: str, job: str, timeout: float = 600.0) -> dict:
    """Poll /api/job/<id> every 20 ms, as the page does, until it ends."""
    t_end = time.perf_counter() + timeout
    while time.perf_counter() < t_end:
        st = json.loads(http_json(f"{base}/api/job/{job}"))
        if st["status"] in ("done", "error"):
            return st
        time.sleep(0.02)
    raise AssertionError(f"serve: job {job} did not end in {timeout} s")


def serve_phase(root, cover, wrappers, smi) -> dict:
    """The port's UI server (app/ui/server.py) on 127.0.0.1 from a thread,
    in the cover phase's working directory: POST /api/upload (multipart, the
    cli phase's WAV), /api/convert of the zip-installed model (index_rate
    0.5, output_format "wav"), poll /api/job/<id> to done and GET
    /audio/Voice_Converted.wav; counts set to 0 just before, read after.
    The fetched bytes equal what a direct voice_pipeline call on the same
    cached converter writes. A second request, then two posted back to
    back: both done, one after the other, with equal bytes. /api/process
    with the cover phase's inputs and effects, to FLAC, gives the cover
    phase's mix bytes. Walls: request to done, against the direct call."""
    import threading
    from http.server import ThreadingHTTPServer

    import torch

    from polgen_rvc_tpu_torch.app import voice_conversion
    from polgen_rvc_tpu_torch.app.ui import server

    cwd = os.getcwd()
    os.chdir(root)
    real_pipeline = server.voice_pipeline
    runs = []

    def recorded(*args, **kwargs):
        t0 = time.perf_counter()
        path = real_pipeline(*args, **kwargs)
        with open(path, "rb") as f:
            runs.append({"start": t0, "end": time.perf_counter(), "bytes": f.read()})
        return path

    server.voice_pipeline = recorded
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    walls = {}
    try:
        with open("song.wav", "rb") as f:
            wav = f.read()
        body = (b'--SMOKE\r\nContent-Disposition: form-data; name="file"; '
                b'filename="song.wav"\r\n\r\n' + wav + b"\r\n--SMOKE--\r\n")
        uploaded = json.loads(http_json(f"{base}/api/upload", body,
                                        "multipart/form-data; boundary=SMOKE"))["paths"]["file"]
        req = {"input_path": uploaded, "model": "cover", "pitch": 0, "index_rate": 0.5,
               "output_format": "wav"}

        def request():
            t0 = time.perf_counter()
            job = json.loads(http_json(f"{base}/api/convert", req))["job"]
            st = wait_job(base, job)
            if st["status"] != "done":
                raise AssertionError(f"serve: /api/convert ended {st}")
            return time.perf_counter() - t0

        zero_launches(wrappers)
        walls["first_request_s"] = request()
        launches = read_launches(wrappers)
        served = http_json(f"{base}/audio/Voice_Converted.wav")
        walls["second_request_s"] = request()
        jobs = [json.loads(http_json(f"{base}/api/convert", req))["job"] for _ in range(2)]
        states = [wait_job(base, j)["status"] for j in jobs]
        t0 = time.perf_counter()
        path = voice_conversion.voice_pipeline(uploaded, "cover", 0, index_rate=0.5,
                                               output_format="wav")
        torch.cuda.synchronize()
        walls["direct_voice_pipeline_s"] = time.perf_counter() - t0
        with open(path, "rb") as f:
            direct = f.read()
        preq = {"vocal_path": cover["vocal"]["path"], "instrumental_path": "instrumental.wav",
                "output_format": "flac", "use_effects": True, **COVER_EFFECTS}
        t0 = time.perf_counter()
        st = wait_job(base, json.loads(http_json(f"{base}/api/process", preq))["job"])
        walls["process_request_s"] = time.perf_counter() - t0
        mix = http_json(f"{base}/audio/{os.path.basename(st['result'])}")
        with open(cover["mix"]["path"], "rb") as f:
            cover_mix = f.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        server.voice_pipeline = real_pipeline
        voice_conversion._CONVERTER_CACHE.clear()
        os.chdir(cwd)
    back_to_back = runs[2:4]
    result = {"phase": "serve", "walls": walls, "launches": launches,
              "served_bytes": len(served), "served_equals_direct": served == direct,
              "requests_equal": all(r["bytes"] == direct for r in runs),
              "back_to_back": {"states": states, "one_after_the_other":
                               back_to_back[0]["end"] <= back_to_back[1]["start"],
                               "equal": back_to_back[0]["bytes"] == back_to_back[1]["bytes"]},
              "mix_bytes": len(mix), "mix_equals_cover": mix == cover_mix, "card": smi}
    emit(result)
    if not (result["served_equals_direct"] and result["requests_equal"]):
        raise AssertionError("serve: the served WAV differs from voice_pipeline's")
    if states != ["done", "done"] or not result["back_to_back"]["one_after_the_other"] \
            or not result["back_to_back"]["equal"]:
        raise AssertionError(f"serve: back-to-back jobs {result['back_to_back']}")
    if not result["mix_equals_cover"]:
        raise AssertionError("serve: /api/process differs from the cover phase's mix")
    missing = [k for k in ("resblock_group", "conv_transpose", "band_attention",
                           "unet_chain") if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched: {missing}")
    return result


DISC_TOL = 1e-4  # of each map's largest |value|: float32 summation order


def discriminator_phase(smi) -> dict:
    """multi_period_discriminator v2 at full width on 2 x 1 x 48,000 samples
    of real and generated audio (random, from a seed), float32 with TF32
    off, on the card and on the CPU: 9 heads each, every logit and feature
    map within DISC_TOL of the CPU's largest |value| in that map; the card's
    wall time of one call (after one warm-up)."""
    import torch

    from polgen_rvc_tpu_torch import resolve_device
    from polgen_rvc_tpu_torch.convert.params import params_to_torch
    from polgen_rvc_tpu_torch.models.discriminators import (
        init_discriminator_params, multi_period_discriminator,
    )

    resolve_device("cuda")  # TF32 off
    params = init_discriminator_params(version="v2", seed=0)
    rng = np.random.default_rng(9)
    y, y_hat = ((rng.standard_normal((2, 1, 48000)) * 0.1).astype(np.float32)
                for _ in range(2))
    outs, walls = {}, {}
    for dev in ("cuda", "cpu"):
        p = params_to_torch(params, dev)
        a, b = torch.from_numpy(y).to(dev), torch.from_numpy(y_hat).to(dev)
        with torch.inference_mode():
            if dev == "cuda":
                multi_period_discriminator(p, a, b, version="v2")
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[dev] = multi_period_discriminator(p, a, b, version="v2")
            if dev == "cuda":
                torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t0
    heads = [len(x) for x in outs["cuda"]]
    worst = 0.0
    n_maps = 0
    for card_lists, cpu_lists in zip(outs["cuda"], outs["cpu"]):
        for card_head, cpu_head in zip(card_lists, cpu_lists):
            for c, r in zip(tree_tensors(card_head), tree_tensors(cpu_head)):
                if c.shape != r.shape:
                    raise AssertionError(f"discriminators: {tuple(c.shape)} vs {tuple(r.shape)}")
                worst = max(worst, float((c.cpu() - r).abs().max() / r.abs().max()))
                n_maps += 1
    result = {"phase": "discriminators", "version": "v2", "input": [2, 1, 48000],
              "heads": heads, "tensors_compared": n_maps, "worst_rel_err": worst,
              "tolerance": DISC_TOL, "card_wall_s": walls["cuda"],
              "cpu_wall_s": walls["cpu"], "card": smi}
    emit(result)
    if heads != [9, 9, 9, 9]:
        raise AssertionError(f"discriminators: heads {heads}")
    if not worst <= DISC_TOL:
        raise AssertionError(f"discriminators: card vs CPU {worst} > {DISC_TOL}")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from polgen_rvc_tpu_torch import native
    from polgen_rvc_tpu_torch.ops import (
        band_attention, conv_transpose, cuda_build, resblock_group, unet_chain, viterbi,
    )
    from polgen_rvc_tpu_torch.ops.filters import highpass_pad_quant
    from polgen_rvc_tpu_torch.pipeline.chunking import plan_chunks
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter, torch_noise
    from polgen_rvc_tpu_torch.pipeline.factory import (
        build_synthetic_converter, synthetic_params,
    )
    from polgen_rvc_tpu_torch.utils.metrics import mel_distortion_db

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    build_s, reports = cuda_build.timed_build_all()
    ptxas = {name: [ln.split(": ", 1)[-1] for ln in log.splitlines()
                    if "registers" in ln] for name, log in reports.items()}
    t0 = time.perf_counter()
    native_libs = native.build_all()
    native_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "ptxas": ptxas, "native_build_s": native_s,
          "native": {k: os.path.relpath(v) for k, v in native_libs.items()}})

    wrappers = {"resblock_group": resblock_group.fused_resblock_group,
                "conv_transpose": conv_transpose.conv_transpose1d,
                "band_attention": band_attention.band_attention,
                "unet_chain": unet_chain.convblock_chain,
                "viterbi": viterbi.viterbi_path}
    synth_kernels = ("resblock_group", "conv_transpose", "band_attention")

    # ---- main path (rmvpe+) ------------------------------------------------
    eng = EngineConfig(**BENCH_TIERS, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    vc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                                   engine=eng, device="cuda")
    setup_s = time.perf_counter() - t0
    song = bench_song(SONG_SECONDS)
    opts = ConversionOptions(**BENCH_OPTS)
    run = drive(vc, song, opts, wrappers)
    profile = profile_convert(vc, song, opts)
    # one more, untimed convert records each kernel's main-path inputs
    rec = Recorder()
    try:
        vc.convert(song, opts)
    finally:
        rec.restore()

    audio, _, _, _ = highpass_pad_quant(song, eng.t_pad, eng.window)
    plan = plan_chunks(audio, eng)
    expected = expected_samples(vc, song, eng, 48000)
    main = {"phase": "main", "seconds_audio": SONG_SECONDS, "chunks": len(plan.chunks),
            "setup_s": setup_s, **{k: v for k, v in run.items() if k != "out"},
            "out_samples": int(run["out"].shape[0]), "expected_samples": expected,
            "peak_int16": int(np.abs(run["out"].astype(np.int32)).max()), "card": smi}
    emit(main)
    emit({"phase": "profile", **{k: v for k, v in profile.items() if k != "kernels"},
          "top": profile["kernels"][:8]})
    check_output(run, expected, "main path",
                 launched=(*synth_kernels, "unet_chain"), idle=("viterbi",))
    launches = dict(run["launches"])
    check_resblock_launches(run, "main path")
    check_unet_launches(run, "main path")
    if not run["repeatable"]:
        raise AssertionError("main path: two converts of the song differ")

    # ---- batch covers, model files, the CLI ---------------------------------
    batch_phase(vc, song, opts, wrappers, smi)
    main_out = run["out"]
    f0_file_phase(vc, song, opts, main_out, wrappers, smi)
    del vc, run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        checkpoint_phase(root, eng, song, opts, main_out, wrappers, smi)
        cli_phase(root, wrappers, smi)
        cover = cover_phase(root, wrappers, smi)
        serve_phase(root, cover, wrappers, smi)
        prewarm_phase(root, main_out, smi)

    # ---- mangio-crepe path -------------------------------------------------
    t0 = time.perf_counter()
    cvc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                                    engine=eng, device="cuda", with_crepe=True)
    setup_s = time.perf_counter() - t0
    copts = ConversionOptions(f0_method="mangio-crepe", **BENCH_OPTS)
    crun = drive(cvc, song, copts, wrappers)
    cprofile = profile_convert(cvc, song, copts)
    crec = Recorder(names=("viterbi",))
    try:
        cvc.convert(song, copts)
    finally:
        crec.restore()
    padded_len = highpass_pad_quant(song, eng.t_pad, eng.window)[3]
    emit({"phase": "crepe", "seconds_audio": SONG_SECONDS, "hop_length": copts.hop_length,
          "crepe_frames": padded_len // copts.hop_length + 1, "setup_s": setup_s,
          **{k: v for k, v in crun.items() if k != "out"},
          "out_samples": int(crun["out"].shape[0]), "expected_samples": expected,
          "peak_int16": int(np.abs(crun["out"].astype(np.int32)).max()), "card": smi})
    emit({"phase": "crepe_profile",
          **{k: v for k, v in cprofile.items() if k != "kernels"},
          "top": cprofile["kernels"][:12],
          "slab_layers": crepe_layer_times(cvc.crepe_params, cvc.compute_dtype)})
    check_output(crun, expected, "mangio-crepe path",
                 launched=(*synth_kernels, "viterbi"), idle=("unet_chain",))
    if crun["launches"]["viterbi"] != 1:
        raise AssertionError(f"viterbi launched {crun['launches']['viterbi']} "
                             "times in one mangio-crepe convert, not once")
    check_resblock_launches(crun, "mangio-crepe path")
    launches["viterbi"] = crun["launches"]["viterbi"]
    del cvc, crun

    # ---- kernels at the main and crepe paths' inputs -----------------------
    kernels = check_kernels({**rec.calls, **crec.calls})
    del rec, crec
    emit({"phase": "kernels", "detail": kernels})

    # ---- fcpe path ---------------------------------------------------------
    t0 = time.perf_counter()
    fvc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                                    engine=eng, device="cuda", with_fcpe=True)
    setup_s = time.perf_counter() - t0
    fopts = ConversionOptions(f0_method="fcpe", **BENCH_OPTS)
    frun = drive(fvc, song, fopts, wrappers)
    fprofile = profile_convert(fvc, song, fopts)
    _, qbuf, inv_scale, padded_len = highpass_pad_quant(song, eng.t_pad, eng.window)
    fbuf = torch.from_numpy(qbuf).cuda().float() * float(inv_scale)
    f0_profile = profile_call(lambda: fvc.compute_f0(fbuf, fopts, padded_len))
    emit({"phase": "fcpe", "seconds_audio": SONG_SECONDS, "setup_s": setup_s,
          "fcpe": {"layers": fvc.fcpe_cfg.n_layers, "channels": fvc.fcpe_cfg.n_chans,
                   "heads": fvc.fcpe_cfg.n_heads,
                   "features": fvc.fcpe_params["layers"][0]["attn"]["projection_matrix"].shape[0],
                   "frames": qbuf.shape[0] // fvc.fcpe_cfg.hop_size + 1},
          **{k: v for k, v in frun.items() if k != "out"},
          "out_samples": int(frun["out"].shape[0]), "expected_samples": expected,
          "peak_int16": int(np.abs(frun["out"].astype(np.int32)).max()), "card": smi})
    emit({"phase": "fcpe_profile",
          **{k: v for k, v in fprofile.items() if k != "kernels"},
          "top": fprofile["kernels"][:10],
          "fcpe_pass": {"wall_ms": f0_profile["wall_ms"],
                        "device_busy_ms": f0_profile["device_busy_ms"],
                        "share_of_convert_kernel_time":
                            f0_profile["device_busy_ms"] / fprofile["device_busy_ms"],
                        "top": f0_profile["kernels"][:8]}})
    check_output(frun, expected, "fcpe path", launched=synth_kernels,
                 idle=("unet_chain", "viterbi"))
    check_resblock_launches(frun, "fcpe path")
    check_convt_launches(frun, "fcpe path")
    del fvc, frun, fbuf

    # ---- no-f0 model -------------------------------------------------------
    t0 = time.perf_counter()
    nvc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                                    engine=eng, device="cuda", use_f0=False)
    setup_s = time.perf_counter() - t0
    f0_passes = []
    real_f0 = nvc.compute_f0
    nvc.compute_f0 = lambda *a, **k: (f0_passes.append(1), real_f0(*a, **k))[1]
    nrun = drive(nvc, song, opts, wrappers)
    nprofile = profile_convert(nvc, song, opts)
    emit({"phase": "nof0", "seconds_audio": SONG_SECONDS, "setup_s": setup_s,
          "f0_passes": len(f0_passes), **{k: v for k, v in nrun.items() if k != "out"},
          "out_samples": int(nrun["out"].shape[0]), "expected_samples": expected,
          "peak_int16": int(np.abs(nrun["out"].astype(np.int32)).max()),
          "profile": {k: v for k, v in nprofile.items() if k != "kernels"},
          "top": nprofile["kernels"][:8], "card": smi})
    check_output(nrun, expected, "no-f0 path", launched=synth_kernels,
                 idle=("unet_chain", "viterbi"))
    check_resblock_launches(nrun, "no-f0 path")
    check_convt_launches(nrun, "no-f0 path")
    if f0_passes or nvc.rmvpe_params is not None:
        raise AssertionError(f"no-f0 path: {len(f0_passes)} F0 passes ran")
    del nvc, nrun

    # ---- v1 32 kHz model ---------------------------------------------------
    t0 = time.perf_counter()
    vvc = build_synthetic_converter(tiny=False, sr=32000, version="v1",
                                    index_vectors=65536, engine=eng, device="cuda")
    setup_s = time.perf_counter() - t0
    vrun = drive(vvc, song, opts, wrappers)
    vprofile = profile_convert(vvc, song, opts)
    vrec = Recorder(names=("resblock_group", "conv_transpose"))
    try:
        vvc.convert(song, opts)
    finally:
        vrec.restore()
    v_expected = expected_samples(vvc, song, eng, 32000)
    emit({"phase": "v1_32k", "seconds_audio": SONG_SECONDS, "setup_s": setup_s,
          "upsample_rates": list(vvc.synth_cfg.upsample_rates),
          "upsample_kernel_sizes": list(vvc.synth_cfg.upsample_kernel_sizes),
          "input_dim": vvc.synth_cfg.input_dim, "version": vvc.version,
          **{k: v for k, v in vrun.items() if k != "out"},
          "out_samples": int(vrun["out"].shape[0]), "expected_samples": v_expected,
          "peak_int16": int(np.abs(vrun["out"].astype(np.int32)).max()),
          "profile": {k: v for k, v in vprofile.items() if k != "kernels"},
          "top": vprofile["kernels"][:8], "card": smi})
    check_output(vrun, v_expected, "v1 32 kHz path",
                 launched=(*synth_kernels, "unet_chain"), idle=("viterbi",),
                 sample_rate=32000)
    check_resblock_launches(vrun, "v1 32 kHz path", stages=5)
    check_convt_launches(vrun, "v1 32 kHz path", stages=5)
    check_unet_launches(vrun, "v1 32 kHz path")
    if (vvc.version != "v1" or vvc.synth_cfg.input_dim != 256
            or list(vvc.synth_cfg.upsample_rates) != [10, 4, 2, 2, 2]
            or list(vvc.synth_cfg.upsample_kernel_sizes) != [16, 16, 4, 4, 4]):
        raise AssertionError("v1 32 kHz path: not configs/v1/32k.json's model")
    del vvc, vrun

    # ---- conv-transpose and resblock group at the v1_32k inputs ------------
    emit({"phase": "kernels_v1_32k", "detail": check_kernels(vrec.calls),
          **padding_stays_zero(vrec.calls)})
    del vrec

    # ---- reference on a small input ---------------------------------------
    small = dict(x_pad=1, x_query=2, x_center=3, x_max=4, chunk_batch=1,
                 bucket_step_s=2)
    *model, crepe_params, (fcpe_cfg, fcpe_params) = synthetic_params(
        tiny=False, sr=48000, index_vectors=4096, seed=0, with_crepe=True,
        with_fcpe=True)
    names = ("synth_cfg", "synth_params", "hubert_cfg", "hubert_params",
             "rmvpe_params", "index_bank")

    def cpu_noise(seed, ci, shape, n, device):
        eps, nsf = torch_noise(seed, ci, shape, n, torch.device("cpu"))
        return eps.to(device), nsf.to(device)

    small_song = bench_song(2.0)
    convs = {dev: VoiceConverter(**dict(zip(names, model)), device=dev,
                                 engine=EngineConfig(**small, compute_dtype=dtype),
                                 noise_provider=cpu_noise, crepe_params=crepe_params,
                                 fcpe_params=fcpe_params, fcpe_cfg=fcpe_cfg)
             for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32"))}
    _, qbuf, inv_scale, padded_len = highpass_pad_quant(small_song, small["x_pad"] * 16000)
    bufs = {dev: torch.from_numpy(qbuf).to(vc.device).float() * float(inv_scale)
            for dev, vc in convs.items()}
    f0 = {dev: [a.cpu() for a in vc.compute_f0(bufs[dev], opts)]
          for dev, vc in convs.items()}
    coarse_equal = float((f0["cuda"][0] == f0["cpu"][0]).float().mean())
    # mangio-crepe: bf16 conv operands on the card, fp32 on the CPU, the
    # float16 salience on both; tests/test_f0_methods.py's bf16 bounds
    cf0 = {dev: [a.cpu().numpy() for a in vc.compute_f0(bufs[dev], copts, padded_len)]
           for dev, vc in convs.items()}
    p_len = padded_len // 160
    pf_card, pf_cpu = cf0["cuda"][1][:p_len], cf0["cpu"][1][:p_len]
    rel = np.abs(pf_card - pf_cpu) / np.maximum(np.abs(pf_cpu), 1.0)
    d = np.abs(cf0["cuda"][0][:p_len] - cf0["cpu"][0][:p_len])
    crepe_ref = {"frames": p_len, "median_rel": float(np.median(rel)),
                 "share_rel_below_2e-2": float(np.mean(rel < 2e-2)),
                 "coarse_max_abs_diff": int(d.max()),
                 "share_coarse_within_1": float(np.mean(d <= 1)),
                 "voiced_share_cpu": float(np.mean(pf_cpu > 0)),
                 "gates": {"median_rel": 3e-3, "share_rel_below_2e-2": 0.95,
                           "coarse_max_abs_diff": 3, "share_coarse_within_1": 0.95}}
    # fcpe: float32 on both (TF32 off on the card); the bounds of
    # tests/test_f0_methods.py for the JAX package's own two fcpe paths
    ff0 = {dev: [a.cpu().numpy() for a in vc.compute_f0(bufs[dev], fopts, padded_len)]
           for dev, vc in convs.items()}
    pf_card, pf_cpu = ff0["cuda"][1][:p_len], ff0["cpu"][1][:p_len]
    rel = np.abs(pf_card - pf_cpu) / np.maximum(np.abs(pf_cpu), 1.0)
    fcpe_ref = {"frames": p_len, "median_rel": float(np.median(rel)),
                "share_rel_below_1e-2": float(np.mean(rel < 1e-2)),
                "share_coarse_equal": float(np.mean(ff0["cuda"][0][:p_len]
                                                    == ff0["cpu"][0][:p_len])),
                "voiced_share_cpu": float(np.mean(pf_cpu > 0)),
                "gates": {"median_rel": 1e-4, "share_rel_below_1e-2": 0.95,
                          "share_coarse_equal": 0.95}}
    # the rest of the path on one F0, as tests/test_quality.py pins it: the
    # card's bf16-operand U-Net flips near-threshold voicing decisions of a
    # random-weight RMVPE against the CPU's fp32 twin
    renditions = {}
    for dev, vc in convs.items():
        vc.compute_f0 = (lambda buf, o, padded=None, d=vc.device:
                         tuple(a.to(d) for a in f0["cpu"]))
        renditions[dev], _ = vc.convert(small_song, opts)
    dist = mel_distortion_db(renditions["cuda"], renditions["cpu"], 48000)
    del convs

    def card_and_cpu(model, sr, f0_pinned):
        """Both renditions of the small song by one numpy model set; with
        f0_pinned, both on the CPU's F0 pass."""
        vcs = {dev: VoiceConverter(**dict(zip(names, model)), device=dev,
                                   engine=EngineConfig(**small, compute_dtype=dtype),
                                   noise_provider=cpu_noise)
               for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32"))}
        if f0_pinned:
            pinned = [a.cpu() for a in vcs["cpu"].compute_f0(bufs["cpu"], opts)]
            for vc in vcs.values():
                vc.compute_f0 = (lambda buf, o, padded=None, d=vc.device:
                                 tuple(a.to(d) for a in pinned))
        outs = {dev: vc.convert(small_song, opts)[0] for dev, vc in vcs.items()}
        if outs["cuda"].shape != outs["cpu"].shape:
            raise AssertionError(f"{sr} Hz renditions differ in length")
        return mel_distortion_db(outs["cuda"], outs["cpu"], sr)

    nof0_dist = card_and_cpu(synthetic_params(tiny=False, sr=48000, index_vectors=4096,
                                              seed=0, use_f0=False), 48000, False)
    v1_model = synthetic_params(tiny=False, sr=32000, version="v1",
                                index_vectors=4096, seed=0)
    v1_dist = card_and_cpu(v1_model, 32000, True)
    emit({"phase": "reference", "input_s": 2.0, "card_dtype": "bfloat16",
          "cpu_dtype": "float32", "samples": [int(renditions["cuda"].shape[0]),
                                              int(renditions["cpu"].shape[0])],
          "f0_coarse_equal_frac": coarse_equal, "f0_gate": 0.9,
          "mel_distortion_db_same_f0": dist, "gate_db": 0.5,
          "crepe_f0": crepe_ref, "fcpe_f0": fcpe_ref,
          "nof0_mel_distortion_db": nof0_dist,
          "v1_32k_mel_distortion_db_same_f0": v1_dist,
          "script_s_so_far": time.perf_counter() - t_start})
    if renditions["cuda"].shape != renditions["cpu"].shape or not dist < 0.5:
        raise AssertionError(f"card vs CPU reference: {dist} dB")
    if not coarse_equal >= 0.9:
        raise AssertionError(f"card vs CPU coarse F0 agree on {coarse_equal}")
    if not (crepe_ref["median_rel"] < 3e-3 and crepe_ref["share_rel_below_2e-2"] > 0.95
            and crepe_ref["coarse_max_abs_diff"] <= 3
            and crepe_ref["share_coarse_within_1"] > 0.95):
        raise AssertionError(f"card vs CPU mangio-crepe F0: {crepe_ref}")
    if not (fcpe_ref["median_rel"] < 1e-4 and fcpe_ref["share_rel_below_1e-2"] > 0.95
            and fcpe_ref["share_coarse_equal"] > 0.95):
        raise AssertionError(f"card vs CPU fcpe F0: {fcpe_ref}")
    if not (nof0_dist < 0.5 and v1_dist < 0.5):
        raise AssertionError(f"card vs CPU: no-f0 {nof0_dist} dB, v1 32 kHz {v1_dist} dB")

    discriminator_phase(smi)

    sources = {
        "resblock_group": "polgen_rvc_tpu/ops/pallas_resblock.py:176",
        "conv_transpose": "polgen_rvc_tpu/ops/pallas_convtranspose.py:60",
        "band_attention": "polgen_rvc_tpu/ops/flash_relattn.py:128",
        "unet_chain": "polgen_rvc_tpu/ops/pallas_unet2d.py:216",
        "viterbi": "polgen_rvc_tpu/ops/pallas_viterbi.py:137",
    }
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"polgen_rvc_tpu_torch/csrc/{name}.cu",
         "replaces": sources[name], "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name]["library_ms"],
         **({"cudnn_convs_ms": kernels[name]["cudnn_convs_ms"],
             "cudnn_convs_note": "yardstick, not library_ms: the group's 18 convs "
                                 "as bf16 F.conv1d calls at the same shapes, summed "
                                 "over the stages; leaves out the lrelu, residual "
                                 "and mean passes; no one call computes the group "
                                 "and the port never calls it"}
            if name == "resblock_group" else {}),
         **({"cudnn_convs_ms": kernels[name]["cudnn_convs_ms"],
             "cudnn_convs_note": "yardstick, not library_ms: each level's 8 3x3 "
                                 "convs and its 1x1 shortcut as bf16 F.conv2d "
                                 "calls at the same shapes, summed over the 14 "
                                 "levels; leaves out the ReLU and residual "
                                 "passes; no one call computes the chain and "
                                 "the port never calls it"}
            if name == "unet_chain" else {}),
         **({"sdpa_flash_ms": kernels[name]["sdpa_flash_ms"],
             "sdpa_flash_note": "yardstick, not library_ms: flash "
                                "scaled_dot_product_attention on the same bf16 "
                                "q, k, v over each row's valid length, without "
                                "the relative key and value terms, so not this "
                                "function; the port never calls it"}
            if name == "band_attention" else {})}
        for name in wrappers
    ]}
    emit({"phase": "total"})
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--prewarm-child"]:
        sys.exit(prewarm_child(*sys.argv[2:4]))
    sys.exit(main())
