#!/usr/bin/env python3
"""Drive the PyTorch port once on one CUDA card and check it.

    python3 chip_smoke.py

It drives five paths: rmvpe+ (the main path), mangio-crepe, fcpe, a no-f0
model and a v1 32 kHz model, and holds each of the five kernels against
its plain twin. Phases, each printing one JSON line (any failure raises;
exit code != 0):
  1. card:     nvidia-smi name and power limit, torch/CUDA versions, the
               parallel nvcc build of every kernel from csrc/ and its time.
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
               The output must have the planned length and not be silent.
  profile:     one more convert under torch.profiler: the device's busy
               and idle share of the wall time, and kernels by device time.
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
Then the {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def bench_song(seconds: float) -> np.ndarray:
    """bench.py's synthetic song: vibrato sine + octave + light noise."""
    rng = np.random.default_rng(0)
    sr = 16000
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


def drive(vc, song, opts, wrappers: dict) -> dict:
    """One warm-up convert; then every kernel's launch count set to 0, one
    timed convert, the counts read. Returns its numbers and output. Peak
    memory: max_memory_allocated counts whatever the script still holds
    on the card (the main path's recorded kernel inputs, once recorded);
    peak_own_bytes counts only this converter's weights and the convert."""
    import torch

    t0 = time.perf_counter()
    vc.convert(song, opts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for fn in wrappers.values():
        fn.launches = 0
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
            "launches": {name: fn.launches for name, fn in wrappers.items()},
            "out": out, "sr": sr}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "ptxas": ptxas})

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
    del vc, run

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
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
