"""One run of one cell: set-up, the timed window, the traced window, the
comparison with the reference, and the result line.

Set-up (``setup_s``, from process start to the first timed call): the
weights from the seed on the device, the port's conversions into its
``VoiceConverter``, the inputs from the seed, and ``prewarm`` once for
each item of the cell's cycle. The raw weights are dropped before the
program's memory peak is reset.

The window: one client in a closed loop, the next call sent when the
previous one has returned its int16 audio. Calls go out cycle by cycle,
each cycle every item of the mix once in an order shuffled by the seed;
the window ends with the first whole cycle that completes after
``seconds``, so every seed sends the same work. No kernel library may be
built or loaded inside it.

With ``trace``, a traced window follows: whole cycles under
torch.profiler, until it has lasted TRACE_SECONDS, with ranges around the
engine's phases (trace.py). The per-layer metrics are read
from it, and ``mfu`` from the timed window.

Then the program is freed, the weights are made again from the seed, and
the reference converts a sample of the timed window's calls, drawn from
the seed with the longest call in it; each output is held to the cell's
limits (``limits/<workload>.json``)."""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
import types

import numpy as np

from . import f0, program, spec
from .reference.convert import padded_buffer, reference_convert, stated_ops
from .reference.f0 import f0_mismatch_pct
from .reference.melcmp import mel_distortion_parts
from .reference.ops import full_precision
from .reference.signal import Engine
from .signals import Inputs
from .weights import make_weights
from .work import Window, call_geometry, song_geometry

TRACE_SECONDS = 5.0   # the traced window's least length
FORBIDDEN = ("jax", "jaxlib", "flax", "polgen_rvc_tpu")
GENERIC_CHECKS = {"mel_db", "f0_mismatch_pct", "length_diff"}


class Failure(RuntimeError):
    """A run that cannot report: it prints no result and exits non-zero."""


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not hold, compared
    whole (polgen_rvc_tpu_torch is the port and allowed)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cycles(vc, inputs, traffic, opts, device, seconds, reps, tap=None):
    """Whole cycles of calls until `seconds` have passed; returns the calls
    [(items, reps, start, end, outputs or None, F0 taps)] and the wall
    seconds. With tap (the configuration), each call keeps, for the judge,
    what its songs' F0 passes made (program.f0_tap): per song the F0 track
    and the F0 module's intermediate."""
    call = program.entry(vc, traffic["entry"])
    calls, sink = [], []
    with program.f0_tap(sink, tap) if tap is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        while True:
            for group in inputs.cycle():
                songs = [inputs.signal(i, reps[i]) for i in group]
                used = [reps[i] for i in group]
                for i in group:
                    reps[i] += 1
                t1 = time.perf_counter()
                try:
                    out = call(songs, opts)
                except Exception as exc:  # a failed call counts against the run
                    print(f"call failed: {type(exc).__name__}: {exc}", file=sys.stderr)
                    out = None
                calls.append((list(group), used, t1, time.perf_counter(), out, sink[:]))
                sink.clear()
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t0
    return calls, wall


def _power_limit(device):
    """The card's power limit in W (nvidia-smi), None where it cannot be read."""
    import subprocess

    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", str(device.index)],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _geometry(inputs, calls, engine, packed) -> list:
    return [call_geometry([song_geometry(inputs.signal(i, r), engine)
                           for i, r in zip(items, used)], engine, packed)
            for items, used, *_ in calls]


def run_cell(workload: str, *, bench: dict, config: dict, traffic: dict, limits: dict,
             seed: int, seconds: float, trace: bool, device, process_start: float) -> dict:
    """The result line of one run (a dict, keys in their printed order)."""
    import torch

    full_precision()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    engine = Engine(**config["engine"])
    packed = traffic["entry"] == "convert_batch"

    # ---------------- set-up ----------------
    marks = [("start", time.time() - process_start)]
    torch.zeros(1, device=device)
    _sync(device)
    marks.append(("device", time.time() - process_start))
    weights = make_weights(config, seed, device)
    _sync(device)
    marks.append(("weights", time.time() - process_start))
    vc = program.build_converter(weights, config, device)
    del weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("converter", time.time() - process_start))
    inputs = Inputs(traffic, seed)
    opts = program.conversion_options(config, seed)
    marks.append(("inputs", time.time() - process_start))
    for i in range(len(inputs.items)):
        vc.prewarm(inputs.signal(i, -1), opts)
    _sync(device)
    counts = program.kernel_counts()
    gc.collect()
    gc.freeze()   # set-up's objects stay out of the window's collections
    setup_s = time.time() - process_start
    marks.append(("prewarm", setup_s))
    print("set-up (s since process start): " + ", ".join(f"{k} {v:.2f}" for k, v in marks)
          + f"; kernel libraries {counts}", file=sys.stderr)

    # ---------------- the timed window ----------------
    reps = [0] * len(inputs.items)
    calls, wall = _cycles(vc, inputs, traffic, opts, device, seconds, reps, tap=config)
    if program.kernel_counts() != counts:
        raise Failure(f"kernel libraries built or loaded inside the window: "
                      f"{counts} -> {program.kernel_counts()}")
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    failed, attempted = sum(c[4] is None for c in calls), len(calls)
    audio_s = sum(inputs.lengths[i] for items, *_ in calls for i in items)
    latencies = [c[3] - c[2] for c in calls]
    end_to_end = {"rtf": audio_s / wall,
                  "latency_p95_s": float(np.percentile(latencies, 95)),
                  "setup_s": setup_s}

    # ---------------- the traced window ----------------
    breakdown = dev_trace = None
    per_layer = {}
    if trace:
        from . import trace as tr

        timed = Window(_geometry(inputs, calls, engine, packed), wall)
        traced_calls, traced_wall, dev_trace = _traced(vc, inputs, traffic, opts, device,
                                                       TRACE_SECONDS, reps)
        # what a per-layer reader reads: the configuration, its engine, the
        # reduced trace, and the timed and traced windows' call geometry
        ctx = types.SimpleNamespace(
            config=config, engine=engine, trace=dev_trace, window=timed,
            traced=Window(_geometry(inputs, traced_calls, engine, packed), traced_wall))
        for m in spec.metrics_for(bench, workload, "per_layer"):
            value = spec.load_metric(m["name"]).read(ctx)
            if value is not None:
                per_layer[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = {"device_ops": tr.kernel_breakdown(dev_trace),
                     "idle_gaps": tr.gap_breakdown(dev_trace)}
        phase_ns = {p: dev_trace.kernel_ns(phase=p) for p in tr.PHASES}
        print(f"trace: {len(dev_trace.kernels)} kernels, {dev_trace.unattributed} "
              f"launched outside the phases; kernel s by phase "
              f"{ {p: v * 1e-9 for p, v in phase_ns.items()} } of "
              f"{dev_trace.kernel_ns() * 1e-9:.3f} s", file=sys.stderr)
        failed += sum(c[4] is None for c in traced_calls)
        attempted += len(traced_calls)

    found = forbidden_modules()
    if found:
        raise Failure(f"modules that must not load: {found}")

    # ---------------- the comparison ----------------
    del vc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = compare(calls, inputs, config, traffic, limits, seed, device)
    print(f"window: {len(calls)} calls, {audio_s:.0f} s of audio in {wall:.2f} s; "
          f"reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        metrics = per_layer
    else:
        metrics = {m["name"]: {"value": end_to_end[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_for(bench, workload, "end_to_end")}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = dev_trace.busy_ns() * 1e-9
        dev["window_s"] = (dev_trace.span[1] - dev_trace.span[0]) * 1e-9
        # the shares of the peaks (mfu, rooflines) assume 700 W
        dev["power_limit_w"] = _power_limit(device)
        print(f"power limit: {dev['power_limit_w']} W", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _traced(vc, inputs, traffic, opts, device, seconds, reps):
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as tr

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tr.phase_ranges(program.converter_class()):
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW_RANGE):
                calls, wall = _cycles(vc, inputs, traffic, opts, device, seconds, reps)
    return calls, wall, tr.reduce_events(prof.profiler.kineto_results.events())


def compare(calls, inputs, config, traffic, limits, seed, device) -> dict:
    """The judge, over a sample of the window's calls: the call with the
    most audio, and traffic["compare_calls"] - 1 more drawn from the seed.
    Each song is converted by the reference; where the configuration's
    judge says "f0_track": "program", the reference's synthesizer reads
    the F0 track the program's pass made (a random-weight RMVPE's argmax
    is decided by rounding, reference/convert.py) and the F0 pass is judged
    by itself, or, where the F0 module has checks of its own, stage by
    stage (f0/__init__.py). The numbers the cell's limits name, each the
    worst over the songs, beside its limit:
      mel_db          mel distortion (dB) of the program's int16 output
                      against the reference's
      f0_mismatch_pct frames (%) where the program's F0 and the
                      reference's disagree: voicing, or > 50 cents
      length_diff     largest difference in output samples
    and the F0 module's checks (CREPE: salience_rel_err,
    f0_decode_cents_max)."""
    done = [k for k, c in enumerate(calls) if c[4] is not None]
    worst = dict.fromkeys(limits, 0.0 if done else float("inf"))
    if done:
        longest = max(done, key=lambda k: sum(inputs.lengths[i] for i in calls[k][0]))
        rest = [k for k in done if k != longest]
        rng = np.random.default_rng([int(seed), 3])
        n_more = min(int(traffic["compare_calls"]) - 1, len(rest))
        picked = [longest] + [rest[k] for k in rng.choice(len(rest), n_more, replace=False)]
        weights = make_weights(config, seed, device)
        engine = Engine(**config["engine"])
        sr = config["synthesizer"]["config"][17]
        opts = {**config["options"], "speaker_id": 0}
        from_program = config.get("judge", {}).get("f0_track") == "program"
        model = f0.model(config)
        stages = getattr(model, "checks", None)
        mel_sum = mel_count = 0.0
        for k in picked:
            items, used, _, _, outs, taps = calls[k]
            for i, r, got, (f0_track, mid) in zip(items, used, outs, taps):
                x = inputs.signal(i, r)
                ref, ref_f0 = reference_convert(weights, config, x, opts, seed, device,
                                                f0_track=f0_track if from_program else None)
                total, count = mel_distortion_parts(got, ref, sr)
                mel_sum, mel_count = mel_sum + total, mel_count + count
                worst["length_diff"] = max(worst["length_diff"], float(abs(len(ref) - len(got))))
                frames = (len(x) + 2 * engine.t_pad) // engine.window
                if "f0_mismatch_pct" in limits:
                    worst["f0_mismatch_pct"] = max(worst["f0_mismatch_pct"],
                                                   f0_mismatch_pct(f0_track, ref_f0, frames))
                if stages is not None:
                    if mid is None:   # the pass handed its last stage nothing the tap caught
                        found = dict.fromkeys(set(limits) - GENERIC_CHECKS, float("inf"))
                    else:
                        buf, padded_len = padded_buffer(x, engine, device)
                        found = stages(weights[config["f0_model"]], config, buf, padded_len,
                                       opts, stated_ops(config), f0_track, mid, frames)
                    for name, value in found.items():
                        if name in limits:
                            worst[name] = max(worst[name], value)
        worst["mel_db"] = mel_sum / mel_count
    return {name: {"value": value, "limit": limits[name]["limit"]}
            for name, value in worst.items()}


def print_result(result: dict, out=sys.stdout, err=sys.stderr):
    """The checks as the last lines on stderr, then the result line."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
