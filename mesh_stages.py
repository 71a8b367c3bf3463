#!/usr/bin/env python3
"""Where a mesh's output parts from the unsharded converter's on one card,
and what a wrong mesh reads.

    python3 mesh_stages.py [--out build/mesh_stages.json]
    python3 mesh_stages.py --sweep [--sweep-out build/mesh_sweep.json] [--buckets 12,16]

The full-width 48 kHz v2 model, bf16 engine, options and 60 s song of
chip_smoke.py's main path, and its batch phase's four songs cut from it
(convert_batch packs them into three chunk batches of two rows; the
first is also the 60 s song's convert batch). On a data mesh whose shards
all name cuda:0, a data shard runs a batch's rows apart; this script
takes each packed batch apart the same way:

  ops:    the batch's row work (``_shard_rows``: HuBERT, retrieval, protect,
          synthesizer, trim) once on both rows and once on each row alone
          (the rows of a 2x1 mesh), under a torch function mode that
          fingerprints every call's output bit for bit and keeps the small
          ones. For each row, the first calls whose row differs between the
          two runs, with the port's calling line and the largest
          difference, and the number of differing calls in each module.
  hubert: each HuBERT layer's output for each row alone against the
          two-row unsharded batch.
  reads:  int16 differences (largest, share of samples) and mel distortion
          against the unsharded converter's output, for the 2x1 mesh
          (convert of the song and, for the f0 model, convert_batch of the
          batch phase's songs), for the main and the no-f0 model, each
          beside a wrong mesh whose rows' noise is drawn from another seed.
          chip_smoke.py's mesh phase holds the 2x1 mesh byte for byte.
  sweep:  (--sweep, alone) the ops comparison at every bucket class of the
          engine's grid (4 s steps up to max_bucket_len), for the main
          model and the no-f0 model: one packed two-row batch a bucket,
          its rows cut from the song (row 0 half a second short of the
          bucket, row 1 three quarters of it from the song's middle), each
          row run alone as a 2x1 mesh's data shard runs it. Every call
          whose row differs is listed with the port's calling lines; a
          call whose row inputs are equal in both runs and whose output
          is not is a root: the row count alone changed its bytes (one
          with no input on the batch's rows, such as the reshape after a
          kernel that runs on rows x heads, is "unanchored").

Prints one JSON line and writes it to --out (--sweep-out), with the
nvidia-smi name and power limit. Checks nothing: chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import collections
import difflib
import json
import os
import subprocess
import sys
import traceback

import torch
from torch.overrides import TorchFunctionMode

from chip_smoke import BENCH_OPTS, BENCH_TIERS, SONG_SECONDS, bench_song

PORT = os.path.join("polgen_rvc_tpu_torch", "")
SONG_CUTS = (60, 41, 23, 9)  # the batch phase's songs, cut from the 60 s song
KEEP_BYTES = 64 << 20  # outputs kept whole for their largest difference
# allocations whose bytes a kernel writes later: nothing to compare yet
UNWRITTEN = {"empty", "empty_like", "new_empty", "empty_strided"}
BIT_VIEWS = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
             torch.float32: torch.int32, torch.float64: torch.int64}


def port_stack(depth: int = 3) -> list:
    """The innermost `depth` calling lines inside the port's package,
    innermost first, one line a file in a row (a call inside ops/conv.py's
    wrappers shows as the wrapper's line, then its caller's)."""
    lines = []
    for frame in reversed(traceback.extract_stack()[:-2]):
        if PORT in frame.filename:
            path = frame.filename.split(PORT, 1)[1]
            if lines and lines[-1].startswith(path + ":"):
                continue
            lines.append(f"{path}:{frame.lineno}")
            if len(lines) == depth:
                break
    return lines or ["?"]


def fingerprint(t: torch.Tensor) -> torch.Tensor:
    """(rows,) int64: a weighted sum of each row's bits, equal for equal
    rows and almost surely unequal otherwise."""
    bits = t.view(BIT_VIEWS[t.dtype]) if t.dtype in BIT_VIEWS else t
    flat = bits.reshape(t.shape[0], -1).to(torch.int64)
    weights = torch.arange(1, flat.shape[1] + 1, device=t.device, dtype=torch.int64)
    return (flat * (weights * 2654435761 % 1000003)).sum(dim=1)


def row_tensor(t, rows) -> bool:
    """A tensor whose first axis is a batch of one of the counts in `rows`,
    with bits to fingerprint."""
    return (isinstance(t, torch.Tensor) and t.dim() > 0 and t.shape[0] in rows
            and t.numel() > 0 and not t.is_complex() and t.dtype != torch.bool)


class Tape(TorchFunctionMode):
    """Every torch call's tensor output whose first axis is one of the row
    counts `rows` (a batch's rows, and the count a call pads them to): its
    name, port lines, per-row fingerprint and, when small, a copy; and the
    per-row fingerprints of its tensor arguments with such rows."""

    def __init__(self, *rows: int):
        super().__init__()
        self.rows = rows
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [t for a in (*args, *kwargs.values())
                for t in (a if isinstance(a, (list, tuple)) else (a,))]
        # taken before the call (an in-place call overwrites its input); None
        # for a tensor without the batch's rows, such as a weight
        in_fp = [fingerprint(t.detach()) if row_tensor(t, self.rows) else None
                 for t in flat if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        stack = port_stack()
        entry = {"name": name, "site": stack[0], "stack": stack}
        if name not in UNWRITTEN and row_tensor(out, self.rows):
            entry["in_fp"] = in_fp
            entry["shape"] = list(out.shape)
            entry["dtype"] = str(out.dtype).replace("torch.", "")
            entry["fp"] = fingerprint(out.detach())
            if out.numel() * out.element_size() <= KEEP_BYTES:
                entry["copy"] = out.detach().clone()
        self.calls.append(entry)
        return out


def rows_of(inputs: dict, r: int) -> dict:
    return {k: None if v is None else v[r:r + 1] for k, v in inputs.items()}


def capture_batches(vc, songs, opts):
    """Each packed chunk batch's _shard_rows arguments during a
    convert_batch of songs."""
    seen = []
    real = type(vc)._shard_rows

    def grab(shard, inp, *rest):
        seen.append((shard, inp, rest))
        return real(vc, shard, inp, *rest)

    vc._shard_rows = grab
    try:
        vc.convert_batch(songs, opts)
    finally:
        del vc._shard_rows
    return seen


def token(call) -> tuple:
    """What aligns a call of one run with its counterpart in the other: its
    name, port lines and, for a fingerprinted output, its shape past the
    rows."""
    return call["name"], tuple(call["stack"]), tuple(call.get("shape", [0])[1:])


def op_diff(vc, shard, inp, rest) -> dict:
    """Row r of the two-row run against row r run alone, call by call; a
    call that pads the lone row to chunk_batch rows (ops/conv.py:at_rows)
    is compared on its first row."""
    with Tape(2) as both:
        vc._shard_rows(shard, inp, *rest)
    result = {"calls_two_rows": len(both.calls), "rows": []}
    for r in range(2):
        with Tape(1, vc.engine.chunk_batch) as alone:
            vc._shard_rows(shard, rows_of(inp, r), *rest)
        tokens = [token(c) for c in both.calls], [token(c) for c in alone.calls]
        blocks = difflib.SequenceMatcher(None, *tokens, autojunk=False).get_matching_blocks()
        pairs = [(both.calls[i + k], alone.calls[j + k]) for i, j, n in blocks
                 for k in range(n)]
        first, by_module, compared = [], collections.Counter(), 0
        sites, roots, unanchored = (collections.Counter() for _ in range(3))
        for a, b in pairs:
            if "fp" not in a or "fp" not in b:
                continue
            if a["shape"][1:] != b["shape"][1:]:
                continue
            compared += 1
            if int(a["fp"][r]) == int(b["fp"][0]):
                continue
            by_module[a["site"].split(":")[0]] += 1
            where = f"{a['name']} @ {' < '.join(a['stack'])}"
            sites[where] += 1
            pairs_in = [(x, y) for x, y in zip(a["in_fp"], b["in_fp"])
                        if x is not None and y is not None]
            is_root = False
            if len(a["in_fp"]) != len(b["in_fp"]) or not pairs_in:
                unanchored[where] += 1
            elif all(int(x[r]) == int(y[0]) for x, y in pairs_in):
                roots[where] += 1
                is_root = True
            if len(first) < 12:
                item = {"name": a["name"], "stack": a["stack"], "shape": b["shape"],
                        "dtype": b["dtype"], "root": is_root}
                if "copy" in a and "copy" in b:
                    d = (a["copy"][r:r + 1].double() - b["copy"][:1].double()).abs()
                    item["max_abs_diff"] = float(d.max())
                    item["share_differing"] = float((d > 0).double().mean())
                    item["max_abs"] = float(b["copy"][:1].double().abs().max())
                first.append(item)
        result["rows"].append({"row": r, "calls_alone": len(alone.calls),
                               "aligned_calls": len(pairs),
                               "compared": compared,
                               "differing": sum(by_module.values()),
                               "differing_by_module": dict(by_module),
                               "roots": dict(roots),
                               "unanchored": dict(unanchored),
                               "differing_calls": dict(sites),
                               "first_differing": first})
    return result


def sweep_batch(vc, prep, bucket: int, opts):
    """A packed two-row batch at `bucket` samples, its rows cut from the
    prepared song prep: row 0 from the start, half a second short of the
    bucket; row 1 from the middle, three quarters of the bucket. Returns
    _shard_rows's (shard, inputs, rest) for it."""
    from polgen_rvc_tpu_torch.pipeline.chunking import Chunk

    eng = vc.engine
    w = eng.window
    lens = (bucket - eng.sample_rate // 2, bucket * 3 // 4 // w * w)
    mid = (prep.buf.shape[0] - lens[1]) // 2 // w * w
    chunks = [Chunk(0, 0, start, start + n) for start, n in zip((0, mid), lens)]
    if chunks[1].slice_end > prep.buf.shape[0]:
        raise ValueError(f"a {bucket}-sample bucket's rows do not fit the song")
    p_len = min(bucket // w, 2 * vc.hubert_cfg.num_frames(bucket))
    rows = vc._assemble_rows([(c, ci, prep.buf, prep.pitch, prep.pitchf)
                              for ci, c in enumerate(chunks)], p_len)
    inp = vc._batch_inputs(rows, bucket, p_len)
    use_f0 = vc.synth_cfg.use_f0
    rest = (bucket, p_len, opts, vc.index_bank is not None and opts.index_rate > 0,
            use_f0 and opts.protect < 0.5)
    return vc._data_shards()[0], inp, rest


def sweep(eng, song, opts, buckets_s=None) -> dict:
    """op_diff at every bucket class of the engine's grid (or at buckets_s,
    in seconds), for the main model and the no-f0 model: per bucket, its
    enc_p frames and each row's differing calls and roots."""
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

    step = eng.bucket_step_s * eng.sample_rate
    buckets = (range(step, eng.max_bucket_len + 1, step) if buckets_s is None
               else [int(b) * eng.sample_rate for b in buckets_s])
    out = {}
    for model, use_f0 in (("f0", True), ("nof0", False)):
        vc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                                       engine=eng, device="cuda", use_f0=use_f0)
        with torch.inference_mode():
            prep = vc._prepare_song(song, opts)
            entries = []
            for bucket in buckets:
                shard, inp, rest = sweep_batch(vc, prep, bucket, opts)
                diff = op_diff(vc, shard, inp, rest)
                entries.append({
                    "bucket_s": bucket / eng.sample_rate, "enc_p_frames": rest[1],
                    "calls_two_rows": diff["calls_two_rows"],
                    "rows": [{k: row[k] for k in ("row", "compared", "differing", "roots",
                                                  "unanchored", "differing_calls",
                                                  "first_differing")}
                             for row in diff["rows"]]})
                del shard, inp, diff
        out[model] = entries
        del vc, prep
        torch.cuda.empty_cache()
    return out


def hubert_layers(vc, inp, bucket) -> dict:
    """Per layer, max |difference| of each row's features alone against the
    two-row batch."""
    from polgen_rvc_tpu_torch.models.hubert import hubert_extract

    cfg, dev = vc.hubert_cfg, vc.device

    def feats(sl, layer):
        hub_pad = (torch.arange(cfg.num_frames(bucket), device=dev)[None, :]
                   >= inp["hub_valid"][sl][:, None])
        return hubert_extract(vc.hubert_params, cfg, inp["wav"][sl], output_layer=layer,
                              compute_dtype=vc.compute_dtype, padding_mask=hub_pad,
                              valid_samples=inp["samp_lens"][sl],
                              rows=vc.engine.chunk_batch).float()

    out = []
    for layer in range(1, cfg.n_layers + 1):
        two = feats(slice(0, 2), layer)
        entry = {"layer": layer, "max_abs": float(two.abs().max())}
        for r in range(2):
            sl = slice(r, r + 1)
            entry[f"row{r}_vs_batch"] = float((feats(sl, layer) - two[sl]).abs().max())
        out.append(entry)
    return {"layers": out}


def reads(song, opts) -> dict:
    from chip_smoke import compare
    from polgen_rvc_tpu_torch.parallel import make_mesh
    from polgen_rvc_tpu_torch.pipeline.config import EngineConfig
    from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter, torch_noise
    from polgen_rvc_tpu_torch.pipeline.factory import synthetic_params

    eng = EngineConfig(**BENCH_TIERS, compute_dtype="bfloat16")
    names = ("synth_cfg", "synth_params", "hubert_cfg", "hubert_params",
             "rmvpe_params", "index_bank")
    songs = [song[:s * eng.sample_rate] for s in SONG_CUTS]

    def other_seed(seed, chunk_id, *rest):
        return torch_noise(seed + 1, chunk_id, *rest)

    def build(model, n_data=None, noise=torch_noise):
        mesh = None if n_data is None else make_mesh(n_data, devices=["cuda:0"] * n_data)
        return VoiceConverter(**dict(zip(names, model)), engine=eng,
                              device=None if mesh else "cuda:0", mesh=mesh,
                              noise_provider=noise)

    out = {}
    for model_name, use_f0 in (("f0", True), ("nof0", False)):
        model = synthetic_params(tiny=False, sr=48000, index_vectors=65536, seed=0,
                                 use_f0=use_f0)
        ref_vc = build(model)
        ref = ref_vc.convert(song, opts)[0]
        ref_batch = ref_vc.convert_batch(songs, opts) if use_f0 else None
        del ref_vc
        runs = {"2x1": lambda: build(model, 2),
                "2x1_wrong_noise": lambda: build(model, 2, other_seed)}
        for label, make in runs.items():
            vc = make()
            entry = {"convert": compare(vc.convert(song, opts)[0], ref, 48000)}
            if use_f0:
                entry["batch"] = [compare(o, r, 48000) for (o, _), (r, _)
                                  in zip(vc.convert_batch(songs, opts), ref_batch)]
            out[f"{model_name}_{label}"] = entry
            del vc
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "mesh_stages.json"))
    ap.add_argument("--sweep", action="store_true",
                    help="only the ops comparison at every bucket class")
    ap.add_argument("--sweep-out", default=os.path.join("build", "mesh_sweep.json"))
    ap.add_argument("--buckets", help="the sweep's bucket classes in seconds, comma "
                                      "separated (default: the engine's whole grid)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_stages.py needs a CUDA device", file=sys.stderr)
        return 1
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    eng = EngineConfig(**BENCH_TIERS, compute_dtype="bfloat16")
    song = bench_song(SONG_SECONDS)
    opts = ConversionOptions(**BENCH_OPTS)
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    if args.sweep:
        buckets = None if args.buckets is None else args.buckets.split(",")
        return write(args.sweep_out, {**result, "sweep": sweep(eng, song, opts, buckets)})
    vc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                                   engine=eng, device="cuda")
    songs = [song[:s * eng.sample_rate] for s in SONG_CUTS]
    vc.convert_batch(songs, opts)
    result["batches"] = []
    for shard, inp, rest in capture_batches(vc, songs, opts):
        result["batches"].append({"rows": int(inp["wav"].shape[0]), "bucket": rest[0],
                                  "ops": op_diff(vc, shard, inp, rest),
                                  "hubert": hubert_layers(vc, inp, rest[0])})
    del vc, shard, inp
    torch.cuda.empty_cache()
    result["reads"] = reads(song, opts)
    return write(args.out, result)


def write(path: str, result: dict) -> int:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
