"""The control of a cell's comparison, run on the card apart from the
benchmark's own runs: the reference put in the program's place, computed
one precision step below the configuration's bf16 (fp8 e4m3 operands,
reference/ops.py), judged as a run judges the program's outputs: its F0
track against the reference's own, or stage by stage where the F0 module
has checks, and its audio against the reference (synthesizing from the
control's F0 track where the configuration's judge takes the program's).
``--operand bf16_decode`` gives the control of the F0 decode instead:
products as stated, the decode's operands in bf16.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--operand fp8|bf16_decode]
        [--program] [--out FILE]

For each seed: the weights and the inputs a run with that seed makes, the
cell's compared sample (the longest item and compare_calls - 1 more drawn
from the seed), the float32 reference and the fp8 control of each, and
the numbers a run compares. Prints one JSON line per seed.

With --program, the program's readings instead, in this one process: a
run of the cell with each seed whose window is one cycle (the judge's
sample drawn from it as a run draws it), its checks printed."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))


def control_readings(workload: str, seed: int, device, operand: str = "fp8") -> dict:
    """The control's readings on the cell's configuration and traffic."""
    from benchmark import spec

    bench = spec.load_benchmark()
    cell = spec.find_workload(bench, workload)
    return {"workload": workload,
            **judge_control(spec.load_config(cell["config"]),
                            spec.load_traffic(cell["traffic"]), seed, device, operand)}


def judge_control(config: dict, traffic: dict, seed: int, device, operand: str = "fp8") -> dict:
    import numpy as np

    from benchmark.f0 import model as f0_model
    from benchmark.reference.convert import padded_buffer, reference_convert, stated_ops
    from benchmark.reference.f0 import f0_mismatch_pct
    from benchmark.reference.melcmp import mel_distortion_parts
    from benchmark.reference.ops import Ops, full_precision
    from benchmark.reference.signal import Engine
    from benchmark.signals import Inputs
    from benchmark.weights import make_weights

    full_precision()
    inputs = Inputs(traffic, seed)
    longest = int(np.argmax(inputs.lengths))
    rest = [i for i in range(len(inputs.items)) if i != longest]
    rng = np.random.default_rng([int(seed), 3])
    n_more = min(int(traffic["compare_calls"]) - 1, len(rest))
    items = [longest] + [rest[k] for k in rng.choice(len(rest), n_more, replace=False)]
    if traffic.get("items_per_call", 1) > 1:
        items = list(range(len(inputs.items)))
    weights = make_weights(config, seed, device)
    sr = config["synthesizer"]["config"][17]
    opts = {**config["options"], "speaker_id": 0}
    engine = Engine(**config["engine"])
    from_program = config.get("judge", {}).get("f0_track") == "program"
    model = f0_model(config)
    per_item, mel_sum, mel_count = [], 0.0, 0
    for i in items:
        x = inputs.signal(i, 0)
        # the control in the program's place, then judged as a run judges
        ctl, ctl_f0 = reference_convert(weights, config, x, opts, seed, device, Ops(operand))
        ref, ref_f0 = reference_convert(weights, config, x, opts, seed, device,
                                        f0_track=ctl_f0 if from_program else None)
        frames = (len(x) + 2 * engine.t_pad) // engine.window
        total, count = mel_distortion_parts(ctl, ref, sr)
        mel_sum, mel_count = mel_sum + total, mel_count + count
        item = {"length_s": inputs.lengths[i], "mel_db": total / count,
                "f0_mismatch_pct": (0.0 if ctl_f0 is None else
                                    f0_mismatch_pct(ctl_f0, ref_f0, frames)),
                "length_diff": abs(len(ctl) - len(ref))}
        if ctl_f0 is not None and hasattr(model, "checks"):
            state = weights[config["f0_model"]]
            buf, padded_len = padded_buffer(x, engine, device)
            mid = model.intermediate(state, config, buf, padded_len, opts, Ops(operand))
            item.update(model.checks(state, config, buf, padded_len, opts, stated_ops(config),
                                     ctl_f0, mid, frames))
        per_item.append(item)
    names = [k for k in per_item[0] if k not in ("length_s", "mel_db")]
    return {"seed": seed, "operand": operand, "mel_db": mel_sum / mel_count,
            **{k: max(p[k] for p in per_item) for k in names},
            "items": per_item}


def program_readings(workload: str, seed: int) -> dict:
    """One run of the cell with a one-cycle window: its compared numbers."""
    import time

    from benchmark import harness, spec

    bench = spec.load_benchmark()
    cell = spec.find_workload(bench, workload)
    result = harness.run_cell(
        workload, bench=bench, config=spec.load_config(cell["config"]),
        traffic=spec.load_traffic(cell["traffic"]), limits=spec.load_limits(workload),
        seed=seed, seconds=0.0, trace=False, device="cuda", process_start=time.time())
    return {"workload": workload, "seed": seed, "program": True,
            "correct": result["correct"],
            **{k: v["value"] for k, v in result["checks"].items()}}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--operand", default="fp8", choices=("fp8", "bf16_decode"))
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        line = (program_readings(args.workload, seed) if args.program
                else control_readings(args.workload, seed, torch.device("cuda", 0),
                                      args.operand))
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
