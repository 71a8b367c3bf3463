"""The TF32 control of a float32 F0 pass: the port's own pass run with
TF32 on (cuBLAS and cuDNN round float32 operands to TF32's 10-bit
mantissa), judged by the F0 module's stage checks as a run judges the
program's pass. A configuration that states float32 must read over a
limit here: the precision below the stated one.

    python3 benchmark/tf32_control.py --workload <name> --seeds 1,2,3 [--out FILE]

For each seed: the weights and inputs a run with that seed makes, the
cell's compared sample (the longest item and compare_calls - 1 more
drawn from the seed, as control.py draws them), and for each song the
checks of the port's pass with TF32 on and, beside them, with it off as
the port runs. Prints one JSON line per seed. Needs a card."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))


def _tf32(on: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def tf32_readings(workload: str, seed: int, device) -> dict:
    import numpy as np

    from benchmark import f0, program, spec
    from benchmark.reference.convert import padded_buffer, stated_ops
    from benchmark.reference.ops import full_precision
    from benchmark.reference.signal import Engine
    from benchmark.signals import Inputs
    from benchmark.weights import make_weights

    cell = spec.find_workload(spec.load_benchmark(), workload)
    config, traffic = spec.load_config(cell["config"]), spec.load_traffic(cell["traffic"])
    model = f0.model(config)
    if not hasattr(model, "checks"):
        raise SystemExit(f"{workload}: its F0 model has no stage checks")
    full_precision()
    inputs = Inputs(traffic, seed)
    longest = int(np.argmax(inputs.lengths))
    rest = [i for i in range(len(inputs.items)) if i != longest]
    rng = np.random.default_rng([int(seed), 3])
    n_more = min(int(traffic["compare_calls"]) - 1, len(rest))
    items = [longest] + [rest[k] for k in rng.choice(len(rest), n_more, replace=False)]
    weights = make_weights(config, seed, device)
    vc = program.build_converter(weights, config, device)
    opts = program.conversion_options(config, seed)
    ref_opts = {**config["options"], "speaker_id": 0}
    engine = Engine(**config["engine"])
    state = weights[config["f0_model"]]
    per_item = []
    for i in items:
        x = inputs.signal(i, 0)
        buf, padded_len = padded_buffer(x, engine, device)
        frames = (len(x) + 2 * engine.t_pad) // engine.window
        item = {"length_s": inputs.lengths[i]}
        for name, on in (("tf32", True), ("fp32", False)):
            sink = []
            _tf32(on)
            try:
                with program.f0_tap(sink, config):
                    vc._prepare_song(x, opts)
            finally:
                full_precision()
            pitchf, mid = sink[-1]
            found = model.checks(state, config, buf, padded_len, ref_opts, stated_ops(config),
                                 pitchf, mid, frames)
            item.update({f"{name}.{k}": v for k, v in found.items()})
        per_item.append(item)
    names = [k for k in per_item[0] if k != "length_s"]
    return {"workload": workload, "seed": seed, "operand": "tf32",
            **{k: max(p[k] for p in per_item) for k in names}, "items": per_item}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = tf32_readings(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
