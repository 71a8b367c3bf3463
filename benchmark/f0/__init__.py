"""The F0 models, one module each, found by the name a configuration gives
under ``"f0_model"`` (a configuration with ``"f0": 0`` and no ``f0_model``
takes none). Each module holds the four parts the harness needs of it:

    make_weights(nrm, config)        its published state dict, every value
                                     drawn from the Normals it is given
    program_params(state, config)    the port's VoiceConverter keyword
                                     arguments made from that state dict
    stated_operands(config)          reference.ops.Ops keyword arguments for
                                     the precisions the configuration states
    reference_f0(state, config, buf, padded_len, opts, ops)
                                     the reference's F0 in Hz per frame of the
                                     padded buffer (reference/ holds the plain
                                     model code it calls)
    flops(config, engine, padded_len)
                                     {dtype: operations} of one song's F0 pass,
                                     for mfu

A module whose track no independent reference can reproduce frame for
frame adds the parts that judge its pass stage by stage:

    program_tap(sink)                a context in which the port's pass
                                     appends what it hands its last stage
                                     (CREPE: the salience) to sink
    intermediate(state, config, buf, padded_len, opts, ops)
                                     the reference's counterpart of it
    checks(state, config, buf, padded_len, opts, ops, got_f0, got_mid, frames)
                                     {name: number} of the two stages: the
                                     program's intermediate against the
                                     reference's, and the program's F0
                                     against the reference's last stage run
                                     on the program's intermediate

The module's name is also the key of its state dict in make_weights' set.
A new F0 model is a new module here and its plain reference under
``reference/``; no other file changes."""

from __future__ import annotations

import importlib
import re
from pathlib import Path

_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def find(name: str):
    """The module benchmark/f0/<name>.py; ValueError for any other name."""
    if not isinstance(name, str) or not _NAME.match(name) \
            or not (Path(__file__).parent / f"{name}.py").is_file():
        raise ValueError(f"no F0 model named {name!r} in benchmark/f0/")
    return importlib.import_module(f"{__name__}.{name}")


def model(config: dict):
    """The configuration's F0 module, or None where it names none."""
    name = config.get("f0_model")
    return None if name is None else find(name)
