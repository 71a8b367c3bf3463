"""BENCHMARK.json and the files the harness finds by name."""

import json
import math
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_finds_its_parts_by_name(bench):
    for cell in bench["workloads"]:
        config = spec.load_config(cell["config"])
        traffic = spec.load_traffic(cell["traffic"])
        limits = spec.load_limits(cell["name"])
        # a published RVC config: 100 frames a second at every published rate,
        # upsampled by the product of the decoder's rates
        rate, up_rates = config["synthesizer"]["config"][17], config["synthesizer"]["config"][12]
        assert rate in (32000, 40000, 48000)
        assert rate == 100 * math.prod(up_rates)
        assert traffic["entry"] in ("convert", "convert_batch")
        assert {"mel_db", "length_diff"} <= set(limits)
        for m in spec.metrics_for(bench, cell["name"], "per_layer"):
            assert callable(spec.load_metric(m["name"]).read)
        assert cell["chips"] == 1


def test_metrics_for_keeps_cell_lists(bench):
    e2e = {m["name"] for m in spec.metrics_for(bench, "v2_48k_rmvpe.songs", "end_to_end")}
    assert e2e == {"rtf", "setup_s"}
    e2e = {m["name"] for m in spec.metrics_for(bench, "v2_48k_rmvpe.clips", "end_to_end")}
    assert e2e == {"rtf", "latency_p95_s", "setup_s"}
    layers = {m["name"] for m in spec.metrics_for(bench, "v2_48k_crepe.songs", "per_layer")}
    assert "viterbi_roofline" in layers and "unet_roofline" not in layers
    v2 = {m["name"] for m in spec.metrics_for(bench, "v2_48k_rmvpe.songs", "per_layer")}
    v1 = {m["name"] for m in spec.metrics_for(bench, "v1_32k_rmvpe.songs", "per_layer")}
    assert v1 == v2


def test_contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    cells = {w["name"] for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + list(cells) + list(used):
        assert NAME.match(name), name
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert m["moves"] == "rtf" and set(m["workloads"]) <= cells
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert spec.load_config(c["name"])["reduced"] == c["reduced"]
