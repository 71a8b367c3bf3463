"""Tests of the benchmark harness. CPU tests run anywhere; tests marked
``cuda`` need a card and skip without one (decided in the ``card``
fixture, never at import). Run: python -m pytest benchmark/tests"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """The tiny-width configuration and its traffic mixes."""
    with open(DATA / "tiny_rmvpe.json") as f:
        config = json.load(f)
    mixes = {}
    for name in ("tiny_clips", "tiny_songs"):
        with open(DATA / f"{name}.json") as f:
            mixes[name] = json.load(f)
    return config, mixes


@pytest.fixture
def tiny_v1():
    """The tiny widths at RVC v1 32 kHz's decoder rates."""
    with open(DATA / "tiny_v1_rmvpe.json") as f:
        return json.load(f)
