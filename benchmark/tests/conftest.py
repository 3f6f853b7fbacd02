"""Shared fixtures of the benchmark's own tests (CPU unless marked gpu)."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# tiny sizes of each configuration for the CPU; widths other than these stay
TINY = {
    "hand_r101": dict(stage_sizes=[1, 1, 1, 1], image_size=64, heatmap_size=16, batch=4,
                      num_keypoints=5),
    "adain_vgg19": dict(image_size=32, batch=2),
}
# the program in float32 on the CPU, so that a sound run meets the cell's limits
FLOAT32 = {"hand_r101": dict(precision="float32", style_dtype="float32",
                             style_io_dtype="float32", gather_exact=True)}


def tiny_cell(name: str, seconds: float = 1.0, trace: bool = False, float32: bool = True,
              seed: int = 2 ** 31 + 11) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg_name = cell.config["name"]
    cell.config.update(TINY[cfg_name])
    if float32:
        cell.config.update(FLOAT32.get(cfg_name, {}))
    cell.traffic.update(pool=min(cell.traffic.get("pool", 4), 4), trace_after_s=0.2,
                        trace_s=0.5)
    if "serve_batch" in cell.traffic:
        cell.traffic.update(serve_batch=4, sample_rate=0.5)
    if "warm_iters" in cell.traffic:
        cell.traffic.update(warm_iters=4)
    cell.seed, cell.seconds, cell.trace = seed, seconds, trace
    return cell


@pytest.fixture
def cpu():
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's sizes and kernels run on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run in a temporary directory (the decoder loop writes logs/)."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
