"""The command's refusals: no result without the devices the cell asks
for, nor in a directory holding only BENCHMARK.json and the benchmark."""

import shutil
import subprocess
import sys

import pytest
import torch

from .conftest import ROOT

ARGS = ["--workload", "hand_r101.adapt_spd4", "--seed", str(2 ** 31 + 5), "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "needs 1 CUDA device" in r.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
