"""Without a CUDA card, or without the program, the command fails and
prints no result: no CPU number goes out under a device metric's name."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--workload", "minicpm3.docqa", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "restore_bench/run.py"] + ARGS,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _run(ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "restore_bench", tmp_path / "restore_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_unknown_workload_fails():
    p = subprocess.run([sys.executable, "restore_bench/run.py",
                        "--workload", "no.such.cell", "--seed", "1",
                        "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout
