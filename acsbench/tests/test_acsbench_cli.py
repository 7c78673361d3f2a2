"""``acsbench/run.py`` as a check runs it: with no card, or in a
checkout that holds only ``BENCHMARK.json`` and the benchmark's files (no
program), it exits non-zero and prints no result; on a card (marked
``cuda``, skipped here) a short run of each cell prints one JSON line with
the result's keys, correct."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd: Path, *args: str, timeout: int = 300):
    return subprocess.run([sys.executable, "acsbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


ARGS = ("--workload", "minicpm.train", "--seed", str(2 ** 33 + 9), "--seconds", "1",
        "--trace", "0")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run(ROOT, *ARGS)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stderr


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "acsbench", tmp_path / "acsbench",
                    ignore=shutil.ignore_patterns("cache", "out", "__pycache__"))
    out = _run(tmp_path, *ARGS)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["granite-moe.train", "minicpm.train"])
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(ROOT, "--workload", workload, "--seed", str(2 ** 34 + 1), "--seconds", "3",
               "--trace", "0", timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "compared"
    assert {"train_tokens_per_s", "train_peak_mem_gib", "setup_s"} <= set(line["metrics"])
