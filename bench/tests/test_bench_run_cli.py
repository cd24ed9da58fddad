"""``bench/run.py`` fails, printing no result, where it cannot measure."""

import shutil
import subprocess
import sys

import pytest

from bench import harness


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "gw-emulate-8192",
                           "--seed", "2147483650", "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, timeout=300, cwd=cwd,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_it_exits_non_zero_and_prints_nothing():
    out = _run(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_beside_it_it_exits_non_zero(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_negative_seed_is_refused():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "gw-emulate-8192",
                          "--seed", "-1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=120, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_prints_a_correct_line(card):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "gw-emulate-8192",
                          "--seed", "2147483651", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["events_per_s"]["value"] > 0
