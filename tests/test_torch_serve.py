"""The port's serve launcher end to end on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
def test_serve_cli_cpu(cache_mode):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--max-new", "4", "--cache-mode", cache_mode],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 4/4" in out.stdout, out.stdout
    assert f"cache={cache_mode}" in out.stdout


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_serve_cli_cpu_recurrent(arch):
    """The ssm and hybrid families through the launcher, paged cache."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--requests", "4", "--max-new", "4",
         "--cache-mode", "paged"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"arch={arch} cache=paged" in out.stdout, out.stdout
    assert "served 4/4" in out.stdout, out.stdout


def test_serve_cli_refuses_missing_card():
    """The default device is the card; without one the launcher fails
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "1"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
def test_serve_cluster_cli_cpu(cache_mode):
    """``--cluster``: a heterogeneous fleet with a drained interruption
    serves every request and prints the reference's report."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--cluster", "--fleet", "2x2.0,2x0.7", "--router", "rate_aware",
         "--requests", "16", "--max-new", "24", "--batch-size", "2",
         "--max-seq", "48", "--interrupt-at", "4", "--cache-mode",
         cache_mode],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"cache={cache_mode} device=cpu" in out.stdout, out.stdout
    assert "completed 16/16 (dropped 0)" in out.stdout, out.stdout
    assert "drains=1" in out.stdout, out.stdout


def test_serve_cluster_chaos_returns_cluster():
    """``run_cluster`` hands back (cluster, requests, summary): the chaos
    drill recovers its hard kills and serves everyone."""
    from repro_torch.launch.serve import main
    cl, reqs, out = main(["--device", "cpu", "--arch", "granite-8b",
                          "--cluster", "--fleet", "2x1.0", "--requests",
                          "6", "--max-new", "8", "--chaos", "3",
                          "--chaos-rate", "0.05", "--checkpoint-every", "3"])
    assert out["completed"] == out["submitted"] == len(reqs) == 6
    assert all(r.done and len(r.out_tokens) == 8 for r in reqs)
    assert out["hard_kills"] >= 1 and out["requests_recovered"] >= 1
    assert cl.device == torch.device("cpu")


@pytest.mark.parametrize("flags", [["--market", "naive"],
                                   ["--fallback", "queue_work"],
                                   ["--vertical", "window"], ["--qos"]])
def test_serve_refuses_unported_layers(flags):
    """Market mode and the vertical layer wait for ROADMAP item 9c; the
    launcher refuses their flags instead of ignoring them."""
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="item 9c"):
        main(["--device", "cpu", "--cluster"] + flags)
