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


@pytest.mark.parametrize("mode", ["single", "cluster"])
def test_serve_cli_cpu_moe(mode):
    """The moe family through the launcher, paged cache: one engine, and
    a cluster with a drained interruption."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    flags = (["--requests", "4", "--max-new", "4"] if mode == "single" else
             ["--cluster", "--fleet", "2x2.0,2x0.7", "--requests", "8",
              "--max-new", "8", "--batch-size", "2", "--max-seq", "48",
              "--interrupt-at", "4"])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen2-moe-a2.7b", "--cache-mode", "paged", *flags],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=qwen2-moe-a2.7b" in out.stdout, out.stdout
    assert ("served 4/4" if mode == "single" else
            "completed 8/8 (dropped 0)") in out.stdout, out.stdout
    if mode == "cluster":
        assert "drains=1" in out.stdout, out.stdout


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


SMALL_CLUSTER = ["--device", "cpu", "--cluster", "--arch", "granite-8b",
                 "--batch-size", "2", "--max-seq", "48"]


@pytest.mark.parametrize("flags, want", [
    (["--market", "naive", "--requests", "16", "--max-new", "24"],
     ["market[naive]: cost=$", "(4 interruptions, fallback=on_demand)",
      "    volatile: 4 buys $", "buy r0 spot.2.0x @ volatile"]),
    (["--market", "adjusted", "--fallback", "different_market",
      "--scaling", "cost_aware", "--slo-mix", "0.5", "--router",
      "slo_aware", "--requests", "12"],
     ["market[adjusted]: cost=$", "fallback=different_market)",
      "    steady: 4 buys $", "slo[interactive]: attainment="]),
    (["--market", "naive", "--fallback", "queue_work", "--interrupt-at",
      "4", "--requests", "16", "--max-new", "24"],
     ["drains=4 migrated_slots=2", "fallback=queue_work)",
      "(4 interruptions"]),
    (["--vertical", "window", "--qos", "--slo-mix", "0.5", "--requests",
      "24"],
     ["vertical: grows=5 shrinks=9 evictions=0",
      "qos slot-s: guaranteed=", "slo[batch]: attainment=1.000"]),
], ids=["market-naive", "market-adjusted", "queue-work", "vertical-qos"])
def test_serve_cluster_market_and_vertical(flags, want, capsys):
    """Market mode and the vertical layer through the launcher: every
    request served, and the reference launcher's report lines (the
    counts are the reference's for the same flags: the virtual timeline
    follows token counts only)."""
    from repro_torch.launch.serve import main
    cl, reqs, out = main(SMALL_CLUSTER + flags)
    text = capsys.readouterr().out
    assert out["completed"] == out["submitted"] == len(reqs), text
    assert out["dropped"] == 0 and "(dropped 0)" in text
    for line in want:
        assert line in text, (line, text)
    assert (cl.exchange is not None) == ("--market" in flags)
