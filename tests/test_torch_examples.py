"""The port's examples (``examples/torch_*.py``) on the CPU.

Each example's ``main`` runs with ``--device cpu`` and is held to what
its original in ``examples/`` holds or prints: ``torch_serve`` serves
its 6 requests for 48 tokens; ``torch_serve_cluster`` drops nothing
under every router of ``ROUTERS`` despite the drained interruption;
``torch_jacobi_overdecomp`` prints its seven timing lines (its
load-balancing runs at a 256^2 grid here, ``--lb-grid``, against the
original's 1024^2); ``torch_quickstart`` trains its 20 steps to a loss
below its own bound.  Without a card each example's default device
raises.  ``torch_train_spot_elastic`` spawns ranks:
``tests/test_torch_multirank.py`` runs it.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

torch.set_num_threads(1)


def example(name):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve():
    out = example("torch_serve").main(["--device", "cpu"])
    assert len(out["requests"]) == 6
    assert all(r.done and len(r.out_tokens) == 8 for r in out["requests"])
    assert out["stats"]["tokens"] == 48


def test_serve_cluster():
    from repro_torch.cluster import ROUTERS
    outs = example("torch_serve_cluster").main(["--device", "cpu"])
    assert set(outs) == set(ROUTERS)
    for name, out in outs.items():
        assert out["dropped"] == 0, name
        assert out["completed"] == 20, name


def test_jacobi_overdecomp():
    lines = example("torch_jacobi_overdecomp").main(
        ["--device", "cpu", "--lb-grid", "256"])
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "odf=1", "odf=2", "odf=4", "odf=8", "no LB",
        "GreedyRefine rate-blind", "GreedyRefine rate-aware"]
    assert all(math.isfinite(float(ln.split(":")[1].split()[0]))
               for ln in lines)


def test_quickstart():
    out = example("torch_quickstart").main(["--device", "cpu"])
    assert out["final_loss"] < 6.5


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["torch_serve", "torch_serve_cluster",
                                  "torch_jacobi_overdecomp",
                                  "torch_quickstart",
                                  "torch_train_spot_elastic"])
def test_default_device_needs_a_card(name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example(name).main([])
