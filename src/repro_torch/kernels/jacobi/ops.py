"""Jacobi stencil entry points (the tile runtime's per-PE step calls
``prepare_jacobi_tiles``).

Dispatch follows the tensor, never a fallback:

* a CUDA tensor launches the hand-written kernel (``kernel.py``), which
  raises on arguments it does not take;
* a CPU tensor runs the plain version (``ref.py``);
* a meta tensor (a cost trace, ``launch.hlo_analysis``) gets an output
  of the kernel's shape and dtype: the arguments are checked as the
  kernel checks them and the call is reported to the cost counter in
  force with ``kernel.cost``, and nothing is launched, built or run.

``jacobi(..., impl="ref")`` asks for the plain version explicitly,
wherever the grid is: only tests use it, to hold the kernel against its
plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import report
from repro_torch.kernels.jacobi import kernel
from repro_torch.kernels.jacobi.ref import jacobi_step_ref, jacobi_tiles_ref


def jacobi(grid, *, impl=None):
    """One 5-point sweep of ``grid (H, W)``; top halo 1.0, others 0.0."""
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "ref" or grid.device.type == "cpu":
        return jacobi_step_ref(grid)
    if grid.device.type == "meta":
        kernel.check_grid(grid, device="meta")
        report("jacobi", kernel.cost, grid.numel(), grid.dtype)
        return torch.empty_like(grid)
    return kernel.jacobi_step(grid)


def prepare_jacobi_tiles(tiles, ids, nbr, out):
    """One sweep of the tiles ``ids`` (int32, n) of ``tiles (T, h, w)``,
    written into the same tiles of ``out`` (a second buffer: the halos
    are read from ``tiles``); the neighbour table ``nbr (T, 4)`` holds
    up, down, left, right, -1 for the boundary.  Returned as a function
    of no arguments that computes it and returns ``out``: on a card the
    arguments are checked and the launch prepared before the call, so
    that events around the call time the kernel."""
    if tiles.device.type == "cpu":
        def plain():
            out[ids.long()] = jacobi_tiles_ref(tiles, ids, nbr)
            return out
        return plain
    if tiles.device.type == "meta":
        kernel.check_tiles(tiles, ids, nbr, out, device="meta")

        def counted():
            _, h, w = tiles.shape
            report("jacobi", kernel.cost, ids.numel() * h * w, tiles.dtype)
            return out
        return counted
    return kernel.prepare_tiles(tiles, ids, nbr, out)


def jacobi_tiles(tiles, ids, nbr, out):
    """``prepare_jacobi_tiles(...)()``: one sweep of the tiles ``ids``
    into ``out``; returns ``out``."""
    return prepare_jacobi_tiles(tiles, ids, nbr, out)()
