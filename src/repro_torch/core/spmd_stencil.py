"""The single-grid Jacobi oracle, and the place of the multi-device path.

The reference's ``make_jacobi_spmd_step`` shards the grid by row blocks
over a mesh and exchanges halo rows with ``ppermute`` inside
``shard_map``.  Its port, a halo exchange over ``torch.distributed``
(ROADMAP item 13a, third step), raises until then; the single-device
oracle and the row-block tile update are here.
"""

from __future__ import annotations

from repro_torch.kernels.jacobi.ref import jacobi_step_ref, jacobi_tile_step


def _tile_step(tile, up_row, down_row):
    """Jacobi update for a (rows, W) tile given exterior halo rows."""
    edge = tile.new_zeros(tile.shape[0])      # the grid's left and right
    return jacobi_tile_step(tile, up_row, down_row, edge, edge)


def make_jacobi_spmd_step(*args, **kwargs):
    raise NotImplementedError(
        "the multi-device Jacobi step (shard_map + ppermute halo exchange "
        "in the reference) waits for a halo exchange over "
        "torch.distributed: ROADMAP item 13a, third step")


def reference_jacobi(grid, n_iters: int):
    """Single-device oracle with the same boundary conditions: ``n_iters``
    sweeps of the plain version, on whatever device ``grid`` lies."""
    for _ in range(n_iters):
        grid = jacobi_step_ref(grid)
    return grid
