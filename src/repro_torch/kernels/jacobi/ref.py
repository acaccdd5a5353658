"""Plain PyTorch versions of the Jacobi stencil kernel.

Every form evaluates ``0.25 * (((up + down) + left) + right)``, rounding
after every op in the tensor's dtype, as ``repro/kernels/jacobi/ref.py``
and ``repro/core/overdecomp.py::jacobi_tile_step`` do: in float32 and
bf16 they give the JAX package's bits.

The tile form works on a whole tile tensor ``(T, h, w)`` with a
neighbour table ``nbr (T, 4)`` (up, down, left, right; -1 is the
boundary).  A missing up-neighbour gives the hot edge, 1.0; any other
missing neighbour gives 0.0.
"""
import torch


def neighbour_sum(cur, up, down, left, right):
    """``((up + down) + left) + right`` at every point of the tiles
    ``cur (..., h, w)``, given their halo rows ``up, down (..., w)`` and
    halo columns ``left, right (..., h)``."""
    return (torch.cat([up[..., None, :], cur[..., :-1, :]], dim=-2)
            + torch.cat([cur[..., 1:, :], down[..., None, :]], dim=-2)
            + torch.cat([left[..., None], cur[..., :-1]], dim=-1)
            + torch.cat([cur[..., 1:], right[..., None]], dim=-1))


def jacobi_tile_step(tile, up, down, left, right):
    """5-point Jacobi update for tiles given neighbor halo rows/cols.

    tile: (..., h, w); up/down: (..., w); left/right: (..., h).
    """
    return 0.25 * neighbour_sum(tile, up, down, left, right)


def jacobi_step_ref(grid):
    """One 5-point Jacobi sweep of ``(H, W)``; top halo 1.0, others 0.0."""
    H, W = grid.shape
    return jacobi_tile_step(grid, grid.new_ones(W), grid.new_zeros(W),
                            grid.new_zeros(H), grid.new_zeros(H))


def tile_halos(tiles, ids, nbr):
    """The tiles ``ids`` of ``tiles (T, h, w)`` and their halos: up and
    down rows ``(n, w)``, left and right columns ``(n, h)``, each taken
    from the neighbour's facing edge or from the boundary value."""
    T = tiles.shape[0]
    ids = ids.long()
    nb = nbr[ids].long()
    edges = (  # (the neighbour's facing edge, the boundary value)
        (tiles[:, -1, :], 1.0), (tiles[:, 0, :], 0.0),
        (tiles[:, :, -1], 0.0), (tiles[:, :, 0], 0.0))
    halos = []
    for side, (edge, boundary) in enumerate(edges):
        src = torch.cat([edge, torch.full_like(edge[:1], boundary)])
        halos.append(src[torch.where(nb[:, side] < 0, T, nb[:, side])])
    return (tiles[ids], *halos)


def jacobi_tiles_ref(tiles, ids, nbr):
    """One Jacobi sweep of the tiles ``ids``: ``(n, h, w)``, tile ``i``
    the update of ``tiles[ids[i]]`` with its neighbours' halos."""
    return jacobi_tile_step(*tile_halos(tiles, ids, nbr))
