"""SPMD overdecomposed stencil over ``torch.distributed`` ranks.

Port of ``repro.core.spmd_stencil``.  The reference shards the grid by
row blocks over a mesh axis, splits each device's block into ``odf``
tiles, and swaps the blocks' boundary rows around the ring with
``ppermute`` inside ``shard_map``.  Here each rank of the mesh's axis
holds its row block, and every iteration the ranks all-gather their
blocks' top and bottom rows (``dist.all_gather``, 2 rows a rank) and
each takes its neighbours'; the global top and bottom rows see the
fixed boundary (1.0 above rank 0, 0.0 below the last rank), as the
reference's ``jnp.where`` sets them.  A collective and not the ring's
point-to-point sends: gloo, the backend that can put several ranks on
one card, sends only host memory point to point (``isend`` of a CUDA
tensor fails, "Bad address"), while its collectives take CUDA tensors.
At ``n`` ranks a rank receives ``2 n`` rows where a ring would bring 2.

The local sweep is the tile form of the Jacobi kernel
(``kernels.jacobi.ops.prepare_jacobi_tiles``): the hand-written kernel
(``csrc/jacobi.cu``) on a CUDA tensor, its plain version on a CPU
tensor.  A rank keeps an ``(odf + 2, rows, W)`` tile tensor: tiles
``0..odf-1`` are its block, tile ``odf`` holds the received top halo in
its last row and tile ``odf + 1`` the received bottom halo in its first
row.  The neighbour table points the first and last tiles at them, or at
``-1`` on the global boundary, where the tile form gives 1.0 above and
0.0 on the other sides: the reference's boundary.  Both forms sum
``((up + down) + left) + right`` and scale by 0.25, so the result is
the reference's bit for bit.  The tiles are double-buffered (the kernel
reads its halos from the buffer it does not write).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.jacobi.ops import prepare_jacobi_tiles
from repro_torch.kernels.jacobi.ref import jacobi_step_ref, jacobi_tile_step


def _tile_step(tile, up_row, down_row):
    """Jacobi update for a (rows, W) tile given exterior halo rows."""
    edge = tile.new_zeros(tile.shape[0])      # the grid's left and right
    return jacobi_tile_step(tile, up_row, down_row, edge, edge)


class JacobiSPMDStep:
    """``n_iters`` Jacobi sweeps of a grid sharded by row blocks over one
    axis of a ``DeviceMesh`` (``make_jacobi_spmd_step`` builds it; every
    rank of the axis calls it, with the same arguments).

    * ``step(grid)``: the global grid ``(n * odf * rows, W)``, the same
      on every rank, -> the global grid after the sweeps (each rank
      sweeps its block, then the blocks are all-gathered), like the
      reference's ``jit`` with ``in_shardings``;
    * ``step.local(block)``: this rank's row block -> the block after the
      sweeps, with no gather.

    ``exchange`` and ``sweep`` are one iteration's two halves, for
    timing them apart."""

    def __init__(self, mesh, axis: str, odf: int, n_iters: int):
        if odf < 1 or n_iters < 0:
            raise ValueError(f"odf {odf}, n_iters {n_iters}")
        self.group = mesh.get_group(axis)
        self.size = mesh.size(mesh.mesh_dim_names.index(axis))
        self.rank = mesh.get_local_rank(axis)
        self.odf, self.n_iters = odf, n_iters
        # whether a neighbour holds the rows above / below this block
        self.up, self.down = self.rank > 0, self.rank < self.size - 1

    # ------------------------------------------------------------ layout
    def tables(self, device):
        """The tile ids (the block's ``odf`` tiles) and the neighbour
        table (up, down, left, right; -1 on the boundary) of the
        ``(odf + 2)``-tile buffer."""
        odf = self.odf
        nbr = torch.full((odf + 2, 4), -1, dtype=torch.int32)
        for i in range(odf):
            nbr[i, 0] = i - 1 if i > 0 else (odf if self.up else -1)
            nbr[i, 1] = i + 1 if i < odf - 1 else (
                odf + 1 if self.down else -1)
        return (torch.arange(odf, dtype=torch.int32, device=device),
                nbr.to(device))

    def buffers(self, block):
        """Two ``(odf + 2, rows, W)`` buffers, the first holding ``block``
        in its first ``odf`` tiles."""
        H, W = block.shape
        if H % self.odf:
            raise ValueError(f"a block of {H} rows does not split into "
                             f"{self.odf} tiles")
        buf = block.new_zeros((self.odf + 2, H // self.odf, W))
        buf[:self.odf].copy_(block.reshape(self.odf, H // self.odf, W))
        return buf, torch.empty_like(buf)

    # ------------------------------------------------------------ one iteration
    def exchange(self, buf):
        """The halo rows: every rank's top and bottom rows all-gathered;
        the row above this block (the upper neighbour's bottom row) lands
        in the last row of tile ``odf``, the row below it (the lower
        neighbour's top row) in the first row of tile ``odf + 1``."""
        if self.size == 1:
            return
        odf, r = self.odf, self.rank
        edges = torch.stack([buf[0, 0], buf[odf - 1, -1]])
        rows = [torch.empty_like(edges) for _ in range(self.size)]
        dist.all_gather(rows, edges, group=self.group)
        if self.up:
            buf[odf, -1].copy_(rows[r - 1][1])
        if self.down:
            buf[odf + 1, 0].copy_(rows[r + 1][0])

    def sweep(self, buf, out, ids, nbr):
        """One sweep of the block's tiles of ``buf`` into ``out``."""
        return prepare_jacobi_tiles(buf, ids, nbr, out)()

    # ------------------------------------------------------------ entry points
    def local(self, block):
        """This rank's row block ``(odf * rows, W)`` after the sweeps."""
        buf, out = self.buffers(block)
        ids, nbr = self.tables(block.device)
        for _ in range(self.n_iters):
            self.exchange(buf)
            buf, out = self.sweep(buf, out, ids, nbr), buf
        return buf[:self.odf].reshape(block.shape)

    def __call__(self, grid):
        H = grid.shape[0]
        if H % (self.size * self.odf):
            raise ValueError(f"{H} rows do not split into {self.size} "
                             f"blocks of {self.odf} tiles")
        b = H // self.size
        block = self.local(grid[self.rank * b:(self.rank + 1) * b])
        parts = [torch.empty_like(block) for _ in range(self.size)]
        dist.all_gather(parts, block.contiguous(), group=self.group)
        return torch.cat(parts)


def make_jacobi_spmd_step(mesh, *, axis: str = "data", odf: int = 4,
                          n_iters: int = 1) -> JacobiSPMDStep:
    """A step: grid ``(n_dev * odf * rows, W)`` -> the same, ``n_iters``
    Jacobi sweeps with a halo exchange between the ranks of ``mesh``'s
    ``axis`` (a ``DeviceMesh`` of ``launch.mesh``).  The grid is split in
    row blocks over ``axis``, and each block in ``odf`` tiles.  Raises
    ``RuntimeError`` without a process group or a mesh."""
    if mesh is None or not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the SPMD Jacobi step needs a DeviceMesh over an initialised "
            "torch.distributed process group (launch.dist.process_group, "
            "or torchrun; launch.mesh.make_mesh); "
            + ("no mesh was given" if mesh is None else "none is"))
    return JacobiSPMDStep(mesh, axis, odf, n_iters)


def reference_jacobi(grid, n_iters: int):
    """Single-device oracle with the same boundary conditions: ``n_iters``
    sweeps of the plain version, on whatever device ``grid`` lies."""
    for _ in range(n_iters):
        grid = jacobi_step_ref(grid)
    return grid
