"""The port's Jacobi kernel module and tile kernels against JAX's.

* The plain ``jacobi_step_ref`` equals JAX's Pallas kernel (interpret
  mode) and JAX's ``jacobi_step_ref`` bit for bit, at the 5 shapes of
  ``tests/test_kernels.py::test_jacobi_kernel``, in float32 and bf16:
  both round after every op in the order ((up + down) + left) + right.
* The tile form (``jacobi_tiles_ref``, through ``ops.jacobi_tiles`` on
  the CPU) equals ``jax.vmap(jacobi_tile_step)`` fed the neighbours'
  halos, bit for bit; so does the port's own ``jacobi_tile_step``.
* ``lulesh_tile_step`` is within 1e-5 of JAX's over 8 inner rounds
  (float32 transcendentals of two libraries).
* ``reference_jacobi``, five sweeps of the kernel entry point (five of
  the Pallas kernel: ``test_jacobi_multi_sweep_matches_reference``) and
  the row-block ``_tile_step`` equal JAX's bit for bit (the multi-rank
  ``make_jacobi_spmd_step`` is ``test_torch_multirank.py``'s).
* A CPU tensor runs the plain version and launches nothing; the kernel
  wrapper refuses CPU tensors, wrong dtypes, shapes and overlapping
  buffers.  Kernel vs plain version needs the card: ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.overdecomp import jacobi_tile_step as jax_tile_step
from repro.core.overdecomp import lulesh_tile_step as jax_lulesh
from repro.core.spmd_stencil import _tile_step as jax_row_step
from repro.core.spmd_stencil import reference_jacobi as jax_reference
from repro.kernels.jacobi.kernel import jacobi_step as pallas_jacobi
from repro.kernels.jacobi.ref import jacobi_step_ref as jax_ref
from repro_torch.core.overdecomp import (TileGrid, jacobi_tile_step,
                                         lulesh_tile_step)
from repro_torch.core.spmd_stencil import _tile_step as row_step
from repro_torch.core.spmd_stencil import (make_jacobi_spmd_step,
                                           reference_jacobi)
from repro_torch.kernels import jacobi as jk
from repro_torch.kernels.jacobi import kernel

torch.set_num_threads(1)

# (H, W, block_rows of the Pallas kernel): test_kernels.py's shapes
KERNEL_SHAPES = [(64, 64, 16), (128, 64, 64), (64, 128, 64), (256, 32, 32),
                 (32, 32, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _grid(H, W, seed=0):
    return np.random.default_rng(seed).standard_normal((H, W)).astype(
        np.float32)


def _bits(x) -> np.ndarray:
    """Raw bits of a float32 or bf16 array (torch or jax), as int32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().view(np.int32)
    return np.asarray(x.astype(jnp.float32)).view(np.int32)


@pytest.mark.parametrize("H,W,bh", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_equals_pallas_and_jax_ref(H, W, bh, dtype):
    jd, td = DTYPES[dtype]
    g = _grid(H, W)
    jg = jnp.asarray(g).astype(jd)
    out = jk.jacobi_step_ref(torch.from_numpy(g).to(td))
    assert out.dtype == td and out.shape == (H, W)
    for ref in (pallas_jacobi(jg, block_rows=bh, interpret=True),
                jax_ref(jg)):
        np.testing.assert_array_equal(_bits(out), _bits(ref))


def _tiles_and_halos(tg: TileGrid, seed=1):
    """Random tiles of ``tg`` and each tile's halos as the reference's
    runtime builds them (``overdecomp.py:164-179``)."""
    h, w = tg.tile_shape
    tiles = np.random.default_rng(seed).standard_normal(
        (tg.n_tiles, h, w)).astype(np.float32)
    halos = []
    for t in range(tg.n_tiles):
        nb = tg.neighbors(t)
        up = tiles[nb["up"]][-1] if nb["up"] is not None else np.ones(w)
        down = tiles[nb["down"]][0] if nb["down"] is not None else \
            np.zeros(w)
        left = tiles[nb["left"]][:, -1] if nb["left"] is not None else \
            np.zeros(h)
        right = tiles[nb["right"]][:, 0] if nb["right"] is not None else \
            np.zeros(h)
        halos.append((up, down, left, right))
    halos = [np.stack(a).astype(np.float32) for a in zip(*halos)]
    nbr = np.array([[-1 if n is None else n for n in tg.neighbors(t).values()]
                    for t in range(tg.n_tiles)], np.int32)
    return tiles, halos, nbr


@pytest.mark.parametrize("tr,tc,h,w", [(4, 4, 8, 8), (2, 4, 16, 8),
                                       (1, 3, 5, 7), (3, 1, 4, 16)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_form_equals_vmap_tile_step(tr, tc, h, w, dtype):
    jd, td = DTYPES[dtype]
    tg = TileGrid(tr * h, tc * w, tr, tc)
    tiles, halos, nbr = _tiles_and_halos(tg)
    want = jax.vmap(jax_tile_step)(*[jnp.asarray(a).astype(jd)
                                     for a in (tiles, *halos)])
    src = torch.from_numpy(tiles).to(td)
    # every other tile, in a shuffled order: ids as a PE holds them
    ids = torch.tensor(np.random.default_rng(2).permutation(
        tg.n_tiles)[::2].copy(), dtype=torch.int32)
    before = kernel.launches
    out = jk.jacobi_tiles(src, ids, torch.from_numpy(nbr),
                          torch.full_like(src, float("nan")))
    assert kernel.launches == before     # the CPU runs the plain version
    idx = ids.long().numpy()
    np.testing.assert_array_equal(_bits(out[ids.long()]),
                                  _bits(want[idx]))
    assert torch.isnan(out[np.setdiff1d(np.arange(tg.n_tiles), idx)]).all()
    ported = jacobi_tile_step(src, *[torch.from_numpy(a).to(td)
                                     for a in halos])
    np.testing.assert_array_equal(_bits(ported), _bits(want))


def test_lulesh_tile_step_matches_jax():
    tg = TileGrid(32, 48, 2, 3)
    tiles, halos, _ = _tiles_and_halos(tg, seed=5)
    tiles = np.abs(tiles)
    want = np.asarray(jax.vmap(jax_lulesh)(*map(jnp.asarray,
                                                (tiles, *halos))))
    got = lulesh_tile_step(*map(torch.from_numpy, (tiles, *halos)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("H,W,n", [(64, 32, 5), (33, 17, 9)])
def test_reference_jacobi_matches_jax(H, W, n):
    g = _grid(H, W, seed=H)
    want = jax_reference(jnp.asarray(g), n)
    np.testing.assert_array_equal(
        _bits(reference_jacobi(torch.from_numpy(g), n)), _bits(want))
    many = torch.from_numpy(g)
    for _ in range(n):
        many = jk.jacobi(many)
    np.testing.assert_array_equal(_bits(many), _bits(want))


def test_row_block_tile_step_matches_jax():
    """``spmd_stencil._tile_step``: a row block with exterior halo rows."""
    rng = np.random.default_rng(3)
    tile, up, down = (rng.standard_normal(s).astype(np.float32)
                      for s in ((16, 24), (24,), (24,)))
    want = jax_row_step(*map(jnp.asarray, (tile, up, down)))
    got = row_step(*map(torch.from_numpy, (tile, up, down)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_spmd_step_waits_for_torch_distributed():
    """The SPMD step runs over a ``DeviceMesh`` of torch.distributed
    ranks (held against the reference in ``test_torch_multirank.py``):
    without a mesh and a process group it raises, naming them."""
    with pytest.raises(RuntimeError, match="process group"):
        make_jacobi_spmd_step(None, odf=4)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    g = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.jacobi_step(g)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel.jacobi_step(g.double())
    with pytest.raises(ValueError, match="grid"):
        kernel.jacobi_step(torch.zeros(2, 8, 8))
    tiles = torch.zeros(4, 8, 8)
    ids = torch.arange(2, dtype=torch.int32)
    nbr = torch.full((4, 4), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="overlaps"):
        kernel.check_tiles(tiles, ids, nbr, tiles)
    with pytest.raises(ValueError, match="nbr"):
        kernel.check_tiles(tiles, ids, nbr[:3], torch.zeros(4, 8, 8))
    with pytest.raises(ValueError, match="int32"):
        kernel.check_tiles(tiles, ids.long(), nbr, torch.zeros(4, 8, 8))
    with pytest.raises(ValueError, match="unknown impl"):
        jk.jacobi(g, impl="pallas")


def test_jacobi_multi_sweep_matches_reference():
    """Five sweeps of the port's kernel entry point (its plain version on
    a CPU tensor) equal five sweeps of JAX's Pallas kernel (interpret
    mode) and the port's and JAX's ``reference_jacobi``, bit for bit."""
    g = _grid(64, 32, seed=1)
    a, p = torch.from_numpy(g), jnp.asarray(g)
    for _ in range(5):
        a = jk.jacobi(a)
        p = pallas_jacobi(p, block_rows=16, interpret=True)
    np.testing.assert_array_equal(_bits(a), _bits(p))
    np.testing.assert_array_equal(
        _bits(a), _bits(reference_jacobi(torch.from_numpy(g), 5)))
    np.testing.assert_array_equal(_bits(a),
                                  _bits(jax_reference(jnp.asarray(g), 5)))
