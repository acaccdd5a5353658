"""The port's SSD kernel module and its chunked scan.

* The plain version (``kernels/ssd/ref.py``) matches JAX's
  ``ssd_intra_chunk_ref`` and JAX's Pallas kernel in interpret mode, on
  the 4 shapes of ``tests/test_kernels.py`` plus narrow shapes with
  l in {16, 64, 256}: 1e-4 absolute at the reference's shapes (its own
  tolerance), and at l = 256 1e-6 relative to the largest output plus
  1e-5 relative (float32 sums of up to 256 terms, in another order).
* ``ssd_chunked`` equals the per-token recurrence for chunks 8/16/32,
  and two halves with the carried state equal one whole.
* A CPU tensor runs the plain version and launches nothing; the kernel
  wrapper refuses CPU tensors, wrong dtypes and wrong shapes.
* Kernel vs plain version needs the card: ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_intra_chunk as pallas_kernel
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.mamba2 import ssd_intra_chunk_ref as jax_ref
from repro_torch.kernels import ssd
from repro_torch.models.mamba2 import ssd_chunked

from tests.test_torch_cuda import ssd_inputs

# One intra-op thread: the suite runs in parallel workers beside tests
# that time the wall clock.
torch.set_num_threads(1)

REF_SHAPES = [(1, 2, 16, 2, 8, 16), (2, 1, 32, 4, 16, 8), (1, 3, 8, 1, 4, 4),
              (1, 1, 64, 2, 32, 16)]
NARROW_SHAPES = [(1, 1, 16, 2, 16, 16), (1, 1, 64, 2, 16, 16),
                 (1, 1, 256, 2, 16, 32)]


def _tol(l, ref):
    if l < 256:
        return dict(rtol=0, atol=1e-4)
    return dict(rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("b,nc,l,h,p,n", REF_SHAPES + NARROW_SHAPES)
def test_plain_matches_jax_ref_and_pallas(b, nc, l, h, p, n):
    arrays = ssd_inputs(b, nc, l, h, p, n)
    y, st = ssd.ssd_intra_chunk_ref(*[torch.from_numpy(a) for a in arrays])
    jargs = [jnp.asarray(a) for a in arrays]
    for jy, jst in (jax_ref(*jargs),
                    pallas_kernel(*jargs, interpret=True)):
        jy, jst = np.asarray(jy), np.asarray(jst)
        np.testing.assert_allclose(y.numpy(), jy, **_tol(l, jy))
        np.testing.assert_allclose(st.numpy(), jst, **_tol(l, jst))


def _scan_inputs(b=1, s=32, h=2, p=4, n=8, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.abs(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_equals_sequential_recurrence(chunk):
    """Mirror of ``test_kernels.py``'s test: chunked SSD == the naive
    per-token recurrence (same 1e-3), and == JAX's ssd_chunked."""
    x, dt, A, B, C = _scan_inputs()
    b, s, h, p = x.shape
    state = np.zeros((b, h, p, B.shape[-1]), np.float64)
    ys = []
    for t in range(s):
        dA = np.exp(dt[:, t] * A[None])                         # (b,h)
        xdt = x[:, t] * dt[:, t][..., None]                     # (b,h,p)
        state = state * dA[..., None, None] + np.einsum(
            "bhp,bn->bhpn", xdt, B[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", state, C[:, t]))
    y_ref = np.stack(ys, axis=1)
    y, final = ssd_chunked(*[torch.from_numpy(a) for a in (x, dt, A, B, C)],
                           chunk)
    assert y.dtype == torch.float32 and final.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-3)
    np.testing.assert_allclose(final.numpy(), state, rtol=0, atol=1e-3)
    jy, jfinal = jax_ssd_chunked(*[jnp.asarray(a) for a in (x, dt, A, B, C)],
                                 chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("chunk", [8, 16])
def test_init_state_continuation(chunk):
    """Two halves, the second seeded with the first's final state, equal
    the whole sequence (and JAX's continuation)."""
    x, dt, A, B, C = [torch.from_numpy(a) for a in _scan_inputs()]
    y, final = ssd_chunked(x, dt, A, B, C, chunk)
    y1, s1 = ssd_chunked(x[:, :16], dt[:, :16], A, B[:, :16], C[:, :16],
                         chunk)
    y2, s2 = ssd_chunked(x[:, 16:], dt[:, 16:], A, B[:, 16:], C[:, 16:],
                         chunk, init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), final.numpy(), rtol=0, atol=1e-4)
    jargs = [jnp.asarray(t.numpy()) for t in (x, dt, A, B, C)]
    jx, jdt, jA, jB, jC = jargs
    _, js1 = jax_ssd_chunked(jx[:, :16], jdt[:, :16], jA, jB[:, :16],
                             jC[:, :16], chunk)
    jy2, js2 = jax_ssd_chunked(jx[:, 16:], jdt[:, 16:], jA, jB[:, 16:],
                               jC[:, 16:], chunk, init_state=js1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=0,
                               atol=1e-4)


def test_bf16_input_returns_bf16_and_f32_state():
    """The core is float32 whatever x's dtype; y comes back in x's."""
    x, dt, A, B, C = [torch.from_numpy(a) for a in _scan_inputs()]
    xb, Bb, Cb = x.bfloat16(), B.bfloat16(), C.bfloat16()
    y, final = ssd_chunked(xb, dt, A, Bb, Cb, 16)
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    bf16 = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
            for t in (xb, Bb, Cb)]
    jy, jfinal = jax_ssd_chunked(bf16[0], jnp.asarray(dt.numpy()),
                                 jnp.asarray(A.numpy()), bf16[1], bf16[2],
                                 16)
    assert jy.dtype == jnp.bfloat16
    # the float32 cores agree to ~1e-6; the cast of y to bf16 may round
    # the two to neighbouring values: one bf16 ulp, 2^-8 relative
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=0,
                               atol=1e-4)


def test_cpu_tensor_runs_plain_version_and_launches_nothing():
    args = [torch.from_numpy(a) for a in ssd_inputs(1, 2, 16, 2, 8, 16)]
    before = ssd.kernel.launches
    y, st = ssd.ssd_intra_chunk(*args)
    y_ref, st_ref = ssd.ssd_intra_chunk_ref(*args)
    assert ssd.kernel.launches == before
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    with pytest.raises(ValueError, match="unknown impl"):
        ssd.ssd_intra_chunk(*args, impl="pallas")


def test_kernel_wrapper_refuses_what_it_does_not_take():
    args = [torch.from_numpy(a) for a in ssd_inputs(1, 2, 16, 2, 8, 16)]
    before = ssd.kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd.kernel.ssd_intra_chunk(*args)                  # CPU tensors
    with pytest.raises(ValueError, match="float32"):
        ssd.kernel.ssd_intra_chunk(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="dtr"):
        ssd.kernel.ssd_intra_chunk(args[0], args[1][:, :, :8], *args[2:])
    with pytest.raises(ValueError, match="Cr"):
        ssd.kernel.ssd_intra_chunk(*args[:4], args[4][..., :8])
    with pytest.raises(ValueError, match="want xr"):
        ssd.kernel.ssd_intra_chunk(args[0][0], *args[1:])
    big = [torch.from_numpy(a) for a in ssd_inputs(1, 1, 4, 1, 4, 300)]
    with pytest.raises(ValueError, match="state 300"):
        ssd.kernel.ssd_intra_chunk(*big)
    assert ssd.kernel.launches == before
