from repro_torch.kernels.jacobi.ops import (  # noqa: F401
    jacobi, jacobi_tiles, prepare_jacobi_tiles)
from repro_torch.kernels.jacobi.ref import (  # noqa: F401
    jacobi_step_ref, jacobi_tiles_ref)
