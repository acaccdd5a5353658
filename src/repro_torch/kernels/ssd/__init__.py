from repro_torch.kernels.ssd.ops import ssd_intra_chunk  # noqa: F401
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref  # noqa: F401
