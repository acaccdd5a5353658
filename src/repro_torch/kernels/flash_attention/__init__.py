from repro_torch.kernels.flash_attention.ops import attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_ref, flash_ref)
