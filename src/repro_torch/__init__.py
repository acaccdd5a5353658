"""PyTorch/CUDA port of the adaptive serving runtime (``repro``).

Module paths mirror the JAX package so each file can be read beside its
counterpart.  This package imports ``torch`` and never ``jax`` or
anything of ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
