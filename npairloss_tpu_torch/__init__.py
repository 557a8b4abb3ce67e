"""npairloss_tpu_torch — the PyTorch / CUDA port of ``npairloss_tpu``.

The JAX package stays the reference; this package re-implements its
serving path for an NVIDIA H100 with hand-written CUDA kernels in
``csrc/`` (built by ``ops/_build.py`` at first use).  It imports torch,
numpy and the stdlib only — never jax, flax or ``npairloss_tpu``.
Submodules are imported explicitly; importing the package loads nothing.
"""

__version__ = "0.1.0"
