"""s2d_tpu_torch: the PyTorch + CUDA port of s2d_tpu's video inference,
evaluation and KD training.

The JAX package `s2d_tpu` beside it is the reference; module names mirror
it one to one. The hand-written kernels live in `csrc/` and are built with
nvcc at first use (`_build.py`). Nothing here imports jax, flax, cv2 or
yaml when the package or a main-path module is imported.
"""

__version__ = "0.1.0"
