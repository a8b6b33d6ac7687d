"""Training and evaluating in several processes (`dist.py`), as
`s2d_tpu/parallel/mesh.py` and `s2d_tpu/utils/jax_setup.py` do it in JAX."""
