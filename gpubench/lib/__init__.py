"""The benchmark's own code: nothing here imports JAX or the JAX package, and
the port (``capreolus_tpu_torch``) is imported only by ``systems/``."""
