"""Plain reference the benchmark judges the program's outputs by.  Imports
neither JAX, nor ``gpcsd_tpu``, nor anything of ``gpcsd_tpu_torch``."""
