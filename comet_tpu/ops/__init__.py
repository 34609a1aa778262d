"""Device-side compute kernels (JAX/XLA) for comet_tpu."""
