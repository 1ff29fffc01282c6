"""The plain references: straightforward PyTorch and NumPy versions of
what each cell's timed path computes.  They import neither ``jax``, nor
the JAX package, nor anything of ``repro_torch``, and take only what the
benchmark made (raw data, weights drawn from the seed)."""
