"""Models: GPT-2 with the JAX package's param names and layouts."""
