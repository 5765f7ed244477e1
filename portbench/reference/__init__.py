"""The benchmark's plain reference: frozen copies of the port's CUDA-free
metric code.  It imports neither JAX, the JAX package nor the port."""
