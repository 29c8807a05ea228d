"""The plain reference that decides ``correct`` (PyTorch tensor operations
on the host CPU). It imports nothing of the program, of the JAX package or
of JAX."""
