"""The benchmark's plain reference: float32 PyTorch and numpy, independent of
the program under test (it imports neither the port nor the JAX package)."""
