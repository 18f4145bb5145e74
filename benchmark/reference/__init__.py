"""The plain reference the benchmark holds the port against: plain PyTorch and
NumPy, float32 (TF32 off), importing nothing of the port or of JAX."""
