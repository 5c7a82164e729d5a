"""Core algorithm of the port: quantization, sparsification, error
feedback, Eq. 4 scales and the per-client protocol."""
