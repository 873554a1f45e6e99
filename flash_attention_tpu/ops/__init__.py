"""Compute kernels: Pallas (Triton) flash attention and paged decode, plain-JAX
decode, merge, quantization, oracle."""
