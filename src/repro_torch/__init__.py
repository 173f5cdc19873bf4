"""PyTorch/CUDA port of Stream's design-space exploration.

The JAX package `repro` is the reference; this package mirrors its layout
(`repro_torch.core`, `repro_torch.hw`, ...) and imports nothing of it, nor
`jax`.  The engine modules are copies of the reference's NumPy code; the GA
prefilter's batched fitness (`repro_torch.core.vectorized`) runs as PyTorch
on the device the caller names, and its FCFS serialization step is a CUDA
kernel (`repro_torch.kernels.wavefront`).
"""
