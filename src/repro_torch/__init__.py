"""PyTorch/CUDA port of Stream's design-space exploration and of the
repo's LLM serving substrate.

The JAX package `repro` is the reference; this package mirrors its layout
(`repro_torch.core`, `repro_torch.hw`, `repro_torch.models`, ...) and imports
nothing of it, nor `jax`.  The engine modules are copies of the reference's
NumPy code; the GA prefilter's batched fitness (`repro_torch.core.vectorized`)
runs as PyTorch on the device the caller names, and its FCFS serialization
step is a CUDA kernel (`repro_torch.kernels.wavefront`).  The token engine
(`repro_torch.serve.engine`) serves the dense GQA decoders, with RMSNorm,
flash attention and decode attention as CUDA kernels on the card
(`repro_torch.kernels`).
"""
