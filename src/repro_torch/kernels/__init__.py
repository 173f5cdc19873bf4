"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (`repro_torch.kernels.ref`), which runs on CPU tensors."""
