"""Offline analysis passes of the port: the dry run's counts
(`repro_torch.analysis.hlo`: dot FLOPs, HBM traffic and collective bytes
of a fake-tensor run), its roofline on H100 constants
(`repro_torch.analysis.roofline`) and collective blame
(`repro_torch.analysis.probe`), and the static-analysis layer
(`repro_torch.analysis.staticcheck`: the determinism linter and the
schedule race detector)."""
