"""Analysis passes of the port: the schedule race detector
(`repro_torch.analysis.staticcheck`)."""
