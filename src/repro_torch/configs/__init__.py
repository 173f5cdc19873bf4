"""Paper workloads (`repro_torch.configs.paper_workloads`).

Unlike the JAX package's `repro.configs`, this package loads no model
`ArchConfig` on import: the model configs belong to a later part of the port.
"""
