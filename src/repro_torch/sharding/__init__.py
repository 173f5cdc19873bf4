"""The port's multi-device layer over `torch.distributed`: the
logical-axis sharding rules and the mesh, spec and sharding stand-ins
(`rules`), and the collectives with the backward passes the training step
needs (`collectives`)."""
