"""Training substrate of the port, from the JAX package's `repro/train/`:
the synthetic and file token streams (`data`), AdamW with its schedule and
clipping (`optimizer`), the train step with microbatching and int8
error-feedback gradient compression (`train_step`), checkpoints in the
reference's on-disk format (`checkpoint`) and the fault-tolerance helpers
over the Stream planner (`fault_tolerance`).  `data` and
`fault_tolerance` are the reference's source with `repro.` rewritten."""
