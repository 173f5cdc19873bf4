"""setup_s (s, host clock): process start to the window's start: imports,
weights made on the device from the seed, the engine or the optimizer
state, warm-up of the cell's own shapes and, in a fresh checkout, the
kernels' build."""


def read(run):
    return run.setup_s
