"""Cells over several cards: one process a rank, rank r on card r.

A cell whose configuration has a `mesh` runs in `mesh_size` ranks that
`launch` starts from the run's process with the `spawn` method.  They
join one default process group (NCCL on the cards, gloo on the CPU in the
tests) through a rendezvous on a free port of the loopback address; each
builds the configuration's mesh with the port's
`launch.mesh.make_host_mesh` and runs the cell with its own device and
that mesh (`cell_run.run_cell`).  Rank 0 hands its result to the
launching process through a pipe, and the launching process prints it
only once every rank has ended with 0.

In the run, rank 0 decides: before each wave it broadcasts whether
another starts (`agree`), and after the window every rank's allocator
peak, busy seconds and broadcast times are gathered to it (`gather`);
then every rank has freed its program, the group ends (`release`), the
other ranks exit, and rank 0 runs the comparison with every card of the
cell free to it.  Without a process group (one rank, in the tests) each
of these is the rank's own value.

Nothing hangs.  A collective gives up after `COLLECTIVE_S`; the launching
process watches every rank, and when one ends with another code than 0,
or `limit_s` has passed since the run's start, it stops the others
(SIGTERM, then SIGKILL after `GRACE_S`) and returns a code other than 0.
"""
from __future__ import annotations

import os
import socket
import sys
import time

COLLECTIVE_S = 300
GRACE_S = 10
LIMIT_S = 1140          # a checkout's first run builds the kernels too

clock = time.perf_counter


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cell, seed: int, seconds: float, traced: bool, t_start: float,
           device_type: str = "cuda", body=None,
           limit_s: float = LIMIT_S) -> tuple:
    """(exit code, rank 0's result or None) of the cell run in its mesh's
    ranks.  `body(cell, seed, seconds, traced, device, t_start, mesh)` is
    what each rank runs (`cell_run.run_cell` by default); a test passes a
    function of its own module, which the ranks import by name."""
    import multiprocessing
    from multiprocessing.connection import wait

    from harness import spec
    from harness.cell_run import run_cell
    ctx = multiprocessing.get_context("spawn")
    world = spec.mesh_size(cell.config)
    port = free_port()
    recv, send = ctx.Pipe(duplex=False)
    job = (cell, seed, seconds, traced, t_start)
    procs = [ctx.Process(target=rank_main, name=f"rank {r}", args=(
        r, world, port, device_type, body or run_cell, job,
        send if r == 0 else None)) for r in range(world)]
    result, code = None, 0
    try:
        for p in procs:
            p.start()
        send.close()
        waiting = {p.sentinel: p for p in procs}
        readers = [recv]
        while waiting and not code:
            left = t_start + limit_s - clock()
            if left <= 0:
                print(f"ranks still running {limit_s:.0f} s after the "
                      "run's start: stopped", file=sys.stderr)
                code = 124
                break
            for ready in wait(list(waiting) + readers, timeout=min(left, 5)):
                if ready is recv:
                    result, readers = _receive(recv), []
                    continue
                p = waiting.pop(ready)
                p.join()
                if p.exitcode:
                    print(f"{p.name} of {world} ended with {p.exitcode}: "
                          "the other ranks are stopped", file=sys.stderr)
                    code = p.exitcode if p.exitcode > 0 else 1
                    break
        if not code and readers:
            result = _receive(recv)
    finally:
        stop(procs)
        recv.close()
    if not code and result is None:
        print("rank 0 handed no result", file=sys.stderr)
        code = 1
    return code, (None if code else result)


def _receive(conn):
    try:
        return conn.recv() if conn.poll() else None
    except EOFError:
        return None


def stop(procs) -> None:
    """End every process still running: SIGTERM, then SIGKILL after
    `GRACE_S`; returns once each has ended."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + GRACE_S
    for p in procs:
        if p.pid is None:
            continue
        p.join(max(deadline - time.monotonic(), 0.1))
        if p.is_alive():
            p.kill()
            p.join()


def rank_main(rank: int, world: int, port: int, device_type: str, body,
              job: tuple, conn) -> None:
    """One rank: its card, the process group, the mesh, the cell; rank 0
    sends the result through `conn`.  Exits with 3 where JAX or the JAX
    package is loaded."""
    import datetime

    import torch
    import torch.distributed as dist

    from run import forbidden_modules
    if device_type == "cuda":
        # one host: NCCL's bootstrap on the loopback device, like the store
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:                       # the tests' ranks share the host's cores
        device, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    try:
        cell, seed, seconds, traced, t_start = job
        result = body(cell, seed, seconds, traced, device, t_start,
                      mesh_of(cell.config, device_type))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    bad = forbidden_modules()
    if bad:
        print(f"loaded in rank {rank}: {', '.join(bad)}", file=sys.stderr)
        sys.exit(3)
    if conn is not None:
        conn.send(result)
        conn.close()


def mesh_of(config: dict, device_type: str):
    """The configuration's mesh over the process group's ranks, built with
    the port's `launch.mesh.make_host_mesh`."""
    from harness import spec
    from repro_torch.launch.mesh import make_host_mesh
    want = {a: config["mesh"].get(a, 1) for a in spec.MESH_AXES}
    mesh = make_host_mesh(want["model"], device_type=device_type)
    if mesh.shape != want:
        raise ValueError(f"mesh {mesh.shape} for the configuration's {want}")
    return mesh


def _group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def agree(more: bool, device) -> bool:
    """Rank 0's `more` on every rank (a broadcast on the rank's device)."""
    if not _group():
        return more
    import torch
    import torch.distributed as dist
    flag = torch.tensor([int(more)], dtype=torch.int32, device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def gather(value) -> list:
    """Every rank's `value`, in rank order."""
    if not _group():
        return [value]
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def release() -> int:
    """Once every rank has freed its program: end the process group;
    returns this rank."""
    if not _group():
        return 0
    import torch.distributed as dist
    rank = dist.get_rank()
    dist.barrier()
    dist.destroy_process_group()
    return rank
