"""What the harness asks of the device: synchronise, the allocator's peak,
freeing the program, the profiler."""
from __future__ import annotations

import gc

import torch


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if is_cuda(device) \
        else 0


def free(device) -> None:
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof
