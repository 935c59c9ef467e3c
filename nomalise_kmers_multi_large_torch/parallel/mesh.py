"""The devices of a run.

Port of nomalise_kmers_multi_large_tpu/parallel/mesh.py::data_mesh. The JAX
package is single-controller: one process drives a 1-D mesh of devices.
The port keeps that shape without a mesh object: one process drives a list
of torch devices, and the multi-device steps (parallel/modes.py) place
each shard's tensors on its device. No torch.distributed inside a process:
NCCL puts no two ranks on one card, and a list may repeat a device (four
shards on one card) to check the multi-device paths where there is one.
"""
from __future__ import annotations

import torch

from nomalise_kmers_multi_large_torch.config import ConfigError


def data_devices(n: int, device="cuda") -> list[torch.device]:
    """The devices of a run of `n` devices of `device`'s type.

    n = 0 means every local device: every card for "cuda", one device for
    "cpu", and the device itself for an indexed one ("cuda:1"), so a run on
    one card is unchanged. "cuda" with n > 0 takes cuda:0..n-1, and raises a
    ConfigError if there are fewer cards (no quiet shrinking); "cpu" takes n
    logical CPU devices (the CPU tests' stand-in for several cards)."""
    dev = torch.device(device)
    if n < 0:
        raise ConfigError(f"--devices ({n}) must be >= 0")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if n == 0 and dev.index is not None:
            return [dev]
        have = torch.cuda.device_count()
        if n > have:
            raise ConfigError(f"--devices {n} asks for more CUDA devices "
                              f"than this machine has ({have})")
        return [torch.device("cuda", i) for i in range(n or have)]
    return [dev] * max(n, 1)
