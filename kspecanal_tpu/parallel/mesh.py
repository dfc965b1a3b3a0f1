"""Device-mesh helpers for the sharded pipeline.

Axes:
  * ``time`` — contiguous IQ time-blocks (sequence-parallel axis; windows
    that straddle block boundaries get their overlap samples from the right
    neighbor via ``ppermute`` halo exchange — the reference's overlapped
    sliding (kspecanal.py:368,385-395) is pure overlap-save, so the halo is
    ``fftSize - hop`` samples, SURVEY.md §5 long-context).
  * ``band`` — scan-mode sub-bands (expert-parallel analog: each device
    owns a set of retune bands, stitched after an all-gather,
    SURVEY.md §2.3 EP row).

The axes follow the algorithm, not the interconnect: on one host the
cards are joined all to all (NVLink), so any assignment of devices to
mesh positions costs the same.  Tests build the mesh from virtual CPU
devices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh  # noqa: F401


def make_mesh(time: int = 1, band: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    devs = list(jax.devices()) if devices is None else list(devices)
    need = time * band
    if need > len(devs):
        raise ValueError(f"mesh {time}x{band} needs {need} devices, "
                         f"have {len(devs)}")
    arr = np.asarray(devs[:need]).reshape(time, band)
    return Mesh(arr, axis_names=("time", "band"))


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> None:
    """Multi-process bring-up: ``jax.distributed.initialize`` wrapper.

    Each process calls this before any jax use; the global device list
    then spans every process and :func:`make_mesh` lays its axes across
    them.  A second call in the same process is a no-op; every other
    failure (bad address, unreachable coordinator) propagates.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:
        if "only be called once" not in str(e):
            raise
