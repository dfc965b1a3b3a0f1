"""Checkpoint / resume of mode state (curves + waterfall ring).

The reference's only persistence is session recordings and signal-level
baselines (SURVEY.md §5 checkpoint); long zero-span/scan monitoring runs
lose their accumulated max/min/avg curves and waterfall history on any
restart.  These helpers snapshot the full jitted-step state to a .npz so a
session can resume exactly where it stopped (the analog of
training checkpoint/resume).

Format: one .npz with the state fields plus a config fingerprint; loading
validates the fingerprint (fft size / frequency plan must match, same rule
the baseline loader applies at kspecanal.py:759-763).
"""
from __future__ import annotations

from typing import Union

import jax.numpy as jnp
import numpy as np

from kspecanal_tpu.config import SpecConfig
from kspecanal_tpu.models.scan import ScanState
from kspecanal_tpu.models.zerospan import ZeroSpanState
from kspecanal_tpu.utils.logging import log_warn

_STATE_TYPES = {"zerospan": ZeroSpanState, "scan": ScanState}


def _fingerprint(cfg: SpecConfig) -> np.ndarray:
    # x_res and the heatmap compress mode determine the heatmap ring
    # width, so they must match too or the restored state's buffers would
    # shape-clash inside the jitted step.  window / overlap / cumu-mode
    # don't change any shape, but they change the curves' MATH — resuming
    # across a change would silently continue curves cumulated under
    # different numerics, so they are part of the identity too.
    import zlib  # crc32: stable across processes (hash() is salted)
    return np.asarray([cfg.fft_size, cfg.start_freq or 0.0,
                       cfg.end_freq or 0.0, cfg.sampling_rate, cfg.gain,
                       cfg.x_res,
                       float(zlib.crc32(cfg.plt_compress_hm.encode())),
                       float(zlib.crc32(cfg.window.encode())),
                       cfg.cur_scan_non_overlap,
                       float(zlib.crc32(cfg.cur_scan_cumu_mode.encode()))],
                      np.float64)


def state_path(path: str) -> str:
    """The actual on-disk filename for a requested checkpoint path.

    np.savez appends '.npz' to names without it, so `tpuStateFile /tmp/ck`
    writes /tmp/ck.npz — save and resume must agree on the suffixed name or
    resume silently never finds the file."""
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: Union[ZeroSpanState, ScanState],
               cfg: SpecConfig) -> None:
    kind = "zerospan" if isinstance(state, ZeroSpanState) else "scan"
    arrays = {f: np.asarray(getattr(state, f)) for f in state._fields}
    np.savez(state_path(path), __kind__=kind,
             __fingerprint__=_fingerprint(cfg), **arrays)


def load_state(path: str, cfg: SpecConfig, kind: str = ""):
    """Returns the restored state, or None if the checkpoint does not match
    the current config (mirroring the baseline loader's disable-on-mismatch
    behavior, kspecanal.py:759-763).

    ``kind`` ('zerospan' | 'scan'), when given, additionally rejects a
    checkpoint written by the other mode — a zero-span session must not
    resume a ScanState even when the frequency fingerprint coincides.
    """
    with np.load(state_path(path), allow_pickle=False) as z:
        saved_kind = str(z["__kind__"])
        fp = z["__fingerprint__"]
        if (fp.shape != _fingerprint(cfg).shape
                or not np.array_equal(fp, _fingerprint(cfg))):
            log_warn(f"load_state: {state_path(path)} was written for a different "
                     f"config; ignoring")
            return None
        if kind and saved_kind != kind:
            log_warn(f"load_state: {state_path(path)} holds a {saved_kind} state, "
                     f"current mode needs {kind}; ignoring")
            return None
        cls = _STATE_TYPES[saved_kind]
        missing = [f for f in cls._fields if f not in z.files]
        if missing:
            log_warn(f"load_state: {state_path(path)} lacks fields {missing} (older "
                     f"state layout); ignoring")
            return None
        return cls(**{f: jnp.asarray(z[f]) for f in cls._fields})
