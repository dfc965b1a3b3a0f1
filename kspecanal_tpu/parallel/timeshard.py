"""Sequence-parallel curscan: one IQ capture sharded into contiguous
time-blocks across the ``time`` mesh axis, with ring halo exchange of the
window-overlap samples.

This is the BASELINE.json north-star pattern (config 5: fftSize 16384, 90%
overlap, time-blocks sharded with halo exchange).  The reference's
overlapped sliding loop (kspecanal.py:385-395) is overlap-save framing:
window i reads samples ``[int(i*hop), int(i*hop)+fftSize)``, so adjacent
blocks share up to ``fftSize - hop`` samples.  Per shard:

  1. ``ppermute`` the first ``halo`` samples to the LEFT neighbor on the
     ring (each shard receives its right-edge overlap),
  2. batched windowed FFTs over the shard's own window set,
  3. cross-shard reduction of the per-window spectra:
       AVG/RAW -> weighted partial + ``psum`` (the sequential (a+b)/2 decay
                  has closed-form per-window weights — config.cumu_weights —
                  and every shard knows its windows' GLOBAL indices
                  statically, so the decay stays EXACT under sharding),
       MAX/MIN -> masked ``pmax`` / ``pmin``.

All window bookkeeping (starts, per-shard quotas, masks, weights) is
precomputed on the host into replicated static tables indexed by
``jax.lax.axis_index`` — zero data-dependent control flow on device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kspecanal_tpu.config import (CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW,
                                  SpecConfig, cumu_weights, win_adj,
                                  window_lut)


@dataclasses.dataclass(frozen=True)
class TimeShardPlan:
    """Static sharding tables for one (config, num_shards) pair."""
    num_shards: int
    block: int            # samples per shard (full_size / S)
    halo: int             # right-halo samples exchanged (fft_size, rounded)
    quota: int            # windows processed per shard (max, padded)
    # Tables, all shaped (S, quota):
    local_starts: Tuple[Tuple[int, ...], ...]   # window start within shard
    valid: Tuple[Tuple[bool, ...], ...]
    weights: Tuple[Tuple[float, ...], ...]      # global cumu weights (or 0)


def make_time_shard_plan(cfg: SpecConfig, num_shards: int) -> TimeShardPlan:
    full = cfg.full_size
    if full % num_shards:
        raise ValueError(f"full_size {full} not divisible by {num_shards}")
    block = full // num_shards
    starts = np.asarray(cfg.window_starts)
    if block < cfg.fft_size:
        raise ValueError(
            f"block {block} < fft_size {cfg.fft_size}: too many shards "
            f"(halo would span multiple neighbors)")
    halo = cfg.fft_size  # windows extend at most fft_size-1 past a block
    owner = starts // block
    quota = int(np.max(np.bincount(owner, minlength=num_shards)))
    w_global = cumu_weights(cfg.cur_scan_cumu_mode, len(starts))
    local_starts = np.zeros((num_shards, quota), np.int64)
    valid = np.zeros((num_shards, quota), bool)
    weights = np.zeros((num_shards, quota), np.float64)
    fill = np.zeros(num_shards, np.int64)
    for gi, s in enumerate(starts):
        k = int(owner[gi])
        j = int(fill[k]); fill[k] += 1
        local_starts[k, j] = s - k * block
        valid[k, j] = True
        if w_global is not None:
            weights[k, j] = w_global[gi]
    return TimeShardPlan(
        num_shards=num_shards, block=block, halo=halo, quota=quota,
        local_starts=tuple(map(tuple, local_starts.tolist())),
        valid=tuple(map(tuple, valid.tolist())),
        weights=tuple(map(tuple, weights.tolist())))


def _shard_body(iq_re, iq_im, starts_tbl, valid_tbl, weights_tbl,
                cfg: SpecConfig, plan: TimeShardPlan):
    """Per-shard program (runs under shard_map over the 'time' axis).
    iq_re/iq_im: (block,) local slices."""
    k = jax.lax.axis_index("time")
    n = cfg.fft_size

    # 1. Halo: send my first `halo` samples to my LEFT neighbor; receive my
    #    right-edge overlap from my right neighbor (ring).
    perm = [(i, (i - 1) % plan.num_shards) for i in range(plan.num_shards)]
    halo_re = jax.lax.ppermute(iq_re[: plan.halo], "time", perm)
    halo_im = jax.lax.ppermute(iq_im[: plan.halo], "time", perm)
    ext_re = jnp.concatenate([iq_re, halo_re])
    ext_im = jnp.concatenate([iq_im, halo_im])

    # 2. Frame + window + FFT the shard's quota of windows.
    my_starts = starts_tbl[k]                        # (quota,)
    idx = my_starts[:, None] + jnp.arange(n)[None, :]
    fre = jnp.take(ext_re, idx, axis=0)
    fim = jnp.take(ext_im, idx, axis=0)
    win = jnp.asarray(window_lut(cfg.window, n), fre.dtype)
    adj = win_adj(cfg.window, n)
    spec = jnp.fft.fft(fre * win + 1j * (fim * win), axis=-1)
    mags = (adj * 2.0 / n) * jnp.abs(spec)           # (quota, fft_size)

    # 3. Cross-shard window reduction with exact reference semantics.
    mode = cfg.cur_scan_cumu_mode
    my_valid = valid_tbl[k][:, None]
    if mode in (CUMU_AVG, CUMU_RAW):
        partial = jnp.einsum("w,wf->f", weights_tbl[k].astype(mags.dtype),
                             mags, precision=jax.lax.Precision.HIGHEST)
        out = jax.lax.psum(partial, "time")
    elif mode == CUMU_MAX:
        local = jnp.max(jnp.where(my_valid, mags, 0.0), axis=0)
        out = jax.lax.pmax(local, "time")
    elif mode == CUMU_MIN:
        local = jnp.min(jnp.where(my_valid, mags, jnp.inf), axis=0)
        out = jax.lax.pmin(local, "time")
    else:
        raise ValueError(mode)
    return jnp.fft.fftshift(out)


@functools.lru_cache(maxsize=16)
def _build_sharded_curscan(cfg: SpecConfig, plan: TimeShardPlan, mesh: Mesh):
    starts_tbl = jnp.asarray(np.asarray(plan.local_starts, np.int32))
    valid_tbl = jnp.asarray(np.asarray(plan.valid))
    weights_tbl = jnp.asarray(np.asarray(plan.weights, np.float32))

    fn = shard_map(
        functools.partial(_shard_body, cfg=cfg, plan=plan),
        mesh=mesh,
        in_specs=(P("time"), P("time"), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )

    @jax.jit
    def run(iq_re, iq_im):
        return fn(iq_re, iq_im, starts_tbl, valid_tbl, weights_tbl)

    return run


def curscan_time_sharded(iq_re: jax.Array, iq_im: jax.Array,
                         cfg: SpecConfig, mesh: Mesh) -> jax.Array:
    """Drop-in sharded ``curscan``: same (full_size,) -> (fft_size,)
    contract as ops.spectrum.curscan, but with the sample axis sharded over
    the mesh's 'time' axis and halo exchange over the ring."""
    num_shards = mesh.shape["time"]
    plan = make_time_shard_plan(cfg, num_shards)
    run = _build_sharded_curscan(cfg, plan, mesh)
    return run(iq_re, iq_im)
