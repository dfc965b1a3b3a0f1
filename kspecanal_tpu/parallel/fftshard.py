"""Tensor-parallel FFT: the DFT bin axis sharded across devices
(SURVEY.md §2.3 TP row — distributed FFT for very large fftSize).

Uses the same two-factor decomposition as ops/mxu_fft.py, laid out so the
only communication is one reduction over the output grid:

    A[n1, n2] = x[n1*N2 + n2]          (columns n2 sharded across devices)
    B = F1 @ A_local                    stage 1 — contracts n1, column-local
    C = B * T_local                     twiddle — column-local
    D = sum_shards C_local @ F2bd_local (n2 is the contraction axis, which
                                         is exactly the sharded axis ->
                                         each shard computes a partial D
                                         and a single psum finishes it)

Per-shard matmul cost is 1/S of the total; the psum moves one (n1, n2)
grid per window batch.

Window framing: shard s owns columns n2_local = [s*n2/S, (s+1)*n2/S); its
slice of frame A is x[n1*N2 + n2] for those n2 — a strided gather from the
(replicated) IQ block, precomputed as a static index table.

The per-window cumulate and fftshift happen after the psum, replicated
(cheap next to the DFT).  Matches ops.spectrum.curscan numerics exactly.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kspecanal_tpu.config import (CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW,
                                  SpecConfig, cumu_weights, win_adj,
                                  window_lut)
from kspecanal_tpu.ops.mxu_fft import (_dft_tables, _factorize,
                                       matmul_precision)


def supports_fft_sharding(cfg: SpecConfig, num_shards: int) -> bool:
    n1, n2 = _factorize(cfg.fft_size)
    return n2 % num_shards == 0 and n2 > 1


def _shard_body(iq_re, iq_im, col_idx, f1r, f1i, f2r_sl, f2i_sl,
                twr_sl, twi_sl, win_sl, wts, *, cfg: SpecConfig,
                num_shards: int):
    """Per-shard program.  iq planes replicated (full_size,); col_idx
    (W, n1, n2/S) static gather indices for this shard's frame columns;
    f2*_sl (n2/S, n2) this shard's rows of F2^T; tw/win slices
    (n1, n2/S)."""
    n = cfg.fft_size
    n1, n2 = _factorize(n)
    w_cnt = cfg.num_windows
    adj_scale = jnp.float32(win_adj(cfg.window, n) * 2.0 / n)
    dot = functools.partial(jnp.dot, preferred_element_type=jnp.float32,
                            precision=matmul_precision(cfg.tpu_precision))

    mode = cfg.cur_scan_cumu_mode
    if mode == CUMU_MIN:
        acc = jnp.full((n1, n2), jnp.inf, jnp.float32)
    else:
        acc = jnp.zeros((n1, n2), jnp.float32)

    for wi in range(w_cnt):
        ar = jnp.take(iq_re, col_idx[wi], axis=0) * win_sl  # (n1, n2/S)
        ai = jnp.take(iq_im, col_idx[wi], axis=0) * win_sl
        br = dot(f1r, ar) - dot(f1i, ai)                    # stage 1
        bi = dot(f1r, ai) + dot(f1i, ar)
        cr = br * twr_sl - bi * twi_sl                      # twiddle
        ci = br * twi_sl + bi * twr_sl
        # stage 2 partial over this shard's n2 columns: (n1, n2/S) @ (n2/S, n2)
        dr = dot(cr, f2r_sl) - dot(ci, f2i_sl)
        di = dot(ci, f2r_sl) + dot(cr, f2i_sl)
        # Magnitude needs the COMPLETE complex value -> reduce re/im parts
        # across shards first (one psum pair per window).
        dr = jax.lax.psum(dr, "time")
        di = jax.lax.psum(di, "time")
        mag = jnp.sqrt(dr * dr + di * di)                   # (n1, n2) [k1,k2]
        if mode in (CUMU_AVG, CUMU_RAW):
            acc = acc + wts[wi] * adj_scale * mag
        elif mode == CUMU_MAX:
            acc = jnp.maximum(acc, adj_scale * mag)
        else:
            acc = jnp.minimum(acc, adj_scale * mag)

    # X[k1 + N1*k2] = acc[k1, k2]; fftshift for even n
    spec = acc.T.reshape(n)
    return jnp.concatenate([spec[n // 2:], spec[: n // 2]])


@functools.lru_cache(maxsize=16)
def _build(cfg: SpecConfig, mesh: Mesh):
    n = cfg.fft_size
    n1, n2 = _factorize(n)
    s = mesh.shape["time"]
    if not supports_fft_sharding(cfg, s):
        raise ValueError(f"fft_size {n} (n2={n2}) not shardable {s} ways")
    n2l = n2 // s
    f1r, f1i, f2r, f2i, twr, twi = _dft_tables(n)
    win2 = window_lut(cfg.window, n).reshape(n1, n2).astype(np.float32)
    wts = cumu_weights(cfg.cur_scan_cumu_mode, cfg.num_windows)
    if wts is None:
        wts = np.zeros(cfg.num_windows)

    # Static per-shard tables stacked on a leading shard axis, delivered
    # sharded via in_specs so each device reads only its slice.
    col_idx = np.empty((s, cfg.num_windows, n1, n2l), np.int32)
    for sh in range(s):
        cols = np.arange(sh * n2l, (sh + 1) * n2l)
        for wi, st in enumerate(cfg.window_starts):
            col_idx[sh, wi] = st + (np.arange(n1)[:, None] * n2
                                    + cols[None, :])
    f2r_sl = np.stack([f2r.T[sh * n2l:(sh + 1) * n2l] for sh in range(s)])
    f2i_sl = np.stack([f2i.T[sh * n2l:(sh + 1) * n2l] for sh in range(s)])
    twr_sl = np.stack([twr[:, sh * n2l:(sh + 1) * n2l] for sh in range(s)])
    twi_sl = np.stack([twi[:, sh * n2l:(sh + 1) * n2l] for sh in range(s)])
    win_sl = np.stack([win2[:, sh * n2l:(sh + 1) * n2l] for sh in range(s)])

    body = functools.partial(_shard_body, cfg=cfg, num_shards=s)

    def wrapped(iq_re, iq_im, ci, f2r_, f2i_, twr_, twi_, win_, f1r_, f1i_,
                wts_):
        # shard-axis leading dims arrive size-1 per shard; drop them
        return body(iq_re, iq_im, ci[0], f1r_, f1i_, f2r_[0], f2i_[0],
                    twr_[0], twi_[0], win_[0], wts_)

    fn = shard_map(
        wrapped, mesh=mesh,
        in_specs=(P(), P(), P("time"), P("time"), P("time"), P("time"),
                  P("time"), P("time"), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )

    consts = tuple(jnp.asarray(t) for t in (
        col_idx, f2r_sl, f2i_sl, twr_sl, twi_sl, win_sl,
        f1r.astype(np.float32), f1i.astype(np.float32),
        np.asarray(wts, np.float32)))

    @jax.jit
    def run(iq_re, iq_im):
        return fn(iq_re, iq_im, *consts)

    return run


def curscan_fft_sharded(iq_re: jax.Array, iq_im: jax.Array,
                        cfg: SpecConfig, mesh: Mesh) -> jax.Array:
    """Tensor-parallel curscan: same (full_size,) -> (fft_size,) contract
    as ops.spectrum.curscan, with the DFT bin axis sharded over the mesh
    'time' axis (IQ replicated; use timeshard.py when the SAMPLE axis is
    what should shard)."""
    return _build(cfg, mesh)(iq_re, iq_im)
