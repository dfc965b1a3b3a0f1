"""Value-transform and accumulation ops (the reference's ``data_proc`` /
``data_cumu`` / ``fftvals_dispproc`` layer) as pure JAX functions.

Reference behavior being reproduced:
  * ``data_proc``        kspecanal.py:88-121
  * ``data_cumu``        kspecanal.py:124-147
  * ``fftvals_dispproc`` kspecanal.py:150-165
  * plot compression     kspecanal.py:168-237

Everything here is shape-static and jit-friendly: mode strings are resolved
at trace time (they come from the frozen config), so no data-dependent
control flow reaches XLA.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from kspecanal_tpu.config import (
    COMPRESS_AVG,
    COMPRESS_CONV,
    COMPRESS_MAX,
    COMPRESS_MIN,
    COMPRESS_RAW,
    CUMU_AVG,
    CUMU_MAX,
    CUMU_MIN,
    CUMU_RAW,
    conv_kernel,
)

# ---------------------------------------------------------------------------
# data_proc transforms (kspecanal.py:88-121)
# ---------------------------------------------------------------------------

def hist_low_clip(vals: jax.Array) -> jax.Array:
    """Clip everything below the 2nd 10-bin-histogram edge up to that edge.

    ``np.histogram(vals)`` uses 10 equal bins over [min, max], so the 2nd
    edge is ``min + (max - min)/10`` (kspecanal.py:97-99).
    """
    lo = jnp.min(vals)
    edge = lo + (jnp.max(vals) - lo) / 10.0
    return jnp.maximum(vals, edge)


def clip2minamp(vals: jax.Array, min_amp: float) -> jax.Array:
    """Noise-floor clip to ``minAmp4Clip`` (kspecanal.py:100-101)."""
    return jnp.maximum(vals, jnp.asarray(min_amp, vals.dtype))


def log_db(vals: jax.Array, inf_to: Optional[float] = None) -> jax.Array:
    """``10*log10`` with optional +/-inf replacement (kspecanal.py:102-105)."""
    out = 10.0 * jnp.log10(vals)
    if inf_to is not None:
        out = jnp.where(jnp.isinf(out), jnp.asarray(inf_to, out.dtype), out)
    return out


def log_no_gain(vals: jax.Array, gain: float,
                inf_to: Optional[float] = None) -> jax.Array:
    """dB minus the applied tuner gain (kspecanal.py:106-112).

    Note the reference replaces infinities AFTER subtracting the gain; an
    input of exactly 0 therefore maps to ``inf_to`` (not ``inf_to - gain``).
    """
    out = 10.0 * jnp.log10(vals) - jnp.asarray(gain, vals.dtype)
    if inf_to is not None:
        out = jnp.where(jnp.isinf(out), jnp.asarray(inf_to, out.dtype), out)
    return out


def conv_smooth(vals: jax.Array) -> jax.Array:
    """Smooth with the kaiser(128, 64) kernel, 'same' length, then overwrite
    the first/last 12 points with the post-convolution mean
    (kspecanal.py:113-120).
    """
    kern = jnp.asarray(conv_kernel(), vals.dtype)
    out = jnp.convolve(vals, kern, mode="same")
    avg = jnp.mean(out)
    out = out.at[:12].set(avg)
    out = out.at[-12:].set(avg)
    return out


def data_proc(vals: jax.Array, proc: str, *, gain: float = 0.0,
              min_amp: float = 0.0, inf_to: Optional[float] = None) -> jax.Array:
    """Dispatch a single named transform (kspecanal.py:88-121)."""
    if proc == "HistLowClip":
        return hist_low_clip(vals)
    if proc == "Clip2MinAmp":
        return clip2minamp(vals, min_amp)
    if proc == "Log":
        return log_db(vals, inf_to)
    if proc == "LogNoGain":
        return log_no_gain(vals, gain, inf_to)
    if proc == "Conv":
        return conv_smooth(vals)
    raise ValueError(f"unknown data_proc {proc!r}")


def fftvals_dispproc(vals: jax.Array, disp_proc_mode: str, *, gain: float,
                     inf_to: Optional[float] = None) -> jax.Array:
    """Dot-separated chain of display transforms (kspecanal.py:150-165).

    Only 'Raw', 'LogNoGain' and 'HistLowClip' are legal chain elements in
    the reference; anything else is a config error.
    """
    for mode in disp_proc_mode.split("."):
        if mode == "Raw":
            continue
        if mode == "LogNoGain":
            vals = log_no_gain(vals, gain, inf_to)
        elif mode == "HistLowClip":
            vals = hist_low_clip(vals)
        else:
            raise ValueError(f"unknown DispProcMode {mode!r}")
    return vals


# ---------------------------------------------------------------------------
# data_cumu (kspecanal.py:124-147)
# ---------------------------------------------------------------------------

def cumulate(mode: str, cur: Optional[jax.Array],
             new: jax.Array) -> jax.Array:
    """One full-range cumulate step.

    RAW copies, AVG is the sequential-decay ``(cur+new)/2`` (NOT a true
    running mean — kspecanal.py:137-139), MAX/MIN elementwise extremes.
    ``cur=None`` returns a copy of ``new`` (kspecanal.py:133-134).
    """
    if cur is None:
        return new
    if mode == CUMU_RAW:
        return new
    if mode == CUMU_AVG:
        return (cur + new) / 2.0
    if mode == CUMU_MAX:
        return jnp.maximum(cur, new)
    if mode == CUMU_MIN:
        return jnp.minimum(cur, new)
    raise ValueError(f"unknown cumuMode {mode!r}")


def cumulate_range(mode: str, cur: jax.Array, c_start: int, c_end: int,
                   new: jax.Array, n_start: int, n_end: int) -> jax.Array:
    """Range-wise cumulate into a slice of ``cur`` (the general signature of
    ``data_cumu``, used by the scan-mode stitcher at kspecanal.py:642-668).

    Slice bounds are static Python ints (they come from the precomputed scan
    plan), so this lowers to static slice + dynamic_update_slice.
    """
    seg_new = jax.lax.slice_in_dim(new, n_start, n_end)
    if mode == CUMU_RAW:
        seg = seg_new
    else:
        seg_cur = jax.lax.slice_in_dim(cur, c_start, c_end)
        if mode == CUMU_AVG:
            seg = (seg_cur + seg_new) / 2.0
        elif mode == CUMU_MAX:
            seg = jnp.maximum(seg_cur, seg_new)
        elif mode == CUMU_MIN:
            seg = jnp.minimum(seg_cur, seg_new)
        else:
            raise ValueError(f"unknown cumuMode {mode!r}")
    return jax.lax.dynamic_update_slice_in_dim(cur, seg, c_start, axis=0)


def reduce_windows(mode: str, mags: jax.Array,
                   weights: Optional[np.ndarray]) -> jax.Array:
    """Collapse a ``(num_windows, fft_size)`` batch of per-window spectra to
    one spectrum, equivalent to the reference's serial per-window
    ``data_cumu`` loop (kspecanal.py:385-395).

    AVG/RAW use the closed-form weight vector from
    :func:`kspecanal_tpu.config.cumu_weights` — one weighted reduction
    (a matvec at HIGHEST precision, so no reduced-precision tensor-core
    path rounds the curve) instead of a Python loop.  MAX/MIN are plain
    axis reductions.
    """
    if mode in (CUMU_AVG, CUMU_RAW):
        assert weights is not None
        w = jnp.asarray(weights, mags.dtype)
        return jnp.einsum("w,wf->f", w, mags,
                          precision=jax.lax.Precision.HIGHEST)
    if mode == CUMU_MAX:
        return jnp.max(mags, axis=0)
    if mode == CUMU_MIN:
        return jnp.min(mags, axis=0)
    raise ValueError(f"unknown cumuMode {mode!r}")


_F32_TINY = float(np.finfo(np.float32).tiny)


def weighted_rows(w, rows: jax.Array) -> jax.Array:
    """``sum_i w[i] * rows[i]`` at HIGHEST precision: the closed-form
    decay fold of dB spectra.  Rows whose float32 weight is below the
    normal range are masked out first — a long fold's oldest weights
    underflow (or flush) to 0, and 0 times the -inf dB of an exactly-zero
    bin would be NaN."""
    w = jnp.asarray(w, rows.dtype)
    rows = jnp.where((w >= _F32_TINY)[:, None], rows, 0.0)
    return jnp.einsum("t,tf->f", w, rows, precision=jax.lax.Precision.HIGHEST)


def decay_carry(cur: jax.Array, k: int) -> jax.Array:
    """``cur * 2^-k``: a running Avg after k more halvings.  Once 2^-k
    leaves float32's normal range the serial fold has rounded the carry
    away too, so return zeros rather than multiply (-inf * 0 is NaN)."""
    scale = np.float32(2.0 ** -k)
    return cur * scale if scale >= _F32_TINY else jnp.zeros_like(cur)


# ---------------------------------------------------------------------------
# Plot compression (kspecanal.py:168-237)
# ---------------------------------------------------------------------------

def compress_1d(data: jax.Array, mode: str, x_res: int) -> jax.Array:
    """Compress an N-point vector to ``x_res`` display points.

    RAW passthrough; CONV smoothing; MAX/MIN/AVG reshape to
    ``(x_res, N//x_res)`` and reduce axis 1 (kspecanal.py:184-200).
    If N < x_res the data passes through untouched (cols==0 guard,
    kspecanal.py:191-192).

    The reference's dispatch rejects MIN (dead branch at kspecanal.py:188-197
    despite README.rst:548,562 recommending it); here MIN is implemented for
    real, as the survey prescribes (SURVEY.md §7.2d).
    """
    if mode == COMPRESS_RAW:
        return data
    if mode == COMPRESS_CONV:
        return conv_smooth(data)
    if mode in (COMPRESS_MAX, COMPRESS_MIN, COMPRESS_AVG):
        cols = data.shape[0] // x_res
        if cols == 0:
            return data
        t = data[: x_res * cols].reshape(x_res, cols)
        if mode == COMPRESS_MAX:
            return jnp.max(t, axis=1)
        if mode == COMPRESS_MIN:
            return jnp.min(t, axis=1)
        return jnp.mean(t, axis=1)
    raise ValueError(f"unknown plot-compress mode {mode!r}")


def compress_xy(x: jax.Array, y: jax.Array, mode: str, x_res: int):
    """Compress a curve for display: x blindly averaged, y per user mode
    (kspecanal.py:205-221).  RAW/CONV leave x untouched."""
    if mode == COMPRESS_RAW:
        return x, y
    if mode == COMPRESS_CONV:
        return x, compress_1d(y, mode, x_res)
    return (compress_1d(x, COMPRESS_AVG, x_res),
            compress_1d(y, mode, x_res))


def compress_2d(data: jax.Array, mode: str, x_res: int) -> jax.Array:
    """Per-row compress of a 2D block (heatmap), kspecanal.py:224-237."""
    if mode == COMPRESS_RAW:
        return data
    return jax.vmap(lambda row: compress_1d(row, mode, x_res))(data)


def heatmap_width(fft_size: int, x_res: int, mode: str) -> int:
    """Display width of a heatmap row (kspecanal.py:449-455)."""
    if mode in (COMPRESS_MAX, COMPRESS_MIN, COMPRESS_AVG):
        return min(fft_size, x_res)
    return fft_size


def skip_edge_bins(curve_db: jax.Array, k: int) -> jax.Array:
    """Floor the outer ``k`` bins of a display curve to its INNER minimum
    (last-axis), so display compression and peak marking never pick them.

    Implements the reference's own TODO (README.rst:608-611): discard the
    unreliable bins around the Nyquist edges (spectral leakage / frontend
    non-linearity) without changing array shapes or the cumulated curve
    state.  No-op for ``k <= 0``."""
    if k <= 0:
        return curve_db
    n = curve_db.shape[-1]
    inner_min = jnp.min(
        jax.lax.slice_in_dim(curve_db, k, n - k, axis=-1), axis=-1,
        keepdims=True)
    idx = jnp.arange(n)
    edge = (idx < k) | (idx >= n - k)
    return jnp.where(edge, inner_min, curve_db)
