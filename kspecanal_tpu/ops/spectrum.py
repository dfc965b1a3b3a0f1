"""The DSP hot path: overlapped sliding-window FFT magnitude spectra.

This replaces the reference's serial per-window Python loop
(``sdr_curscan``, kspecanal.py:351-397) with one batched, jit-compiled
chain:

    frame -> window-multiply -> FFT -> |.| normalize -> window-reduce -> fftshift

Per-window math being reproduced exactly (kspecanal.py:373,391,396):

    winAdj = len(win) / sum(win)
    fftN   = winAdj * 2 * |fft(frame * win)| / fftSize
    spec   = fftshift(cumulate(fftN over windows))

Design notes:
  * IQ crosses the host<->device boundary as two float32 (or raw uint8)
    planes (re, im), never as complex: the complex value exists only
    inside the jitted computation, so every source and driver speaks one
    real-valued plane protocol.
  * All shapes are static: the valid window starts are precomputed from the
    config (kspecanal.py:368,385-390 semantics, including the per-index
    ``int(i*fftSize*nonOverlap)`` truncation and the early break on a short
    tail window), so XLA sees a fixed ``(num_windows, fft_size)`` batch.
  * The per-window cumulate (serial ``(a+b)/2`` decay / max / min / raw,
    kspecanal.py:392-395) becomes a single weighted reduction over the
    window axis (see ``config.cumu_weights``), pinned to HIGHEST precision.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kspecanal_tpu.config import SpecConfig, cumu_weights, win_adj, window_lut
from kspecanal_tpu.ops.dsp import reduce_windows


def frame_signal(x: jax.Array, starts: Tuple[int, ...],
                 frame_len: int) -> jax.Array:
    """Extract overlapped frames ``(len(starts), frame_len)`` from a 1-D
    signal.

    ``starts`` is a static tuple, so when the stride is uniform XLA sees a
    strided gather it can vectorize; non-uniform starts (fractional hop,
    kspecanal.py:386) still lower to one gather with a precomputed index
    matrix rather than a serial loop.
    """
    starts_arr = np.asarray(starts, np.int32)
    # One gather with a static (W, F) index matrix; XLA lowers this well and
    # it is exact for non-uniform starts (fractional hop truncation).
    gather_idx = starts_arr[:, None] + np.arange(frame_len, dtype=np.int32)[None, :]
    return jnp.take(x, jnp.asarray(gather_idx), axis=0)


def windowed_mags(iq_re: jax.Array, iq_im: jax.Array,
                  cfg: SpecConfig) -> jax.Array:
    """Per-window normalized magnitude spectra ``(num_windows, fft_size)``,
    NOT yet window-reduced or fftshifted (kspecanal.py:385-391)."""
    starts = cfg.window_starts
    n = cfg.fft_size
    fre = frame_signal(iq_re, starts, n)
    fim = frame_signal(iq_im, starts, n)
    win = jnp.asarray(window_lut(cfg.window, n), fre.dtype)
    adj = win_adj(cfg.window, n)
    z = (fre * win) + 1j * (fim * win)
    spec = jnp.fft.fft(z, axis=-1)
    return (adj * 2.0 / n) * jnp.abs(spec)


def curscan(iq_re: jax.Array, iq_im: jax.Array, cfg: SpecConfig) -> jax.Array:
    """Full ``sdr_curscan`` equivalent: one linear-magnitude, fftshifted
    spectrum of length ``fft_size`` from ``full_size`` IQ samples
    (kspecanal.py:351-397)."""
    mags = windowed_mags(iq_re, iq_im, cfg)
    w = cumu_weights(cfg.cur_scan_cumu_mode, cfg.num_windows)
    spec = reduce_windows(cfg.cur_scan_cumu_mode, mags, w)
    return jnp.fft.fftshift(spec)


@functools.partial(jax.jit, static_argnames=("cfg",))
def curscan_jit(iq_re: jax.Array, iq_im: jax.Array,
                cfg: SpecConfig) -> jax.Array:
    return curscan(iq_re, iq_im, cfg)


def curscan_batched(iq_re: jax.Array, iq_im: jax.Array,
                    cfg: SpecConfig) -> jax.Array:
    """vmapped curscan over a leading batch axis: ``(B, full_size)`` IQ ->
    ``(B, fft_size)`` spectra.  Used by scan mode (every retune band's
    curscan is independent) and by the streaming/throughput paths."""
    return jax.vmap(lambda r, i: curscan(r, i, cfg))(iq_re, iq_im)


def fft_freqs(cfg: SpecConfig, center_freq: Optional[float] = None) -> np.ndarray:
    """fftshifted bin center frequencies (kspecanal.py:444-445)."""
    fc = cfg.center_freq if center_freq is None else center_freq
    return np.fft.fftshift(
        np.fft.fftfreq(cfg.fft_size, 1.0 / cfg.sampling_rate) + fc)


def psd_welch(iq_re: jax.Array, iq_im: jax.Array, cfg: SpecConfig) -> jax.Array:
    """Cross-validation path: Welch-style power spectral density matching
    ``matplotlib.mlab.psd`` semantics (the reference's ``bUsePSD`` check,
    kspecanal.py:374-384, added "to verify that the program's internal
    logic is working as expected" per README.rst:523-529).

    mlab.psd with ``NFFT=fft_size``, ``noverlap=fft_size*(1-nonOverlap)``,
    ``Fs=2`` (its default), a user window, and complex input:
      segments stride by ``NFFT - noverlap``; each is windowed, FFT'd,
      |.|^2, averaged over segments, scaled by ``1/(Fs*sum(win^2))``, all
      bins except DC and Nyquist doubled... for complex (onesided=False) no
      doubling, full spectrum.  Returns the two-sided PSD, NOT fftshifted
      (mlab returns freqs via fftshift ordering for complex; we return
      fftshifted to align with curscan's output ordering).
    """
    n = cfg.fft_size
    noverlap = int(n * (1 - cfg.cur_scan_non_overlap))
    step = n - noverlap
    total = iq_re.shape[0]
    num = (total - noverlap) // step
    starts = tuple(i * step for i in range(num) if i * step + n <= total)
    fre = frame_signal(iq_re, starts, n)
    fim = frame_signal(iq_im, starts, n)
    win = jnp.asarray(window_lut(cfg.window, n), fre.dtype)
    # mlab.psd's default detrend is 'none', so frames are windowed as-is.
    z = fre * win + 1j * (fim * win)
    spec = jnp.fft.fft(z, axis=-1)
    pxx = jnp.mean(jnp.abs(spec) ** 2, axis=0)
    fs = 2.0  # mlab default when Fs is unspecified (kspecanal.py:381)
    pxx = pxx / (fs * jnp.sum(win * win))
    return jnp.fft.fftshift(pxx)


def curscan_auto_batched(iq_re: jax.Array, iq_im: jax.Array,
                         cfg: SpecConfig) -> jax.Array:
    """Batched curscan ``(B, full_size)`` planes -> ``(B, fft_size)``
    spectra: the entry point every mode calls.  Raw uint8 planes (the
    rtl_sdr capture format) decode with one elementwise ``x - 127`` that
    XLA fuses into the framing gather; every FFT size then takes the
    gather + FFT chain (:func:`curscan`), which on the H100 beat a direct
    DFT matmul at every size measured (PERF.md)."""
    if iq_re.dtype == jnp.uint8:
        iq_re = iq_re.astype(jnp.float32) - 127.0
        iq_im = iq_im.astype(jnp.float32) - 127.0
    return curscan_batched(iq_re, iq_im, cfg)
