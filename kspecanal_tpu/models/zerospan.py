"""Zero-span mode: repeatedly scan one band, accumulate max/min/avg/cur
curves and a waterfall heatmap ring (the reference's ``zero_span`` loop,
kspecanal.py:426-506).

Structure: the whole per-iteration update — curscan, display
transform, curve cumulation, baseline adjust, heatmap row compress + ring
write, level-curve compress — is ONE jitted pure function
``(state, iq) -> (state', view)``.  The reference interleaves this math
with matplotlib calls inside a Python loop; here the host shell only feeds
IQ blocks in and hands views to a renderer, so the device pipeline never
stalls on the GUI (the reference's dominant cost, README.rst:430-438).

State is a NamedTuple pytree; curve enable flags and all geometry are
static (from the frozen config), so there is no data-dependent control
flow under jit.  GUI toggles rebuild the step with a new config (one
recompile per toggle, cached thereafter).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kspecanal_tpu.config import HEATMAP_ROWS, SpecConfig
from kspecanal_tpu.ops import dsp
from kspecanal_tpu.ops.spectrum import curscan


class ZeroSpanState(NamedTuple):
    """Accumulated curves (dB domain, post display transform) + waterfall.

    ``seeded`` is a per-curve bitmask (bit0 Max, bit1 Min, bit2 Avg)
    encoding the reference's ``Fft.* = None`` first-copy semantics
    (kspecanal.py:439-442 with data_cumu's None branch :133-134): a curve
    cumulates only after its bit is set, so a curve enabled mid-run by a
    GUI toggle first-copies instead of cumulating against the zeros seed
    (in the reference that curve's Fft.* is still None at enable time).
    """
    fft_max: jax.Array      # (fft_size,)
    fft_min: jax.Array
    fft_avg: jax.Array
    fft_cur: jax.Array
    heatmap: jax.Array      # (HEATMAP_ROWS, hm_width) ring buffer
    hm_index: jax.Array     # int32 scalar: next row to write
    iteration: jax.Array    # int32 scalar
    seeded: jax.Array       # int32 scalar bitmask: bit0 max/1 min/2 avg


class ZeroSpanView(NamedTuple):
    """Per-iteration display products (what the render layer consumes)."""
    x_freqs: jax.Array      # (x_res,) compressed frequency axis
    max_lvls: jax.Array     # (x_res,) compressed curves (dB)
    min_lvls: jax.Array
    avg_lvls: jax.Array
    cur_lvls: jax.Array
    heatmap: jax.Array      # (HEATMAP_ROWS, hm_width)
    spectrum: jax.Array     # (fft_size,) linear pre-log cumulated magnitudes
                            # (what zeroSpanSave records, kspecanal.py:523-525)


def init_state(cfg: SpecConfig) -> ZeroSpanState:
    n = cfg.fft_size
    w = dsp.heatmap_width(n, cfg.x_res, cfg.plt_compress_hm)
    z = jnp.zeros(n, jnp.float32)
    return ZeroSpanState(
        fft_max=z, fft_min=z, fft_avg=z, fft_cur=z,
        heatmap=jnp.zeros((HEATMAP_ROWS, w), jnp.float32),
        hm_index=jnp.zeros((), jnp.int32),
        iteration=jnp.zeros((), jnp.int32),
        seeded=jnp.zeros((), jnp.int32),
    )


def display_update(state: ZeroSpanState, spectrum_linear: jax.Array,
                   cfg: SpecConfig,
                   adj: Optional[jax.Array] = None):
    """Everything after curscan in one zero-span iteration
    (kspecanal.py:469-504): display transform, curve cumulation, baseline
    subtraction, heatmap ring write, level compression.

    ``spectrum_linear`` is the linear fftshifted cumulated magnitude vector
    (curscan output or a replayed frame).  ``adj`` is the optional signal-
    level baseline (``Fft.Adj``, kspecanal.py:400-411).
    """
    # The zero_span display chain (gZeroSpanFftDispProcMode, default
    # 'LogNoGain') with NO inf replacement (kspecanal.py:63,469).
    fft_pr = dsp.fftvals_dispproc(spectrum_linear.astype(jnp.float32),
                                  cfg.zero_span_disp_proc, gain=cfg.gain)

    def cumu(cur, mode, enabled, bit):
        if not enabled:
            return cur
        first = (state.seeded & bit) == 0   # Fft.* still None (:133-134)
        new = dsp.cumulate(mode, cur, fft_pr)
        return jnp.where(first, fft_pr, new)

    fft_max = cumu(state.fft_max, "MAX", cfg.b_data_max, 1)
    fft_min = cumu(state.fft_min, "MIN", cfg.b_data_min, 2)
    fft_avg = cumu(state.fft_avg, "AVG", cfg.b_data_avg, 4)
    fft_cur = fft_pr
    seeded = state.seeded | ((1 if cfg.b_data_max else 0)
                             | (2 if cfg.b_data_min else 0)
                             | (4 if cfg.b_data_avg else 0))

    if adj is not None:
        a_max, a_min, a_avg, a_cur = (fft_max - adj, fft_min - adj,
                                      fft_avg - adj, fft_cur - adj)
    else:
        a_max, a_min, a_avg, a_cur = fft_max, fft_min, fft_avg, fft_cur
    if cfg.tpu_edge_skip_bins > 0:     # band-edge bypass (reference TODO)
        k = cfg.tpu_edge_skip_bins
        a_max, a_min, a_avg, a_cur = (dsp.skip_edge_bins(a, k) for a in
                                      (a_max, a_min, a_avg, a_cur))

    # Heatmap row: compressed adjusted Cur (kspecanal.py:479-484).
    row = dsp.compress_1d(a_cur, cfg.plt_compress_hm, cfg.x_res)
    heatmap = state.heatmap.at[state.hm_index].set(row)
    hm_index = (state.hm_index + 1) % HEATMAP_ROWS

    freqs = jnp.asarray(
        np.fft.fftshift(np.fft.fftfreq(cfg.fft_size, 1.0 / cfg.sampling_rate)
                        + cfg.center_freq).astype(np.float32))
    x_freqs, max_l = dsp.compress_xy(freqs, a_max, cfg.plt_compress, cfg.x_res)
    _, min_l = dsp.compress_xy(freqs, a_min, cfg.plt_compress, cfg.x_res)
    _, avg_l = dsp.compress_xy(freqs, a_avg, cfg.plt_compress, cfg.x_res)
    _, cur_l = dsp.compress_xy(freqs, a_cur, cfg.plt_compress, cfg.x_res)

    new_state = ZeroSpanState(fft_max, fft_min, fft_avg, fft_cur,
                              heatmap, hm_index, state.iteration + 1, seeded)
    view = ZeroSpanView(x_freqs, max_l, min_l, avg_l, cur_l, heatmap,
                        spectrum_linear)
    return new_state, view


def zero_span_step(state: ZeroSpanState, iq_re: jax.Array, iq_im: jax.Array,
                   cfg: SpecConfig, adj: Optional[jax.Array] = None):
    """One full zero-span iteration from raw IQ: curscan + display update
    (the body of the loop at kspecanal.py:460-505).

    ``b_use_psd`` swaps the hand-rolled windowed-overlap chain for the
    Welch PSD cross-check (kspecanal.py:374-384; the reference returns the
    mlab PSD directly — already in ascending-frequency order — instead of
    the curscan magnitudes)."""
    if cfg.b_use_psd:
        from kspecanal_tpu.ops.spectrum import psd_welch
        spectrum = psd_welch(iq_re, iq_im, cfg)
    else:
        spectrum = curscan(iq_re, iq_im, cfg)
    return display_update(state, spectrum, cfg, adj)


@functools.partial(jax.jit, static_argnames=("cfg",))
def zero_span_step_jit(state, iq_re, iq_im, cfg: SpecConfig):
    return zero_span_step(state, iq_re, iq_im, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def zero_span_step_adj_jit(state, iq_re, iq_im, adj, cfg: SpecConfig):
    return zero_span_step(state, iq_re, iq_im, cfg, adj)


@functools.partial(jax.jit, static_argnames=("cfg",))
def display_update_jit(state, spectrum_linear, cfg: SpecConfig):
    return display_update(state, spectrum_linear, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def display_update_adj_jit(state, spectrum_linear, adj, cfg: SpecConfig):
    return display_update(state, spectrum_linear, cfg, adj)


def zero_span_steps(state: ZeroSpanState, iq_re: jax.Array, iq_im: jax.Array,
                    cfg: SpecConfig, adj: Optional[jax.Array] = None,
                    with_view: bool = True):
    """K zero-span iterations in ONE device program (batched catch-up).

    ``iq_*``: (K, full_size).  Exactly equivalent to folding
    :func:`zero_span_step` K times — the per-iteration curves use the
    closed-form decay reductions (config.cumu_weights semantics over the
    dB spectra, kspecanal.py:469-476) and every heatmap ring row is
    written at its serial index — but with one dispatch instead of K.
    Returns (state', view-of-last-iteration) — or (state', None) when
    ``with_view`` is False (headless runs skip the display compression).

    Used by the session loop for file/synth sources, where one dispatch
    per block would leave the device idle between small launches
    (``tpuCatchUp K``).
    """
    from kspecanal_tpu.ops.spectrum import curscan_auto_batched, psd_welch
    if cfg.b_use_psd:
        if iq_re.dtype == jnp.uint8:   # PSD runs through the XLA FFT:
            iq_re = iq_re.astype(jnp.float32) - 127.0   # decode eagerly
            iq_im = iq_im.astype(jnp.float32) - 127.0
        spec_lin = jax.vmap(lambda r, i: psd_welch(r, i, cfg))(iq_re, iq_im)
    else:
        spec_lin = curscan_auto_batched(iq_re, iq_im, cfg)
    return display_updates(state, spec_lin, cfg, adj, with_view)


def display_updates(state: ZeroSpanState, spec_lin: jax.Array,
                    cfg: SpecConfig, adj: Optional[jax.Array] = None,
                    with_view: bool = True):
    """K display-half iterations in ONE device program: everything after
    curscan — display transform, curve folds, heatmap ring — batched over
    ``spec_lin`` (K, fft_size) linear spectra.  The tail of
    :func:`zero_span_steps`, split out so replay mode (whose frames are
    pre-computed spectra, kspecanal.py:547-564) batches through the same
    fold (``tpuCatchUp`` applies there too)."""
    k = spec_lin.shape[0]
    dbs = jax.vmap(lambda s: dsp.fftvals_dispproc(
        s.astype(jnp.float32), cfg.zero_span_disp_proc,
        gain=cfg.gain))(spec_lin)

    def fold(cur, mode, enabled, bit):
        """Seeded-bitmask fold of K spectra into one curve — identical to
        K sequential display_update cumu() calls."""
        if not enabled:
            return cur
        first = (state.seeded & bit) == 0
        if mode == "MAX":
            batch = jnp.max(dbs, axis=0)
            return jnp.where(first, batch, jnp.maximum(cur, batch))
        if mode == "MIN":
            batch = jnp.min(dbs, axis=0)
            return jnp.where(first, batch, jnp.minimum(cur, batch))
        # AVG: sequential (a+b)/2 decay.  Seeded: prev*2^-K + sum w_i x_i
        # with w_i = 2^-(K-i); first-copy: closed-form cumu_weights.
        from kspecanal_tpu.config import CUMU_AVG, cumu_weights
        i = np.arange(k)
        w_cont = 2.0 ** -(k - i.astype(np.float64))
        seeded_avg = dsp.decay_carry(cur, k) + dsp.weighted_rows(w_cont, dbs)
        fresh_avg = dsp.weighted_rows(cumu_weights(CUMU_AVG, k), dbs)
        return jnp.where(first, fresh_avg, seeded_avg)

    fft_max = fold(state.fft_max, "MAX", cfg.b_data_max, 1)
    fft_min = fold(state.fft_min, "MIN", cfg.b_data_min, 2)
    fft_avg = fold(state.fft_avg, "AVG", cfg.b_data_avg, 4)
    fft_cur = dbs[-1]
    seeded = state.seeded | ((1 if cfg.b_data_max else 0)
                             | (2 if cfg.b_data_min else 0)
                             | (4 if cfg.b_data_avg else 0))

    disp = dbs if adj is None else dbs - adj[None, :]
    disp = dsp.skip_edge_bins(disp, cfg.tpu_edge_skip_bins)
    # Ring semantics for ANY batch size: after k sequential writes only
    # the LAST min(k, HEATMAP_ROWS) rows remain in the ring, so writing
    # exactly those keeps every .at[] index distinct (a duplicate-index
    # .set has no ordering guarantee) — k is no longer capped at 128.
    kw = min(k, HEATMAP_ROWS)
    rows = jax.vmap(
        lambda d: dsp.compress_1d(d, cfg.plt_compress_hm, cfg.x_res)
        )(disp[k - kw:])
    ring_idx = (state.hm_index + (k - kw) + jnp.arange(kw)) % HEATMAP_ROWS
    heatmap = state.heatmap.at[ring_idx].set(rows)
    hm_index = (state.hm_index + k) % HEATMAP_ROWS

    new_state = ZeroSpanState(fft_max, fft_min, fft_avg, fft_cur, heatmap,
                              hm_index, state.iteration + k, seeded)
    if not with_view:
        return new_state, None

    if adj is not None:
        a_max, a_min, a_avg, a_cur = (fft_max - adj, fft_min - adj,
                                      fft_avg - adj, fft_cur - adj)
    else:
        a_max, a_min, a_avg, a_cur = fft_max, fft_min, fft_avg, fft_cur
    if cfg.tpu_edge_skip_bins > 0:     # band-edge bypass (reference TODO)
        ek = cfg.tpu_edge_skip_bins
        a_max, a_min, a_avg, a_cur = (dsp.skip_edge_bins(a, ek) for a in
                                      (a_max, a_min, a_avg, a_cur))
    freqs = jnp.asarray(
        np.fft.fftshift(np.fft.fftfreq(cfg.fft_size, 1.0 / cfg.sampling_rate)
                        + cfg.center_freq).astype(np.float32))
    x_freqs, max_l = dsp.compress_xy(freqs, a_max, cfg.plt_compress, cfg.x_res)
    _, min_l = dsp.compress_xy(freqs, a_min, cfg.plt_compress, cfg.x_res)
    _, avg_l = dsp.compress_xy(freqs, a_avg, cfg.plt_compress, cfg.x_res)
    _, cur_l = dsp.compress_xy(freqs, a_cur, cfg.plt_compress, cfg.x_res)

    view = ZeroSpanView(x_freqs, max_l, min_l, avg_l, cur_l, heatmap,
                        spec_lin[-1])
    return new_state, view


@functools.partial(jax.jit, static_argnames=("cfg", "with_view"))
def zero_span_steps_jit(state, iq_re, iq_im, cfg: SpecConfig,
                        with_view: bool = True):
    return zero_span_steps(state, iq_re, iq_im, cfg, with_view=with_view)


@functools.partial(jax.jit, static_argnames=("cfg", "with_view"))
def zero_span_steps_u8_jit(state, raw, cfg: SpecConfig, adj=None,
                           with_view: bool = True):
    """K zero-span iterations from RAW capture bytes (K, 2*full_size):
    the u8 -> float32 decode (octave/load_rtlsdr.m semantics) runs
    on-device so the host ships 2 B/sample instead of 8 (the session
    fast path — host->device transfer dominates the live CLI loop
    otherwise).  The bytes deinterleave into uint8 planes that
    ``curscan_auto_batched`` decodes inside the same program; the PSD
    cross-check path decodes eagerly."""
    iq_re, iq_im = raw[..., 0::2], raw[..., 1::2]
    if cfg.b_use_psd:
        from kspecanal_tpu.parallel.stream import decode_u8_on_device
        iq_re, iq_im = decode_u8_on_device(raw)
    return zero_span_steps(state, iq_re, iq_im, cfg, adj,
                           with_view=with_view)


@functools.partial(jax.jit, static_argnames=("cfg", "with_view"))
def zero_span_steps_adj_jit(state, iq_re, iq_im, adj, cfg: SpecConfig,
                            with_view: bool = True):
    return zero_span_steps(state, iq_re, iq_im, cfg, adj,
                           with_view=with_view)


@functools.partial(jax.jit, static_argnames=("cfg", "with_view"))
def display_updates_jit(state, spec_lin, cfg: SpecConfig, adj=None,
                        with_view: bool = True):
    return display_updates(state, spec_lin, cfg, adj, with_view=with_view)


# NOTE: batched multi-iteration processing for STATELESS streams lives in
# parallel/stream.py (waterfall_stream / waterfall_stream_step);
# zero_span_steps above is its stateful sibling (seeded bitmask, heatmap
# ring continuation) used by the session catch-up path.
