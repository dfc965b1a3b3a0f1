"""Scan mode: stepped multi-band sweep with overlap-averaged stitching
(the reference's ``scan_range`` / ``_scan_range``, kspecanal.py:568-732).

Structure:
  * All per-band curscans in a sweep are independent -> they run as ONE
    batched device call over a ``(num_bands, full_size)`` IQ block
    (``curscan_batched``), instead of the reference's serial
    retune -> scan -> plot per band.
  * The order-dependent stitch (RAW copy of the new half-band then
    overlap-AVG with the previous band, kspecanal.py:642-650) has a fully
    static index plan precomputed from the config (``ScanPlan``); the
    stitch itself is a jitted fold over bands with static slice sizes.
  * Retune failures fill the band with ones ~ -25 dB sentinel and the sweep
    continues, keeping shapes stable (kspecanal.py:635-639,
    README.rst:368-370) — mirrored for failed shards in the distributed
    path (SURVEY.md §5 failure detection).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kspecanal_tpu.config import HEATMAP_ROWS, SpecConfig
from kspecanal_tpu.ops import dsp
from kspecanal_tpu.ops.spectrum import curscan_auto_batched


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Static stitch indices for one band (kspecanal.py:621-668)."""
    center_freq: float
    i_start: int     # global grid write start for Max/Min/Avg
    i_end: int       # iStart + fftSize (clamped source length via s_end)
    i_done: int      # int((i+1)*fftSize*scanRangeNonOverlap)
    i_old_end: int   # previous band's iEnd (0 for first band)
    s_start: int     # source slice start (always 0 in the reference)
    s_end: int       # source slice end (shrinks if band pokes past grid)
    s_raw_start: int  # source start of the fresh (non-overlap) region


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Whole-sweep static plan derived purely from the config."""
    bands: Tuple[BandPlan, ...]
    total_entries: int
    num_groups: int
    freqs_all: Tuple[float, ...]  # global stitched frequency axis

    @property
    def num_bands(self) -> int:
        return len(self.bands)


def make_scan_plan(cfg: SpecConfig) -> ScanPlan:
    """Precompute the reference's band-loop index math
    (kspecanal.py:594-650 and the freq axis at :609)."""
    cfg.validate_scan()
    assert cfg.start_freq is not None and cfg.end_freq is not None
    span = cfg.sampling_rate
    f = cfg.fft_size
    num_groups = cfg.scan_num_groups
    total = num_groups * f
    freqs_all = np.fft.fftshift(
        np.fft.fftfreq(total, 1.0 / (num_groups * span))
        + cfg.start_freq + (num_groups * span) / 2)

    bands = []
    cur_freq = cfg.start_freq + span / 2
    start_freq = cur_freq - span / 2
    i = 0
    i_old_end = 0
    while start_freq < cfg.end_freq:
        i_start = int(i * f * cfg.scan_range_non_overlap)
        i_end = i_start + f
        i_done = int((i + 1) * f * cfg.scan_range_non_overlap)
        s_start = 0
        if i_end > total:
            s_end = i_end - i_start - (i_end - total)
        else:
            s_end = i_end - i_start
        # sRawStart = sStart + (fftSize - (iEnd - iOldEnd))  :643
        s_raw_start = s_start + (f - (i_end - i_old_end))
        clamped_old_end = min(i_old_end, total)
        bands.append(BandPlan(
            center_freq=cur_freq, i_start=i_start, i_end=i_end,
            i_done=min(i_done, total), i_old_end=clamped_old_end,
            s_start=s_start, s_end=s_end, s_raw_start=s_raw_start))
        i_old_end = i_end
        cur_freq += span * cfg.scan_range_non_overlap
        start_freq = cur_freq - span / 2
        i += 1
    # The band frequency axes overwrite overlapping segments of the global
    # axis (kspecanal.py:631-634); reproduce that exactly.
    fa = np.array(freqs_all)
    for b in bands:
        bf = np.fft.fftshift(
            np.fft.fftfreq(f, 1.0 / cfg.sampling_rate) + b.center_freq)
        fa[b.i_start:b.i_start + (b.s_end - b.s_start)] = bf[b.s_start:b.s_end]
    return ScanPlan(bands=tuple(bands), total_entries=total,
                    num_groups=num_groups, freqs_all=tuple(fa.tolist()))


class ScanState(NamedTuple):
    """Global stitched curves over the whole scan range (dB domain) +
    per-sweep waterfall ring (kspecanal.py:602-614)."""
    fft_max: jax.Array      # (total_entries,)
    fft_min: jax.Array
    fft_avg: jax.Array
    fft_cur: jax.Array
    heatmap: jax.Array      # (HEATMAP_ROWS, hm_width)
    hm_index: jax.Array
    sweep: jax.Array        # int32: completed sweep count (runCount)


class ScanView(NamedTuple):
    x_freqs: jax.Array
    max_lvls: jax.Array
    min_lvls: jax.Array
    avg_lvls: jax.Array
    cur_lvls: jax.Array
    heatmap: jax.Array


def init_state(cfg: SpecConfig, plan: ScanPlan) -> ScanState:
    """Seed buffers exactly as the first `_scan_range` call does
    (kspecanal.py:602-614): Cur/Max/Avg = disp(minAmp4Clip), Min = disp(1),
    heatmap rows = compress(disp-domain minAmp4Clip)... the reference seeds
    the heatmap with RAW minAmp4Clip (linear!) compressed — reproduced."""
    total = plan.total_entries
    disp_floor = float(10 * np.log10(cfg.min_amp4clip) - cfg.gain)
    disp_one = float(0.0 - cfg.gain)  # 10*log10(1) - gain
    hm_w = len(np.asarray(dsp.compress_1d(
        jnp.zeros(total), cfg.plt_compress_hm, cfg.x_res)))
    return ScanState(
        fft_max=jnp.full(total, disp_floor, jnp.float32),
        fft_min=jnp.full(total, disp_one, jnp.float32),
        fft_avg=jnp.full(total, disp_floor, jnp.float32),
        fft_cur=jnp.full(total, disp_floor, jnp.float32),
        # hmData = ones * minAmp4Clip, then 2d-compressed (kspecanal.py:613-614)
        heatmap=jnp.full((HEATMAP_ROWS, hm_w), float(cfg.min_amp4clip),
                         jnp.float32),
        hm_index=jnp.zeros((), jnp.int32),
        sweep=jnp.zeros((), jnp.int32),
    )


def band_spectra(iq_re: jax.Array, iq_im: jax.Array, retune_ok: jax.Array,
                 cfg: SpecConfig) -> jax.Array:
    """Batched per-band display spectra for one sweep.

    iq_*: (num_bands, full_size); retune_ok: (num_bands,) bool.
    Returns (num_bands, fft_size) dB spectra after the scan display chain:
    curscan -> sentinel substitution -> Clip2MinAmp -> LogNoGain(infTo=0)
    (kspecanal.py:635-641).

    ``b_use_psd`` applies here too: the reference's PSD cross-check lives
    inside ``sdr_curscan`` (kspecanal.py:636 -> :374-384), so scan mode
    inherits it per band."""
    if cfg.b_use_psd:
        from kspecanal_tpu.ops.spectrum import psd_welch
        if iq_re.dtype == jnp.uint8:   # PSD runs through the XLA FFT:
            iq_re = iq_re.astype(jnp.float32) - 127.0   # decode eagerly
            iq_im = iq_im.astype(jnp.float32) - 127.0
        lin = jax.vmap(lambda r, i: psd_welch(r, i, cfg))(iq_re, iq_im)
    else:
        lin = curscan_auto_batched(iq_re, iq_im, cfg)
    # Failed retune -> all-ones band (~ -gain dB marker) kspecanal.py:637-639
    lin = jnp.where(retune_ok[:, None], lin, jnp.ones_like(lin))
    clip = cfg.scan_clip_proc
    if clip == "Clip2MinAmp":
        lin = dsp.clip2minamp(lin, cfg.min_amp4clip)
    elif clip == "HistLowClip":
        lin = jax.vmap(dsp.hist_low_clip)(lin)
    return dsp.fftvals_dispproc(lin, cfg.scan_disp_proc, gain=cfg.gain,
                                inf_to=0.0)


def _uniform_run(plan: ScanPlan):
    """Longest run of bands starting at index 1 whose slice geometry
    relative to ``i_start`` matches band 1's with a constant stride.
    Returns (run_start=1, run_len, stride) or (1, 0, 0)."""
    if plan.num_bands < 3:
        return 1, 0, 0
    b1 = plan.bands[1]
    stride = plan.bands[2].i_start - b1.i_start

    def rel(b):
        return (b.i_end - b.i_start, b.i_done - b.i_start,
                b.i_old_end - b.i_start, b.s_start, b.s_end, b.s_raw_start)

    want = rel(b1)
    run = 0
    for k, b in enumerate(plan.bands[1:]):
        if b.i_start != b1.i_start + k * stride or rel(b) != want:
            break
        run += 1
    return 1, run, stride


# Unroll threshold: plans with more bands than this use the lax.scan fast
# path over their uniform middle run (quickFullScan has ~1225 bands —
# unrolling would explode compile time).
_UNROLL_MAX_BANDS = 64


def _stitch_one_band(carry, pr, i_start, b: BandPlan, cfg: SpecConfig,
                     first_sweep):
    """Stitch one band's spectrum ``pr`` into the global curves.

    ``b`` supplies the STATIC slice geometry (sizes, relative offsets);
    ``i_start`` may be traced (lax.scan fast path) or a Python int
    (unrolled path).  Reproduces kspecanal.py:642-668 exactly.
    """
    cur, fmax, fmin, favg = carry
    # Source-limited: the last band's s_end shrinks when it pokes past the
    # grid (kspecanal.py:626-629), so the RAW region follows the source —
    # and can be EMPTY when the clamp eats the whole fresh region (the
    # reference's numpy slice at :644 just goes empty there).
    raw_len = max(0, b.s_end - b.s_raw_start)
    ovl_len = b.i_old_end - b.i_start
    i_old_end = i_start + ovl_len
    # --- Cur stitch: RAW copy of the fresh region (:642-644)
    if raw_len > 0:
        seg = jax.lax.slice_in_dim(pr, b.s_raw_start,
                                   b.s_raw_start + raw_len)
        cur = jax.lax.dynamic_update_slice_in_dim(cur, seg, i_old_end,
                                                  axis=0)
    # --- overlap-average with the previous band (:645-649)
    if b.i_old_end != 0 and ovl_len > 0:
        new_seg = jax.lax.slice_in_dim(pr, b.s_start, b.s_start + ovl_len)
        cur_seg = jax.lax.dynamic_slice_in_dim(cur, i_start, ovl_len)
        cur = jax.lax.dynamic_update_slice_in_dim(
            cur, (cur_seg + new_seg) / 2.0, i_start, axis=0)
    # --- Max/Min/Avg source selection (:651-662)
    if cfg.b_scan_range_base_data_is_raw:
        src_len = b.s_end - b.s_start
        src_seg = jax.lax.slice_in_dim(pr, b.s_start, b.s_start + src_len)
        d0 = i_start
    else:
        src_len = b.i_done - b.i_start
        src_seg = jax.lax.dynamic_slice_in_dim(cur, i_start, src_len)
        d0 = i_start
    if cfg.b_data_max:
        old = jax.lax.dynamic_slice_in_dim(fmax, d0, src_len)
        fmax = jax.lax.dynamic_update_slice_in_dim(
            fmax, jnp.maximum(old, src_seg), d0, axis=0)
    if cfg.b_data_min:
        old = jax.lax.dynamic_slice_in_dim(fmin, d0, src_len)
        fmin = jax.lax.dynamic_update_slice_in_dim(
            fmin, jnp.minimum(old, src_seg), d0, axis=0)
    # Avg always maintained (`if d['bDataAvg'] or True`, :667)
    old = jax.lax.dynamic_slice_in_dim(favg, d0, src_len)
    favg = jax.lax.dynamic_update_slice_in_dim(
        favg, jnp.where(first_sweep, src_seg, (old + src_seg) / 2.0),
        d0, axis=0)
    return (cur, fmax, fmin, favg)


def stitch_sweep(state: ScanState, spectra_db: jax.Array, cfg: SpecConfig,
                 plan: ScanPlan,
                 adj: Optional[jax.Array] = None) -> ScanState:
    """Fold one sweep's band spectra into the global stitched curves.

    Reproduces the order-dependent merge of kspecanal.py:642-668:
      Cur:  RAW copy of [iOldEnd:iEnd] then AVG over overlap [iStart:iOldEnd]
      Max/Min/Avg: cumulated over [iStart:iDone] from stitched Cur (default)
                   or from the raw band spectrum (bScanRangeBaseDataIsRaw);
                   first sweep (runCount==0) uses RAW for Avg (:615-618).

    Large sweeps (quickFullScan: 1000+ bands) fold their uniform middle run
    through lax.scan instead of unrolling — same math, O(1) program size.

    ``adj`` is the optional signal-level baseline: the heatmap row records
    the baseline-ADJUSTED Avg (the reference's fftHM write at :697 uses the
    fftAvg that _adj_siglvls returned at :670).
    """
    first_sweep = state.sweep == 0
    carry = (state.fft_cur, state.fft_max, state.fft_min, state.fft_avg)

    def _finish(carry):
        # Shared epilogue: heatmap row from compressed adjusted Avg, once
        # per sweep (kspecanal.py:696-697), then the ring-index/sweep bump.
        cur, fmax, fmin, favg = carry
        a_avg = favg if adj is None else favg - adj
        row = dsp.compress_1d(a_avg, cfg.plt_compress_hm, cfg.x_res)
        heatmap = state.heatmap.at[state.hm_index].set(row)
        return ScanState(fmax, fmin, favg, cur, heatmap,
                         (state.hm_index + 1) % HEATMAP_ROWS,
                         state.sweep + 1)

    if plan.num_bands > _UNROLL_MAX_BANDS:
        run_start, run_len, stride = _uniform_run(plan)
        if run_len >= plan.num_bands - 3:
            # band 0 unrolled
            carry = _stitch_one_band(carry, spectra_db[0],
                                     plan.bands[0].i_start, plan.bands[0],
                                     cfg, first_sweep)
            # uniform middle via lax.scan
            b1 = plan.bands[run_start]

            def scan_body(c, xs):
                pr, i_start = xs
                return (_stitch_one_band(c, pr, i_start, b1, cfg,
                                         first_sweep), None)

            i_starts = jnp.asarray(
                [plan.bands[run_start + k].i_start for k in range(run_len)],
                jnp.int32)
            carry, _ = jax.lax.scan(
                scan_body, carry,
                (spectra_db[run_start:run_start + run_len], i_starts))
            # tail bands unrolled
            for bi in range(run_start + run_len, plan.num_bands):
                b = plan.bands[bi]
                carry = _stitch_one_band(carry, spectra_db[bi], b.i_start,
                                         b, cfg, first_sweep)
            return _finish(carry)
        # non-uniform large plan: fall through to unrolled (rare)

    # Unrolled fold (small plans): same band-stitch helper as the fast path.
    for bi, b in enumerate(plan.bands):
        carry = _stitch_one_band(carry, spectra_db[bi], b.i_start, b, cfg,
                                 first_sweep)
    return _finish(carry)


def scan_view(state: ScanState, cfg: SpecConfig, plan: ScanPlan,
              adj: Optional[jax.Array] = None) -> ScanView:
    """Display products (kspecanal.py:669-688)."""
    freqs = jnp.asarray(np.asarray(plan.freqs_all, np.float32))
    if adj is not None:
        a = (state.fft_max - adj, state.fft_min - adj,
             state.fft_avg - adj, state.fft_cur - adj)
    else:
        a = (state.fft_max, state.fft_min, state.fft_avg, state.fft_cur)
    x, max_l = dsp.compress_xy(freqs, a[0], cfg.plt_compress, cfg.x_res)
    _, min_l = dsp.compress_xy(freqs, a[1], cfg.plt_compress, cfg.x_res)
    _, avg_l = dsp.compress_xy(freqs, a[2], cfg.plt_compress, cfg.x_res)
    _, cur_l = dsp.compress_xy(freqs, a[3], cfg.plt_compress, cfg.x_res)
    return ScanView(x, max_l, min_l, avg_l, cur_l, state.heatmap)


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def sweep_step_jit(state: ScanState, iq_re, iq_im, retune_ok,
                   cfg: SpecConfig, plan: ScanPlan,
                   adj=None) -> ScanState:
    """One full sweep on-device: batched band spectra + stitch fold."""
    spectra = band_spectra(iq_re, iq_im, retune_ok, cfg)
    return stitch_sweep(state, spectra, cfg, plan, adj)


@functools.lru_cache(maxsize=32)
def _gather_stitch_plan(cfg: SpecConfig, plan: ScanPlan):
    """Static gather tables that turn a whole sweep's order-dependent
    stitch into TWO gathers + elementwise math, or None when the plan's
    geometry does not admit it.

    Derivation (vs kspecanal.py:642-668): band i's overlap-average region
    ``[iStart(i), iOldEnd(i))`` reads Cur values that band i-1 JUST wrote
    RAW (its fresh region is ``[iOldEnd(i-1), iEnd(i-1))`` and
    ``iEnd(i-1) == iOldEnd(i)``), provided ``iStart(i) >= iOldEnd(i-1)``
    — true exactly when ``scanRangeNonOverlap >= 0.5``.  Then the sweep's
    FINAL Cur at every grid position is a fixed 1- or 2-term affine
    combination of this sweep's band spectra, independent of the previous
    sweep.  Likewise each band's Max/Min/Avg read segment
    ``[iStart(i), iDone(i))`` is final when read, because band i+1's
    writes start at ``iStart(i+1) == iDone(i)`` (same int truncation) and
    its RAW region at ``iEnd(i) >= iDone(i)`` — so the per-band cumulate
    collapses to ONE elementwise update with the final Cur over
    ``[0, iDone(last))``.

    The tables are built by SIMULATING the band fold symbolically; any
    geometry the affine form cannot represent (deep overlap < 0.5, whose
    averages read 2-term entries) returns None and the caller keeps the
    sequential fold.  ``bScanRangeBaseDataIsRaw`` also disqualifies (its
    Max/Min/Avg read raw OVERLAPPING band segments in band order).
    """
    if cfg.b_scan_range_base_data_is_raw:
        return None
    total = plan.total_entries
    f = cfg.fft_size
    band1 = np.full(total, 0, np.int64)
    idx1 = np.zeros(total, np.int64)
    w1 = np.zeros(total, np.float32)
    band2 = np.zeros(total, np.int64)
    idx2 = np.zeros(total, np.int64)
    w2 = np.zeros(total, np.float32)
    written = np.zeros(total, bool)
    for bi, b in enumerate(plan.bands):
        raw_len = b.s_end - b.s_raw_start
        ovl_len = b.i_old_end - b.i_start
        if b.i_done > b.i_start + f:       # read past own write (ovl > 1)
            return None
        # RAW copy of the fresh region (kspecanal.py:642-644)
        p = np.arange(b.i_old_end, b.i_old_end + raw_len)
        band1[p] = bi
        idx1[p] = b.s_raw_start + (p - b.i_old_end)
        w1[p] = 1.0
        w2[p] = 0.0
        written[p] = True
        # overlap-average with the previous band (:645-649)
        if b.i_old_end != 0 and ovl_len > 0:
            q = np.arange(b.i_start, b.i_start + ovl_len)
            if not (written[q].all() and (w2[q] == 0.0).all()):
                return None        # 2-term entry would need a 3rd source
            w1[q] *= 0.5
            band2[q] = bi
            idx2[q] = b.s_start + (q - b.i_start)
            w2[q] = 0.5
    upd_end = plan.bands[-1].i_done
    g1 = (band1 * f + idx1).astype(np.int32)
    g2 = (band2 * f + idx2).astype(np.int32)
    return (g1, w1, g2, w2, written,
            (np.arange(total) < upd_end).astype(bool))


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def sweep_steps_jit(state: ScanState, iq_re, iq_im, retune_ok,
                    cfg: SpecConfig, plan: ScanPlan,
                    adj=None) -> ScanState:
    """S sweeps in ONE device program: iq_* (S, num_bands, full_size),
    retune_ok (S, num_bands).

    All S*num_bands band curscans run as one batched kernel dispatch (the
    expensive part).  For stitchable geometries (``_gather_stitch_plan``)
    the per-sweep band fold is replaced by two static gathers + an
    elementwise sweep fold — fully vectorized across bands; otherwise the
    order-dependent stitch folds sweep-by-sweep under ``lax.scan``.
    Exactly equivalent to S sequential ``sweep_step_jit`` calls either
    way — one FM sweep is only ~280 Ksamples, too little work to keep the
    device busy in a dispatch of its own.
    """
    s, b = iq_re.shape[:2]
    spectra = band_spectra(iq_re.reshape(s * b, -1), iq_im.reshape(s * b, -1),
                           retune_ok.reshape(s * b), cfg)
    spectra = spectra.reshape(s, b, cfg.fft_size)

    # s <= ring depth keeps the batched ring write free of duplicate
    # indices (a .at[].set with repeats has no ordering guarantee).
    tbl = _gather_stitch_plan(cfg, plan) if s <= HEATMAP_ROWS else None
    if tbl is not None:
        return _stitch_sweeps_gathered(state, spectra, cfg, plan, tbl, adj)

    def body(st, sp):
        return stitch_sweep(st, sp, cfg, plan, adj), None

    state, _ = jax.lax.scan(body, state, spectra)
    return state


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def sweep_steps_u8_jit(state: ScanState, raw, retune_ok,
                       cfg: SpecConfig, plan: ScanPlan,
                       adj=None) -> ScanState:
    """S sweeps from RAW capture bytes (S, num_bands, 2*full_size) uint8
    interleaved I/Q (octave/load_rtlsdr.m semantics): the deinterleave
    runs on-device so the host ships 2 B/sample instead of 8 — the same
    session fast path as ``zero_span_steps_u8_jit``; ``band_spectra``
    decodes the u8 planes inside the same program."""
    iq_re, iq_im = raw[..., 0::2], raw[..., 1::2]
    if cfg.b_use_psd:
        from kspecanal_tpu.parallel.stream import decode_u8_on_device
        iq_re, iq_im = decode_u8_on_device(raw)
    return sweep_steps_jit(state, iq_re, iq_im, retune_ok, cfg, plan, adj)


def _stitch_sweeps_gathered(state: ScanState, spectra: jax.Array,
                            cfg: SpecConfig, plan: ScanPlan, tbl,
                            adj: Optional[jax.Array]) -> ScanState:
    """Vectorized S-sweep stitch using the static gather plan: the
    per-band ``dynamic_update_slice`` chains become two gathers over the
    flattened (S, B*fft) spectra, and the per-sweep fold collapses to
    closed forms — NOTHING is sequential:

      * Max/Min over sweeps are single axis reductions;
      * the sequential ``(a+b)/2`` Avg decay has closed-form weights
        (cf. the zero-span batched fold), so the Avg state after EVERY
        sweep — needed for its heatmap row, kspecanal.py:696-697 — is
        one small lower-triangular (S, S) @ (S, total) matmul;
      * all S heatmap ring rows batch like zero-span's ring write
        (duplicate ring indices would race for S > HEATMAP_ROWS, so the
        session caps catch-up at the ring depth).

    Exact reference semantics incl. the first-sweep RAW Avg seed
    (kspecanal.py:615-618); equivalence-tested against the sequential
    fold in tests/test_modes.py."""
    g1, w1, g2, w2, written, upd = tbl
    s = spectra.shape[0]
    flat = spectra.reshape(s, -1)
    cur_all = (jnp.asarray(w1) * jnp.take(flat, jnp.asarray(g1), axis=1)
               + jnp.asarray(w2) * jnp.take(flat, jnp.asarray(g2), axis=1))
    wr = jnp.asarray(written)      # (total,) grid positions written per sweep
    seg = jnp.asarray(upd)         # (total,) Max/Min/Avg update region
    first = state.sweep == 0

    # Unwritten positions keep the previous Cur for every sweep.
    cur_all = jnp.where(wr[None, :], cur_all, state.fft_cur[None, :])

    fmax, fmin = state.fft_max, state.fft_min
    if cfg.b_data_max:
        fmax = jnp.where(seg, jnp.maximum(fmax, jnp.max(cur_all, axis=0)),
                         fmax)
    if cfg.b_data_min:
        fmin = jnp.where(seg, jnp.minimum(fmin, jnp.min(cur_all, axis=0)),
                         fmin)

    # Closed-form decay fold: favg after sweep k (0-based) is
    #   continuing: 2^-(k+1) * favg_prev + sum_i 2^-(k-i+1) * cur_i
    #   fresh:      2^-k * cur_0        + sum_{i>=1} 2^-(k-i+1) * cur_i
    k = np.arange(s)
    pow_cont = 2.0 ** -(k[:, None] - k[None, :] + 1.0)      # (S, S)
    tri = (k[None, :] <= k[:, None])
    w_cont = np.where(tri, pow_cont, 0.0)
    w_fresh = w_cont.copy()
    w_fresh[:, 0] = 2.0 ** -k
    wm = jnp.where(first, jnp.asarray(w_fresh, jnp.float32),
                   jnp.asarray(w_cont, jnp.float32))
    decay = jnp.where(first, jnp.zeros(s, jnp.float32),
                      jnp.asarray(2.0 ** -(k + 1.0), jnp.float32))
    favg_all = (jnp.einsum("si,it->st", wm, cur_all,
                           precision=jax.lax.Precision.HIGHEST)
                + decay[:, None] * state.fft_avg[None, :])  # (S, total)
    favg_all = jnp.where(seg[None, :], favg_all, state.fft_avg[None, :])

    a_avg = favg_all if adj is None else favg_all - adj[None, :]
    rows = jax.vmap(
        lambda d: dsp.compress_1d(d, cfg.plt_compress_hm, cfg.x_res))(a_avg)
    ring_idx = (state.hm_index + jnp.arange(s)) % HEATMAP_ROWS
    heatmap = state.heatmap.at[ring_idx].set(rows)

    return ScanState(fmax, fmin, favg_all[-1], cur_all[-1], heatmap,
                     (state.hm_index + s) % HEATMAP_ROWS, state.sweep + s)


# ---------------------------------------------------------------------------
# Per-band stepping (tpuRenderEvery band): the reference redraws all four
# curves after EVERY retune band (kspecanal.py:670-688), so a slow wide
# scan shows progress band-by-band.  These entry points let the session
# fold the (already batched) band spectra into the curves one band at a
# time, emitting an interim view per band, without recompiling per band:
# the static geometry is CANONICALIZED relative to i_start so all uniform
# bands share one compiled program.
# ---------------------------------------------------------------------------


def rel_band(b: BandPlan) -> BandPlan:
    """Canonical band template: geometry relative to ``i_start`` (which is
    passed traced), preserving the first-band ``i_old_end == 0`` flag that
    gates the overlap-average (kspecanal.py:645)."""
    return BandPlan(
        center_freq=0.0, i_start=0, i_end=b.i_end - b.i_start,
        i_done=b.i_done - b.i_start,
        i_old_end=(b.i_old_end - b.i_start) if b.i_old_end != 0 else 0,
        s_start=b.s_start, s_end=b.s_end, s_raw_start=b.s_raw_start)


@functools.partial(jax.jit, static_argnames=("cfg",))
def band_spectra_jit(iq_re, iq_im, retune_ok, cfg: SpecConfig):
    return band_spectra(iq_re, iq_im, retune_ok, cfg)


@functools.partial(jax.jit, static_argnames=("rel", "cfg"))
def band_stitch_jit(curves, pr, i_start, first_sweep, rel: BandPlan,
                    cfg: SpecConfig):
    """Stitch ONE band into the (cur, max, min, avg) curve tuple."""
    return _stitch_one_band(curves, pr, i_start, rel, cfg, first_sweep)


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def curves_view_jit(curves, heatmap, adj, cfg: SpecConfig, plan: ScanPlan):
    """Interim display view from a mid-sweep curve tuple (the per-band
    redraw of kspecanal.py:670-688; heatmap updates only per sweep)."""
    cur, fmax, fmin, favg = curves
    interim = ScanState(fmax, fmin, favg, cur, heatmap,
                        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    return scan_view(interim, cfg, plan, adj)


@functools.partial(jax.jit, static_argnames=("cfg",))
def finish_sweep_jit(state: ScanState, curves, cfg: SpecConfig, adj=None
                     ) -> ScanState:
    """Sweep epilogue on a band-stepped curve tuple: heatmap row from the
    compressed adjusted Avg + ring/sweep bump (kspecanal.py:696-697) —
    the same math as ``stitch_sweep``'s ``_finish``."""
    cur, fmax, fmin, favg = curves
    a_avg = favg if adj is None else favg - adj
    row = dsp.compress_1d(a_avg, cfg.plt_compress_hm, cfg.x_res)
    heatmap = state.heatmap.at[state.hm_index].set(row)
    return ScanState(fmax, fmin, favg, cur, heatmap,
                     (state.hm_index + 1) % HEATMAP_ROWS, state.sweep + 1)


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def scan_view_jit(state, adj, cfg: SpecConfig, plan: ScanPlan):
    """Jitted ``scan_view``: one device program instead of ~10 eager
    dispatches per rendered sweep."""
    return scan_view(state, cfg, plan, adj)
