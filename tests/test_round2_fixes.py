"""Round-2 behavioral fixes: peak-curve selection + PlotHighs console
prints (kspecanal.py:250,260,485-504), end-of-run hold
(kspecanal.py:1152-1155), checkpoint fingerprint hardening, source
exhaustion, display-chain consistency in the stream path, and GUI tests
that fire REAL matplotlib events instead of calling handlers directly.
"""
import dataclasses

import numpy as np
import pytest

from kspecanal_tpu.config import SpecConfig
from kspecanal_tpu.io.sources import FileIQSource, SynthIQSource


def _mk_cfg(**kw):
    base = dict(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                x_res=128)
    base.update(kw)
    return SpecConfig(**base).finalize()


class _CaptureRenderer:
    """Minimal renderer that records the peaks it was handed."""
    def __init__(self):
        self.calls = []

    def __call__(self, sess, view, peaks, iteration, ts):
        self.calls.append(peaks)


# ---------------------------------------------------------------------------
# plot_highs console prints + last-drawn-curve peak selection
# ---------------------------------------------------------------------------

def test_plot_highs_console_lines(capsys):
    """Each rendered frame prints the reference's PlotHighs header and one
    plotHighs:Marked line per peak (kspecanal.py:250,260)."""
    from kspecanal_tpu import session as sess_mod
    cfg = _mk_cfg()
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=3)
    r = _CaptureRenderer()
    sess = sess_mod.Session(cfg, src, renderer=r)
    sess_mod.run_zero_span(sess, max_iters=2)
    out = capsys.readouterr().out
    heads = [ln for ln in out.splitlines() if ln.startswith("PlotHighs: ")]
    marks = [ln for ln in out.splitlines()
             if ln.startswith("plotHighs:Marked: ")]
    assert len(heads) == 2
    # reference line shape: "PlotHighs: Freqs {} to {} : delta4Marking {} :
    # min {} max {}"
    assert " to " in heads[0] and ": delta4Marking " in heads[0]
    assert ": min " in heads[0] and " max " in heads[0]
    assert len(marks) >= 2  # >=1 peak marked per frame
    assert len(r.calls) == 2 and len(r.calls[0]) >= 1


def test_plot_highs_gated_on_levels_pane(capsys):
    """bPltLevels false -> plot_highs never runs (kspecanal.py:503-504)."""
    from kspecanal_tpu import session as sess_mod
    cfg = _mk_cfg(b_plt_levels=False)
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=3)
    r = _CaptureRenderer()
    sess = sess_mod.Session(cfg, src, renderer=r)
    sess_mod.run_zero_span(sess, max_iters=1)
    out = capsys.readouterr().out
    assert "PlotHighs:" not in out
    assert r.calls == [[]]


def test_peaks_use_last_drawn_curve(capsys):
    """Peaks come from the LAST enabled curve in max/min/avg/cur draw order
    (kspecanal.py:485-504 fall-through): with cur disabled the marked level
    must match the avg curve, not the cur curve."""
    from kspecanal_tpu import session as sess_mod
    from kspecanal_tpu.models import zerospan as zs
    cfg = _mk_cfg(b_data_cur=False)
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=7)
    r = _CaptureRenderer()
    sess = sess_mod.Session(cfg, src, renderer=r)
    state = sess_mod.run_zero_span(sess, max_iters=3)
    assert len(r.calls) == 3
    peaks = r.calls[-1]
    # Recompute the avg display curve for the final state
    from kspecanal_tpu.ops import dsp
    import jax.numpy as jnp
    freqs = np.fft.fftshift(
        np.fft.fftfreq(cfg.fft_size, 1.0 / cfg.sampling_rate)
        + cfg.center_freq).astype(np.float32)
    _, avg_l = dsp.compress_xy(jnp.asarray(freqs), state.fft_avg,
                               cfg.plt_compress, cfg.x_res)
    avg_l = np.asarray(avg_l)
    top = max(peaks, key=lambda p: p.level)
    assert any(abs(top.level - v) < 1e-5 for v in avg_l)
    # and it is NOT the cur curve's max (cur != avg after 3 iterations)
    assert not np.allclose(np.asarray(state.fft_cur),
                           np.asarray(state.fft_avg))


# ---------------------------------------------------------------------------
# GUI: real matplotlib events
# ---------------------------------------------------------------------------

def _click_axes(fig, ax):
    """Fire a real button_press/release MouseEvent pair at an axes center
    through the canvas callback pipeline (no direct handler calls)."""
    from matplotlib.backend_bases import MouseEvent
    fig.canvas.draw()
    x = (ax.bbox.x0 + ax.bbox.x1) / 2
    y = (ax.bbox.y0 + ax.bbox.y1) / 2
    for name in ("button_press_event", "button_release_event"):
        ev = MouseEvent(name, fig.canvas, x, y, 1)
        fig.canvas.callbacks.process(name, ev)


def test_gui_button_click_events():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    from kspecanal_tpu.gui import MatplotlibRenderer
    cfg = _mk_cfg()
    r = MatplotlibRenderer(cfg, interactive=False)
    try:
        assert r.toggles["b_data_min"] is True
        _click_axes(r.fig, r._buttons["MinLvls"].ax)
        assert r.toggles["b_data_min"] is False
        assert "MinLvls[ ]" in r._buttons["MinLvls"].label.get_text()
        # at-least-one-curve invariant via real clicks (kspecanal.py:983-984)
        for name in ("MaxLvls", "AvgLvls", "CurLvls"):
            _click_axes(r.fig, r._buttons[name].ax)
        assert r.toggles["b_data_avg"] is True
        # quit via real click
        _click_axes(r.fig, r._buttons["Quit"].ax)
        assert r.quit_requested
        assert r._buttons["Quit"].label.get_text() == "QuitWait"
    finally:
        r.close()


def test_gui_heatmap_pick_event(caplog):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    from matplotlib.backend_bases import MouseEvent
    from kspecanal_tpu import session as sess_mod
    from kspecanal_tpu.gui import MatplotlibRenderer
    cfg = _mk_cfg()
    r = MatplotlibRenderer(cfg, interactive=False)
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=4)
    sess = sess_mod.Session(cfg, src, renderer=r)
    try:
        sess_mod.run_zero_span(sess, max_iters=1)  # creates the imshow
        r.fig.canvas.draw()
        ax = r.ax_heatmap
        x = (ax.bbox.x0 + ax.bbox.x1) / 2
        y = (ax.bbox.y0 + ax.bbox.y1) / 2
        ev = MouseEvent("button_press_event", r.fig.canvas, x, y, 1)
        # route through the artist's pick machinery -> fires pick_event
        import logging
        with caplog.at_level(logging.INFO):
            r._hm_image.pick(ev)
        assert any("PickEvent:HeatMap:Freq:" in m for m in caplog.messages)
        # clicked mid-pane -> ~center frequency
        lbl = r.ax_heatmap.get_xlabel()
        assert "ClickedFreq" in lbl
    finally:
        r.close()


def test_gui_hold_until_key(monkeypatch):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    from kspecanal_tpu.gui import MatplotlibRenderer
    cfg = _mk_cfg()
    r = MatplotlibRenderer(cfg, interactive=False)
    prompts = []
    monkeypatch.setattr("builtins.input", lambda p="": prompts.append(p))
    try:
        # non-TTY stdin (the pytest default): the hold must NOT prompt,
        # or scripted runs would block forever on silent stdin.
        monkeypatch.setattr("sys.stdin.isatty", lambda: False)
        r.hold_until_key()
        assert prompts == []
        # real TTY: the reference's hold-for-key contract
        # (kspecanal.py:1152-1155) prompts and relabels the Quit button.
        monkeypatch.setattr("sys.stdin.isatty", lambda: True)
        r.hold_until_key()
        assert prompts == ["Press any key to quit..."]
        assert r._buttons["Quit"].label.get_text() == "QuitPress"
    finally:
        r.close()


# ---------------------------------------------------------------------------
# Checkpoint fingerprint hardening
# ---------------------------------------------------------------------------

def test_fingerprint_rejects_math_changes(tmp_path):
    from kspecanal_tpu.io.state import load_state, save_state
    from kspecanal_tpu.models import zerospan as zs
    cfg = _mk_cfg(window="WIN.HANNING", cur_scan_non_overlap=0.5)
    state = zs.init_state(cfg)
    p = str(tmp_path / "ck.npz")
    save_state(p, state, cfg)
    assert load_state(p, cfg) is not None
    for change in (dict(window="WIN.ONES"),
                   dict(cur_scan_non_overlap=0.25),
                   dict(cur_scan_cumu_mode="MAX")):
        other = dataclasses.replace(cfg, **change)
        assert load_state(p, other) is None, change


# ---------------------------------------------------------------------------
# Source exhaustion surfaced to the session loops
# ---------------------------------------------------------------------------

def _write_capture(tmp_path, n_samples):
    path = tmp_path / "cap.iq"
    raw = (np.arange(2 * n_samples) % 251).astype(np.uint8)
    path.write_bytes(raw.tobytes())
    return str(path)


def test_zero_span_stops_on_exhausted_source(tmp_path):
    from kspecanal_tpu import session as sess_mod
    cfg = _mk_cfg()
    # capture holds exactly 2 blocks; 3rd read exhausts (wrap disabled)
    path = _write_capture(tmp_path, 2 * cfg.full_size)
    src = FileIQSource(path, wrap=False)
    sess = sess_mod.Session(cfg, src)
    state = sess_mod.run_zero_span(sess, max_iters=50)
    assert sess.stop
    # block 1's read drains the file exactly -> exhausted flagged there;
    # that (complete) block is still processed, then the loop stops
    assert int(state.iteration) == 2


def test_scan_stops_on_exhausted_source(tmp_path):
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=98e6,
                     fft_size=256, sampling_rate=2.4e6,
                     x_res=256).finalize()
    path = _write_capture(tmp_path, 2 * cfg.full_size)
    src = FileIQSource(path, wrap=False)
    sess = sess_mod.Session(cfg, src)
    state = sess_mod.run_scan(sess, max_sweeps=50)
    assert sess.stop
    assert int(state.sweep) == 1  # stopped after the sweep that ran dry


def test_zero_span_save_stops_on_exhausted_source(tmp_path):
    from kspecanal_tpu import session as sess_mod
    cfg = dataclasses.replace(
        _mk_cfg(), zero_span_save_file=str(tmp_path / "z.save"))
    path = _write_capture(tmp_path, 3 * cfg.full_size)
    src = FileIQSource(path, wrap=False)
    sess = sess_mod.Session(cfg, src)
    written = sess_mod.run_zero_span_save(sess, max_iters=50)
    assert sess.stop
    assert written == 3  # all 3 real blocks recorded, then stop


# ---------------------------------------------------------------------------
# Stream path honors the configured display chain
# ---------------------------------------------------------------------------

def test_stream_honors_disp_proc_chain(rng):
    """waterfall_stream with a non-default zero_span_disp_proc matches the
    serial zero-span step chain (the ADVICE round-1 finding)."""
    import jax.numpy as jnp
    from kspecanal_tpu.models import zerospan as zs
    from kspecanal_tpu.parallel.stream import waterfall_stream
    cfg = _mk_cfg(zero_span_disp_proc="LogNoGain.HistLowClip",
                  cur_scan_non_overlap=0.5)
    t = 4
    re = rng.standard_normal((t, cfg.full_size)).astype(np.float32)
    im = rng.standard_normal((t, cfg.full_size)).astype(np.float32)
    res = waterfall_stream(jnp.asarray(re), jnp.asarray(im), cfg)
    state = zs.init_state(cfg)
    for i in range(t):
        state, _ = zs.zero_span_step_jit(state, jnp.asarray(re[i]),
                                         jnp.asarray(im[i]), cfg)
    np.testing.assert_allclose(np.asarray(res.fft_avg),
                               np.asarray(state.fft_avg), rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.fft_max),
                               np.asarray(state.fft_max), rtol=2e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Batched catch-up mode (tpuCatchUp)
# ---------------------------------------------------------------------------

def test_catchup_matches_serial(tmp_path):
    """run_zero_span with catch_up=K produces the exact serial state —
    curves, seeded bitmask, and every heatmap ring row at its serial
    index — for the same file source data."""
    from kspecanal_tpu import session as sess_mod
    cfg = _mk_cfg(cur_scan_non_overlap=0.5)
    path = _write_capture(tmp_path, 4 * cfg.full_size)
    n_iters = 11  # exercises a ragged final batch (11 = 2*4 + 3)
    serial = sess_mod.Session(cfg, FileIQSource(path))
    st_serial = sess_mod.run_zero_span(serial, max_iters=n_iters)
    batched = sess_mod.Session(cfg, FileIQSource(path), catch_up=4)
    st_batch = sess_mod.run_zero_span(batched, max_iters=n_iters)
    assert int(st_batch.iteration) == n_iters
    for f in st_serial._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(st_batch, f)),
            np.asarray(getattr(st_serial, f)), rtol=2e-5, atol=2e-5,
            err_msg=f)


def test_catchup_with_adj_and_resume(tmp_path):
    """Catch-up composes with the baseline adjust and a seeded (resumed)
    state: a second catch-up run continues the decay exactly like two
    serial runs."""
    import jax.numpy as jnp
    from kspecanal_tpu.models import zerospan as zs
    cfg = _mk_cfg(cur_scan_non_overlap=0.5)
    rng = np.random.default_rng(5)
    re = rng.standard_normal((6, cfg.full_size)).astype(np.float32)
    im = rng.standard_normal((6, cfg.full_size)).astype(np.float32)
    adj = rng.standard_normal(cfg.fft_size).astype(np.float32)
    # serial: 6 steps
    st = zs.init_state(cfg)
    for i in range(6):
        st, view_s = zs.zero_span_step_adj_jit(
            st, jnp.asarray(re[i]), jnp.asarray(im[i]), jnp.asarray(adj),
            cfg)
    # batched: 3 + 3 (second batch starts from a seeded state)
    sb = zs.init_state(cfg)
    sb, _ = zs.zero_span_steps_adj_jit(sb, jnp.asarray(re[:3]),
                                       jnp.asarray(im[:3]),
                                       jnp.asarray(adj), cfg)
    sb, view_b = zs.zero_span_steps_adj_jit(sb, jnp.asarray(re[3:]),
                                            jnp.asarray(im[3:]),
                                            jnp.asarray(adj), cfg)
    for f in st._fields:
        np.testing.assert_allclose(np.asarray(getattr(sb, f)),
                                   np.asarray(getattr(st, f)),
                                   rtol=2e-5, atol=2e-5, err_msg=f)
    for f in ("cur_lvls", "max_lvls", "min_lvls", "avg_lvls"):
        np.testing.assert_allclose(np.asarray(getattr(view_b, f)),
                                   np.asarray(getattr(view_s, f)),
                                   rtol=2e-5, atol=2e-5, err_msg=f)


# ---------------------------------------------------------------------------
# Multi-sweep scan batching
# ---------------------------------------------------------------------------

def test_sweep_steps_matches_sequential():
    """sweep_steps_jit (S sweeps per dispatch) == S sweep_step_jit calls,
    including the first-sweep seeding and the heatmap ring."""
    import jax.numpy as jnp
    from kspecanal_tpu.models import scan as scan_mod
    cfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=96e6,
                     fft_size=256, sampling_rate=2e6, x_res=256,
                     cur_scan_non_overlap=0.5).finalize()
    plan = scan_mod.make_scan_plan(cfg)
    b = plan.num_bands
    rng = np.random.default_rng(3)
    s = 3
    re = rng.standard_normal((s, b, cfg.full_size)).astype(np.float32)
    im = rng.standard_normal((s, b, cfg.full_size)).astype(np.float32)
    oks = np.ones((s, b), bool)
    oks[1, 2] = False  # sentinel band inside the batch
    st_seq = scan_mod.init_state(cfg, plan)
    for i in range(s):
        st_seq = scan_mod.sweep_step_jit(st_seq, jnp.asarray(re[i]),
                                         jnp.asarray(im[i]),
                                         jnp.asarray(oks[i]), cfg, plan)
    st_bat = scan_mod.init_state(cfg, plan)
    st_bat = scan_mod.sweep_steps_jit(st_bat, jnp.asarray(re),
                                      jnp.asarray(im), jnp.asarray(oks),
                                      cfg, plan)
    for f in st_seq._fields:
        np.testing.assert_allclose(np.asarray(getattr(st_bat, f)),
                                   np.asarray(getattr(st_seq, f)),
                                   rtol=2e-5, atol=2e-5, err_msg=f)


def test_scan_catchup_matches_serial(tmp_path):
    """run_scan with catch_up=S equals the serial per-sweep session."""
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=94e6,
                     fft_size=256, sampling_rate=2e6, x_res=256,
                     cur_scan_non_overlap=0.5).finalize()
    path = _write_capture(tmp_path, 64 * cfg.full_size)
    serial = sess_mod.Session(cfg, FileIQSource(path))
    st_serial = sess_mod.run_scan(serial, max_sweeps=5)
    batched = sess_mod.Session(cfg, FileIQSource(path), catch_up=2)
    st_batch = sess_mod.run_scan(batched, max_sweeps=5)
    assert int(st_batch.sweep) == 5
    for f in st_serial._fields:
        np.testing.assert_allclose(np.asarray(getattr(st_batch, f)),
                                   np.asarray(getattr(st_serial, f)),
                                   rtol=2e-5, atol=2e-5, err_msg=f)


def test_scan_sweep_prefetch_matches_serial(tmp_path):
    """Sweep-level read-ahead (io/prefetch.SweepPrefetcher) produces the
    exact same scan state as the serial driver: the worker performs the
    identical retune/read walk, only overlapped with device compute."""
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=94e6,
                     fft_size=256, sampling_rate=2e6, x_res=256,
                     cur_scan_non_overlap=0.5).finalize()
    path = _write_capture(tmp_path, 64 * cfg.full_size)
    serial = sess_mod.Session(cfg, FileIQSource(path))
    st_serial = sess_mod.run_scan(serial, max_sweeps=4)
    pre = sess_mod.Session(cfg, FileIQSource(path), sweep_prefetch=True)
    st_pre = sess_mod.run_scan(pre, max_sweeps=4)
    assert int(st_pre.sweep) == 4
    for f in st_serial._fields:
        np.testing.assert_allclose(np.asarray(getattr(st_pre, f)),
                                   np.asarray(getattr(st_serial, f)),
                                   rtol=2e-5, atol=2e-5, err_msg=f)


def test_scan_catchup_with_prefetch_matches(tmp_path):
    """catch_up=S + sweep prefetch == serial (batched fold, read-ahead
    acquisition)."""
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=92e6,
                     fft_size=256, sampling_rate=2e6, x_res=256,
                     cur_scan_non_overlap=0.5).finalize()
    path = _write_capture(tmp_path, 64 * cfg.full_size)
    serial = sess_mod.Session(cfg, FileIQSource(path))
    st_serial = sess_mod.run_scan(serial, max_sweeps=5)
    both = sess_mod.Session(cfg, FileIQSource(path), catch_up=2,
                            sweep_prefetch=True)
    st_both = sess_mod.run_scan(both, max_sweeps=5)
    assert int(st_both.sweep) == 5
    for f in st_serial._fields:
        np.testing.assert_allclose(np.asarray(getattr(st_both, f)),
                                   np.asarray(getattr(st_serial, f)),
                                   rtol=2e-5, atol=2e-5, err_msg=f)


def test_scan_sweep_prefetch_exhaustion_stops(tmp_path):
    """A non-wrapping file source running dry stops the prefetched scan
    loop gracefully (the worker forwards the exhausted flag with the
    final sweep and shuts down)."""
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=92e6,
                     fft_size=256, sampling_rate=2e6, x_res=256,
                     cur_scan_non_overlap=0.5).finalize()
    plan = sess_mod.make_plan_cached(cfg)
    # enough for ~1.5 sweeps only
    path = _write_capture(
        tmp_path, plan.num_bands * cfg.full_size + cfg.full_size)
    sess = sess_mod.Session(cfg, FileIQSource(path, wrap=False),
                            sweep_prefetch=True)
    state = sess_mod.run_scan(sess, max_sweeps=50)
    assert sess.stop
    assert int(state.sweep) < 50


def test_catchup_beyond_ring_depth_matches_serial(tmp_path):
    """catch_up > HEATMAP_ROWS (128) is exact: the batched step writes
    only the last ring-depth rows — all a sequential run would keep —
    and the curve folds' closed-form weights hold for any K (matching
    serial f32, whose decay contributions underflow past ~150 steps
    anyway)."""
    from kspecanal_tpu import session as sess_mod
    from kspecanal_tpu.config import HEATMAP_ROWS
    cfg = _mk_cfg(cur_scan_non_overlap=0.5)
    path = _write_capture(tmp_path, 8 * cfg.full_size)
    k = HEATMAP_ROWS + 37         # each batch K=165 > ring depth
    n_iters = 2 * k               # TWO batches: the second starts from a
    serial = sess_mod.Session(cfg, FileIQSource(path))   # rotated ring
    st_serial = sess_mod.run_zero_span(serial, max_iters=n_iters)
    batched = sess_mod.Session(cfg, FileIQSource(path), catch_up=k)
    assert batched.catch_up == k            # no 128 clamp
    st_batch = sess_mod.run_zero_span(batched, max_iters=n_iters)
    assert int(st_batch.iteration) == n_iters
    assert int(st_batch.hm_index) == int(st_serial.hm_index) != 0
    for f in st_serial._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(st_batch, f)),
            np.asarray(getattr(st_serial, f)), rtol=2e-5, atol=2e-5,
            err_msg=f)


class _NoRawFile:
    """FileIQSource facade without read_raw — forces the f32 ship path."""

    def __init__(self, path, **kw):
        self._inner = FileIQSource(path, **kw)

    def read(self, n):
        return self._inner.read(n)

    def retune(self, *a):
        return self._inner.retune(*a)

    def close(self):
        self._inner.close()

    @property
    def exhausted(self):
        return self._inner.exhausted


def test_zero_span_u8_and_f32_drivers_agree(tmp_path):
    """All four zero-span drivers — serial-u8, serial-f32, batched-u8,
    batched-f32 — produce the identical state on the same capture (the
    raw-capable FileIQSource silently switched the older parity tests to
    u8-vs-u8; this pins the full u8 x f32, serial x batched matrix)."""
    from kspecanal_tpu import session as sess_mod
    cfg = _mk_cfg(cur_scan_non_overlap=0.5)
    path = _write_capture(tmp_path, 8 * cfg.full_size)
    n_iters = 9

    def run(raw, catch_up):
        mk = FileIQSource if raw else _NoRawFile
        sess = sess_mod.Session(cfg, mk(path), catch_up=catch_up)
        return sess_mod.run_zero_span(sess, max_iters=n_iters)

    ref = run(False, 0)                       # serial f32
    for raw, cu, label in ((True, 0, "serial-u8"), (True, 4, "batched-u8"),
                           (False, 4, "batched-f32")):
        st = run(raw, cu)
        for f in ref._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(st, f)), np.asarray(getattr(ref, f)),
                rtol=2e-5, atol=2e-5, err_msg=f"{label}:{f}")


def test_prefetching_source_exhausted_is_per_popped_block(tmp_path):
    """A prefetch worker that has already hit EOF upstream must NOT make
    the driver stop early: exhausted reflects the block the consumer last
    popped, so every real block is processed before the graceful stop."""
    from kspecanal_tpu.io.prefetch import PrefetchingSource
    cfg = _mk_cfg(cur_scan_non_overlap=0.5)
    n_blocks = 10
    path = _write_capture(tmp_path, n_blocks * cfg.full_size)
    from kspecanal_tpu import session as sess_mod
    src = PrefetchingSource(FileIQSource(path, wrap=False),
                            block_size=cfg.full_size, depth=4)
    sess = sess_mod.Session(cfg, src)
    st = sess_mod.run_zero_span(sess, max_iters=n_blocks + 5)
    # all 10 real blocks consumed; the padded EOF block stops the loop
    assert int(st.iteration) >= n_blocks


def test_catchup_readahead_stops_on_exhausted_source(tmp_path):
    """The double-buffered catch-up driver (r4: batch k+1 stages on a
    worker thread while batch k computes) preserves the exhaustion
    contract: the batch containing EOF is processed (127-padded past
    EOF), the loop stops, and no extra staged batch is folded in."""
    from kspecanal_tpu import session as sess_mod
    cfg = _mk_cfg()
    # 5 blocks of capture, batches of 2: batch 3 (blocks 5-6) hits EOF
    path = _write_capture(tmp_path, 5 * cfg.full_size)
    src = FileIQSource(path, wrap=False)
    sess = sess_mod.Session(cfg, src, catch_up=2)
    state = sess_mod.run_zero_span(sess, max_iters=50)
    assert sess.stop
    assert int(state.iteration) == 6    # 3 batches of 2, EOF inside #3
    # the fold is batch-size independent: catch_up=3 consumes the same
    # blocks 1-6 (block 6 being the 127-fill past EOF) in 2 batches
    src2 = FileIQSource(path, wrap=False)
    sess2 = sess_mod.Session(cfg, src2, catch_up=3)
    state2 = sess_mod.run_zero_span(sess2, max_iters=50)
    assert int(state2.iteration) == 6
    np.testing.assert_allclose(np.asarray(state.fft_avg),
                               np.asarray(state2.fft_avg),
                               rtol=1e-5, atol=1e-5)
