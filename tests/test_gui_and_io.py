"""Headless GUI smoke tests (Agg backend) + IO format tests."""
import numpy as np
import pytest

from kspecanal_tpu.config import SpecConfig
from kspecanal_tpu.io.sources import (FileIQSource, SynthIQSource,
                                      load_rtlsdr_capture)
from kspecanal_tpu.ops.peaks import find_peaks


def test_rawiq_capture_roundtrip(tmp_path):
    """uint8 interleaved, value-127 offset (octave/load_rtlsdr.m:8-13)."""
    path = tmp_path / "cap.iq"
    raw = np.array([127, 127, 227, 27, 0, 255], np.uint8)  # 3 samples
    path.write_bytes(raw.tobytes())
    re, im = load_rtlsdr_capture(str(path))
    np.testing.assert_allclose(re, [0, 100, -127])
    np.testing.assert_allclose(im, [0, -100, 128])
    # offset/count in complex samples
    re2, im2 = load_rtlsdr_capture(str(path), count=1, offset=1)
    np.testing.assert_allclose(re2, [100])
    np.testing.assert_allclose(im2, [-100])


def test_file_source_wraps(tmp_path):
    path = tmp_path / "cap.iq"
    raw = (np.arange(16, dtype=np.uint8) + 120)
    path.write_bytes(raw.tobytes())  # 8 complex samples
    src = FileIQSource(str(path))
    re, im = src.read(20)  # wraps 2.5x
    assert len(re) == 20
    np.testing.assert_allclose(re[:8], re[8:16])


def test_synth_source_tone_positions(rng):
    """abs_freqs grid: tones at every integer MHz in band (testfft.py:36-55)."""
    src = SynthIQSource(center_freq=92e6, sample_rate=2.4e6, gain=0.0, seed=1)
    tones = src.grid_tones()
    # band 90.8-93.2 MHz -> tones at 91,92,93 MHz = offsets +1e6, 0, -1e6
    assert sorted(tones.tolist()) == [-1e6, 0.0, 1e6]
    re, im = src.read(4096)
    assert re.dtype == np.float32 and len(re) == 4096


def test_find_peaks_separation():
    freqs = np.linspace(0.0, 1.0, 101)
    levels = np.zeros(101)
    levels[50] = 10.0
    levels[51] = 9.0   # within min separation of the top peak -> skipped
    levels[80] = 8.0
    peaks = find_peaks(freqs, levels, num_markers=2, delta4marking=0.025)
    assert len(peaks) == 2
    assert abs(peaks[0].freq - 0.50) < 1e-9
    assert abs(peaks[1].freq - 0.80) < 1e-9


def test_gui_headless_smoke(rng):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    import jax.numpy as jnp
    from kspecanal_tpu.gui import MatplotlibRenderer
    from kspecanal_tpu.models import zerospan as zs
    from kspecanal_tpu import session as sess_mod

    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                     x_res=128).finalize()
    r = MatplotlibRenderer(cfg, interactive=False)
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=2)
    sess = sess_mod.Session(cfg, src, renderer=r)
    sess_mod.run_zero_span(sess, max_iters=2)
    # toggle a curve off and re-apply
    r.toggles["b_data_min"] = False
    cfg2 = r.apply_toggles(cfg)
    assert cfg2.b_data_min is False
    # quit path
    r.quit_requested = True
    sess_mod.run_zero_span(sess, max_iters=2)
    assert sess.stop
    r.close()


def test_native_decoder_matches_numpy(rng):
    """Native C++ ingest == NumPy decode (and sources.py uses it)."""
    native_iq = pytest.importorskip("kspecanal_tpu.io.native_iq")
    try:
        raw = rng.integers(0, 256, size=2 * 4096).astype(np.uint8)
        re, im = native_iq.decode_u8_iq(raw)
    except OSError:
        pytest.skip("native build unavailable")
    x = raw.astype(np.float32) - 127.0
    np.testing.assert_allclose(re, x[0::2])
    np.testing.assert_allclose(im, x[1::2])
    z = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    re2, im2 = native_iq.split_complex64(z)
    np.testing.assert_allclose(re2, z.real)
    np.testing.assert_allclose(im2, z.imag)


def test_prefetching_source(rng):
    from kspecanal_tpu.io.prefetch import PrefetchingSource
    inner = SynthIQSource(center_freq=92e6, sample_rate=2.4e6, seed=5)
    src = PrefetchingSource(inner, block_size=4096, depth=2)
    try:
        re, im = src.read(4096)
        assert re.shape == (4096,) and re.dtype == np.float32
        # pass-through for non-block sizes
        re2, im2 = src.read(100)
        assert re2.shape == (100,)
        # retune flushes and still works
        assert src.retune(95e6, 2.4e6, 10.0)
        assert src.center_freq == 95e6
        re3, _ = src.read(4096)
        assert re3.shape == (4096,)
    finally:
        src.close()


def test_prefetching_source_in_session(rng):
    from kspecanal_tpu.io.prefetch import PrefetchingSource
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                     x_res=128).finalize()
    src = PrefetchingSource(
        SynthIQSource(center_freq=cfg.center_freq,
                      sample_rate=cfg.sampling_rate, seed=6),
        block_size=cfg.full_size)
    try:
        sess = sess_mod.Session(cfg, src)
        state = sess_mod.run_zero_span(sess, max_iters=4)
        assert int(state.iteration) == 4
    finally:
        src.close()


def test_toggles_applied_at_step_boundary(rng):
    """Flipping a curve button mid-run changes the effective config for
    subsequent steps (applied between iterations, not mid-step)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    from kspecanal_tpu.gui import MatplotlibRenderer
    from kspecanal_tpu import session as sess_mod

    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                     x_res=128).finalize()
    r = MatplotlibRenderer(cfg, interactive=False)
    calls = {"n": 0}
    orig_call = r.__call__

    def counting_call(sess, view, peaks, i, ts):
        calls["n"] += 1
        if calls["n"] == 2:
            r.toggles["b_data_min"] = False  # simulate button press
        orig_call(sess, view, peaks, i, ts)

    r_wrapper = counting_call
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=9)
    sess = sess_mod.Session(cfg, src, renderer=None)
    # attach manually so _emit uses the wrapper but apply_toggles the real r
    class R:
        def __call__(self, *a):
            return r_wrapper(*a)
        def apply_toggles(self, c):
            return r.apply_toggles(c)
    sess.renderer = R()
    sess_mod.run_zero_span(sess, max_iters=4)
    assert sess.cfg.b_data_min is False
    r.close()


def test_state_checkpoint_roundtrip(tmp_path, rng):
    import jax.numpy as jnp
    from kspecanal_tpu.io.state import load_state, save_state
    from kspecanal_tpu.models import zerospan as zs
    from kspecanal_tpu import session as sess_mod

    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                     x_res=128).finalize()
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=13)
    sess = sess_mod.Session(cfg, src)
    state = sess_mod.run_zero_span(sess, max_iters=3)
    p = str(tmp_path / "ckpt.npz")
    save_state(p, state, cfg)
    restored = load_state(p, cfg)
    assert restored is not None
    for f in state._fields:
        np.testing.assert_array_equal(np.asarray(getattr(restored, f)),
                                      np.asarray(getattr(state, f)))
    # mismatched config -> refused
    import dataclasses
    other = dataclasses.replace(cfg, fft_size=256, x_res=256)
    assert load_state(p, other) is None


def test_batch_analyzer(tmp_path, rng):
    """tools.analyze_capture: decode, optional decimation, spectra variants
    (octave/process_rtlsdr.m parity)."""
    from kspecanal_tpu import tools
    raw = rng.integers(0, 256, size=2 * 150_000).astype(np.uint8)
    p = str(tmp_path / "cap.iq")
    raw.tofile(p)
    r = tools.analyze_capture(p, fft_size=128)
    assert r["complex"].shape == (128,)
    assert set(r) >= {"complex", "real", "imag", "abs", "num_blocks"}
    r2 = tools.analyze_capture(p, fft_size=64, decimate=4)
    assert r2["num_blocks"] == (150_000 // 4) // (64 * 8)
    out = str(tmp_path / "spectra.npz")
    assert tools.main([p, "fftSize", "128", "out", out]) == 0
    z = np.load(out)
    assert f"{p}:complex" in z


def test_terminal_renderer(rng):
    import io as io_mod
    from kspecanal_tpu.render_term import TerminalRenderer
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                     x_res=128).finalize()
    buf = io_mod.StringIO()
    r = TerminalRenderer(cfg, width=60, stream=buf)
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=17)
    sess = sess_mod.Session(cfg, src, renderer=r)
    sess_mod.run_zero_span(sess, max_iters=3)
    out = buf.getvalue()
    assert "iter 2" in out
    assert "max |" in out and "wf  |" in out
    assert "peaks:" in out


def test_terminal_renderer_inf_nan_safe():
    """Regression: -inf (LogNoGain of a zero bin) and flat curves poisoned
    the glyph-index cast (NaN -> huge int -> IndexError)."""
    from kspecanal_tpu.render_term import shade_row, sparkline
    v = np.array([-np.inf, -80.0, 0.0, np.nan, 5.0])
    assert len(sparkline(v, 5, -np.inf, np.inf)) == 5
    assert len(shade_row(v, 5, 0.0, 0.0)) == 5      # lo == hi
    flat = np.zeros(16)
    assert len(sparkline(flat, 8, 0.0, 0.0)) == 8
    all_bad = np.full(4, -np.inf)
    assert len(sparkline(all_bad, 4, -np.inf, -np.inf)) == 4


def test_native_streaming_source(tmp_path, rng):
    """Native ring-buffer capture reader == FileIQSource decode+wrap."""
    pytest.importorskip("kspecanal_tpu.io.native_iq")
    from kspecanal_tpu.io import sources
    raw = rng.integers(0, 256, size=2 * 3000).astype(np.uint8)
    p = tmp_path / "cap.iq"
    p.write_bytes(raw.tobytes())
    try:
        src = sources.StreamingFileIQSource(str(p))
    except OSError:
        pytest.skip("native build unavailable")
    ref = sources.FileIQSource(str(p))
    try:
        for _ in range(5):  # crosses EOF wrap
            re, im = src.read(1024)
            rre, rim = ref.read(1024)
            np.testing.assert_array_equal(re, rre)
            np.testing.assert_array_equal(im, rim)
    finally:
        src.close()


def test_replay_of_reference_written_save():
    """Golden cross-implementation fixture: tests/fixtures/
    reference_zerospan_1024.save was recorded by RUNNING the reference
    program itself (kspecanal.py zeroSpanSave on its testfft simulator,
    fftSize 1024, centerFreq 92e6 — see scripts/crosscheck_reference.py).
    Our player must parse it and the simulator's integer-MHz tones must
    land on MHz bins through our display chain."""
    import os
    from kspecanal_tpu.io.replay import ZeroSpanPlayer
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "reference_zerospan_1024.save")
    p = ZeroSpanPlayer(path)
    assert (p.header.center_freq, p.header.sampling_rate,
            p.header.gain) == (92e6, 2.4e6, 19.1)
    frames = list(p.frames())
    p.close()
    assert len(frames) == 6 and len(frames[0][1]) == 1024
    freqs = np.fft.fftshift(np.fft.fftfreq(1024, 1 / 2.4e6)) + 92e6
    spec = np.asarray(frames[-1][1])
    for f in freqs[np.argsort(spec)[-3:]]:
        assert abs(f - round(f / 1e6) * 1e6) < 2.4e6 / 1024


def test_png_renderer_writes_frames(tmp_path, rng):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    from kspecanal_tpu.gui import MatplotlibRenderer
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                     x_res=128).finalize()
    r = MatplotlibRenderer(cfg, interactive=False, save_dir=str(tmp_path))
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=3)
    sess = sess_mod.Session(cfg, src, renderer=r)
    sess_mod.run_zero_span(sess, max_iters=2)
    r.close()
    frames = sorted(tmp_path.glob("frame_*.png"))
    assert len(frames) == 2 and frames[0].stat().st_size > 1000


def test_device_synth_source():
    """DeviceSynthIQSource: on-device tone synthesis with testfft grid
    semantics — deterministic per seed, tones land on the MHz gridlines,
    and the catch-up session consumes its device batches directly."""
    import jax.numpy as jnp
    from kspecanal_tpu import session as sess_mod
    from kspecanal_tpu.config import SpecConfig
    from kspecanal_tpu.io.sources import DeviceSynthIQSource
    from kspecanal_tpu.ops.spectrum import curscan_jit, fft_freqs

    cfg = SpecConfig(prg_mode="ZEROSPAN", center_freq=92e6,
                     sampling_rate=2.4e6, fft_size=1024, x_res=256,
                     cur_scan_non_overlap=0.5).finalize()
    a = DeviceSynthIQSource(center_freq=92e6, sample_rate=2.4e6, seed=7)
    b = DeviceSynthIQSource(center_freq=92e6, sample_rate=2.4e6, seed=7)
    ra, ia = a.read_device_batch(2, cfg.full_size)
    rb, ib = b.read_device_batch(2, cfg.full_size)
    assert ra.shape == (2, cfg.full_size)
    np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb))
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    # tone positions: peaks at 91/92/93 MHz gridlines
    spec = np.asarray(curscan_jit(ra[0], ia[0], cfg))
    freqs = fft_freqs(cfg)
    top = freqs[np.argsort(spec)[-3:]]
    assert {round(f / 1e6) for f in top} == {91, 92, 93}
    for f in top:
        assert abs(f - round(f / 1e6) * 1e6) < cfg.sampling_rate / cfg.fft_size
    # end-to-end: the catch-up loop consumes device batches
    sess = sess_mod.Session(cfg, DeviceSynthIQSource(92e6, 2.4e6, seed=3),
                            catch_up=4)
    state = sess_mod.run_zero_span(sess, max_iters=8)
    assert int(state.iteration) == 8
    assert np.isfinite(np.asarray(state.fft_avg)).all()


def test_sweep_prefetcher_propagates_worker_error():
    """ADVICE r2 (medium): a source error on the read-ahead thread must
    re-raise from get() instead of hanging the scan loop forever; and the
    credit bound caps how far the worker advances a reused source."""
    import time as _time
    from kspecanal_tpu.config import SpecConfig
    from kspecanal_tpu.io.prefetch import SweepPrefetcher
    from kspecanal_tpu.models import scan as scan_mod

    cfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=92e6,
                     sampling_rate=2e6, fft_size=128, x_res=128,
                     cur_scan_non_overlap=0.5).finalize()
    plan = scan_mod.make_scan_plan(cfg)

    class BoomSource:
        center_freq, sample_rate, gain = 92e6, 2e6, 19.1
        exhausted = False

        def __init__(self):
            self.reads = 0

        def read(self, n):
            self.reads += 1
            if self.reads > len(plan.bands):   # sweep 2 blows up
                raise OSError("usb gone")
            return (np.zeros(n, np.float32), np.zeros(n, np.float32))

        def retune(self, *a):
            return True

        def close(self):
            pass

    src = BoomSource()
    pf = SweepPrefetcher(src, cfg, plan, depth=2)
    ok = pf.get()                  # sweep 1 acquired fine
    assert ok[0].shape == (plan.num_bands, cfg.full_size)
    with pytest.raises(OSError):
        pf.get()                   # worker's error surfaces here
    pf.close()

    # credit/limit bound: with limit=1 the worker acquires exactly one
    # sweep and leaves the source untouched past it
    src2 = BoomSource()
    pf2 = SweepPrefetcher(src2, cfg, plan, depth=4, limit=1)
    pf2.get()
    _time.sleep(0.3)               # worker would free-run here if unbounded
    assert src2.reads == len(plan.bands)
    pf2.close()


def test_decimating_source():
    """DecimatingSource (reference TODO, README.rst:612-622): reads
    factor*n inner samples at factor*rate, merges each group by
    sum/(factor/2), passes retunes through at the raw rate."""
    from kspecanal_tpu.io.sources import DecimatingSource

    class RampSource:
        center_freq, sample_rate, gain = 92e6, 9.6e6, 10.0
        retunes = []

        def read(self, n):
            x = np.arange(n, dtype=np.float32)
            return x, -x

        def retune(self, fc, fs, gain):
            self.retunes.append((fc, fs, gain))
            return True

        def close(self):
            pass

    src = DecimatingSource(RampSource(), 4)
    assert src.sample_rate == 2.4e6
    re, im = src.read(8)
    assert len(re) == 8
    # group g sums inner samples 4g..4g+3 -> (16g + 6) / 2
    want = (16.0 * np.arange(8) + 6.0) / 2.0
    np.testing.assert_allclose(re, want)
    np.testing.assert_allclose(im, -want)
    src.retune(90e6, 2.4e6, 19.1)
    assert RampSource.retunes[-1] == (90e6, 9.6e6, 19.1)


def test_zero_span_edge_skip_bins(rng):
    """tpuEdgeSkipBins floors the outer K display bins (reference TODO,
    README.rst:608-611): peaks never land there, heatmap rows are edge-
    floored, cumulated state stays full-width; serial == batched."""
    import dataclasses
    import jax.numpy as jnp
    from kspecanal_tpu.config import SpecConfig
    from kspecanal_tpu.models import zerospan as zs

    cfg = SpecConfig(prg_mode="ZEROSPAN", center_freq=92e6,
                     sampling_rate=2.4e6, fft_size=256, x_res=256,
                     cur_scan_non_overlap=0.5,
                     tpu_edge_skip_bins=8).finalize()
    re = jnp.asarray(rng.standard_normal((4, cfg.full_size)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((4, cfg.full_size)), jnp.float32)
    st = zs.init_state(cfg)
    for i in range(4):
        st, view = zs.zero_span_step_jit(st, re[i], im[i], cfg)
    # x_res == fft_size -> MAX compress is identity: the outer 8 display
    # points equal the inner minimum exactly
    cur = np.asarray(view.cur_lvls)
    floor = cur[8:-8].min()
    assert np.all(cur[:8] == floor) and np.all(cur[-8:] == floor)
    # state stays full-width (not floored)
    assert not np.all(np.asarray(st.fft_cur)[:8]
                      == np.asarray(st.fft_cur)[8:-8].min())
    # batched path agrees with serial
    stb = zs.init_state(cfg)
    stb, viewb = zs.zero_span_steps_jit(stb, re, im, cfg)
    np.testing.assert_allclose(np.asarray(viewb.cur_lvls), cur,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(stb.heatmap[:4]),
                               np.asarray(st.heatmap[:4]),
                               rtol=1e-5, atol=1e-5)
    # and the no-skip config still differs at the edges
    cfg0 = dataclasses.replace(cfg, tpu_edge_skip_bins=0)
    st0 = zs.init_state(cfg0)
    for i in range(4):
        st0, view0 = zs.zero_span_step_jit(st0, re[i], im[i], cfg0)
    assert not np.all(np.asarray(view0.cur_lvls)[:8] == floor)


def test_devicesynth_phase_precision():
    """Regression: the device synth's phase must be computed with the
    int32 fixed-point accumulator — a float32 ``2*pi*f*t`` phase (~1e7
    rad, ulp ~1 rad) buries the tones in quantization noise.  Demand
    >= 120 dB windowed peak/median-floor, near the host source's f64
    math, and tones on the MHz grid."""
    from kspecanal_tpu.io.sources import DeviceSynthIQSource
    src = DeviceSynthIQSource(center_freq=92e6, sample_rate=2.4e6,
                              gain=0.5, seed=3)
    n = 16384
    re, im = src.read(n)
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    spec = np.abs(np.fft.fftshift(np.fft.fft(x * np.hanning(n))))
    freqs = np.fft.fftshift(np.fft.fftfreq(n, 1 / 2.4e6)) + 92e6
    ratio_db = 20 * np.log10(spec.max() / np.median(spec))
    assert ratio_db > 120.0, f"tone purity collapsed: {ratio_db:.1f} dB"
    top3 = sorted(round(f / 1e6, 3) for f in freqs[np.argsort(spec)[-3:]])
    assert top3 == [91.0, 92.0, 93.0], top3


def test_streaming_source_read_raw(tmp_path, rng):
    """StreamingFileIQSource.read_raw: raw-mode native ring returns the
    undecoded u8 bytes (so the CLI's preferred file source keeps the
    session's 2 B/sample ship path), wrapping at EOF."""
    pytest.importorskip("kspecanal_tpu.io.native_iq")
    from kspecanal_tpu.io import sources
    raw = rng.integers(0, 256, size=2 * 3000).astype(np.uint8)
    p = tmp_path / "cap.iq"
    p.write_bytes(raw.tobytes())
    try:
        src = sources.StreamingFileIQSource(str(p))
    except OSError:
        pytest.skip("native build unavailable")
    try:
        got = src.read_raw(1024)
        np.testing.assert_array_equal(got, raw[:2048])
        got2 = src.read_raw(1024)
        np.testing.assert_array_equal(got2, raw[2048:4096])
        # crosses EOF: wraps to the file start
        got3 = src.read_raw(1024)
        np.testing.assert_array_equal(got3[:2 * 952], raw[4096:])
        np.testing.assert_array_equal(got3[2 * 952:], raw[:2 * 72])
    finally:
        src.close()


def test_prefetching_source_carries_raw(tmp_path, rng):
    """PrefetchingSource preserves the raw-u8 ship path for raw-capable
    sources: read_raw pops prefetched raw blocks identical to the
    unwrapped source, and read() decodes the same stream."""
    from kspecanal_tpu.io.prefetch import PrefetchingSource
    from kspecanal_tpu.io.sources import FileIQSource
    raw = rng.integers(0, 256, size=2 * 4096).astype(np.uint8)
    p = tmp_path / "cap.iq"
    p.write_bytes(raw.tobytes())
    src = PrefetchingSource(FileIQSource(str(p)), block_size=1024)
    assert hasattr(src, "read_raw")
    try:
        got = np.concatenate([src.read_raw(1024) for _ in range(3)])
        np.testing.assert_array_equal(got, raw[:3 * 2048])
    finally:
        src.close()
    # a non-raw inner source must NOT grow a read_raw
    class PlanesOnly:
        def read(self, n):
            return (np.zeros(n, np.float32), np.zeros(n, np.float32))
        def retune(self, *a):
            return True
        def close(self):
            pass
    src2 = PrefetchingSource(PlanesOnly(), block_size=64)
    try:
        assert not hasattr(src2, "read_raw")
        re, im = src2.read(64)
        assert re.shape == (64,)
    finally:
        src2.close()


def test_streaming_source_mode_switch_keeps_position(tmp_path, rng):
    """Switching between read() and read_raw() (or changing block size)
    reopens the native stream AT the consumer's position instead of
    rewinding the capture to the start (round-4 advisor fix): the
    producer thread reads ahead, so a naive reopen would replay data."""
    pytest.importorskip("kspecanal_tpu.io.native_iq")
    from kspecanal_tpu.io import sources
    raw = rng.integers(0, 256, size=2 * 5000).astype(np.uint8)
    p = tmp_path / "cap.iq"
    p.write_bytes(raw.tobytes())
    try:
        src = sources.StreamingFileIQSource(str(p))
    except OSError:
        pytest.skip("native build unavailable")
    try:
        # raw -> decoded switch resumes where the raw reads stopped
        np.testing.assert_array_equal(src.read_raw(1024), raw[:2048])
        re, im = src.read(512)
        want = raw[2048:2048 + 1024].astype(np.float32) - 127.0
        np.testing.assert_array_equal(re, want[0::2])
        np.testing.assert_array_equal(im, want[1::2])
        # decoded -> raw with a DIFFERENT block size: still continuous
        np.testing.assert_array_equal(src.read_raw(256),
                                      raw[3072:3072 + 512])
        # block-size change within one mode: continuous too
        np.testing.assert_array_equal(src.read_raw(100),
                                      raw[3584:3584 + 200])
    finally:
        src.close()


def test_device_noise_source():
    """DeviceNoiseIQSource: uniform u8 ADC-style device planes (raw
    capture semantics), decoded f32 on the host read() protocol, seeded
    determinism, per-read fresh data, and session-driver compatibility
    (read_device_batch protocol like devicesynth)."""
    from kspecanal_tpu.io.sources import DeviceNoiseIQSource
    import jax.numpy as jnp
    src = DeviceNoiseIQSource(gain=0.5, seed=7)
    re, im = src.read_device_batch(4, 2048)
    assert re.shape == (4, 2048) and re.dtype == jnp.uint8
    x = np.asarray(re).astype(np.float64)
    assert 110 < np.mean(x) < 145                # ~uniform over [0, 255]
    assert np.std(x) > 50                        # actually random
    re2, _ = src.read_device_batch(4, 2048)
    assert not np.array_equal(np.asarray(re), np.asarray(re2))
    # seeded determinism
    s2 = DeviceNoiseIQSource(gain=0.5, seed=7)
    re3, _ = s2.read_device_batch(4, 2048)
    np.testing.assert_array_equal(np.asarray(re), np.asarray(re3))
    # host protocol decodes (value-127 offset)
    hr, hi = s2.read(1024)
    assert hr.dtype == np.float32
    assert -127.0 <= hr.min() and hr.max() <= 128.0
    # drives the real session loop (batched u8 device planes)
    from kspecanal_tpu import session as sess_mod
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256, sampling_rate=2.4e6,
                     x_res=256).finalize()
    sess = sess_mod.Session(cfg, DeviceNoiseIQSource(seed=1), catch_up=4)
    state = sess_mod.run_zero_span(sess, max_iters=8)
    assert int(state.iteration) == 8
    assert np.all(np.isfinite(np.asarray(state.fft_avg)))
    # the u8 planes through the batched fold == the SAME planes decoded
    # on the host through the f32 fold (device decode parity)
    from kspecanal_tpu.models import zerospan as zs
    s3 = DeviceNoiseIQSource(seed=3)
    bre, bim = s3.read_device_batch(4, cfg.full_size)
    st_u8, _ = zs.zero_span_steps_jit(zs.init_state(cfg), bre, bim, cfg)
    st_f32, _ = zs.zero_span_steps_jit(
        zs.init_state(cfg),
        jnp.asarray(np.asarray(bre).astype(np.float32) - 127.0),
        jnp.asarray(np.asarray(bim).astype(np.float32) - 127.0), cfg)
    np.testing.assert_allclose(np.asarray(st_u8.fft_avg),
                               np.asarray(st_f32.fft_avg),
                               rtol=1e-5, atol=1e-5)


def test_sincos_from_phase_u32_accuracy():
    """The synth's integer-quadrant sincos matches float64 ground truth
    to < 5e-7 absolute over the whole u32 phase circle (the polynomial
    truncation bound), including the wrap/quadrant boundaries."""
    import jax.numpy as jnp
    from kspecanal_tpu.io.sources import _sincos_from_phase_u32
    rng = np.random.default_rng(91)
    # dense random coverage + every boundary neighborhood
    edges = np.array([0, 1, 2**30 - 1, 2**30, 2**30 + 1,
                      2**31 - 1, 2**31, 3 * 2**30, 2**32 - 1,
                      2**29, 3 * 2**29, 5 * 2**29, 7 * 2**29],
                     dtype=np.uint64)
    ph = np.concatenate([rng.integers(0, 2**32, 20000, dtype=np.uint64),
                         edges]).astype(np.uint32)
    s, c = _sincos_from_phase_u32(jnp.asarray(ph))
    ang = ph.astype(np.float64) * (2.0 * np.pi / 2.0**32)
    np.testing.assert_allclose(np.asarray(s), np.sin(ang), atol=5e-7)
    np.testing.assert_allclose(np.asarray(c), np.cos(ang), atol=5e-7)


def test_split_u8_planes_native_matches_numpy(rng):
    """Host-side raw split (native C++ iq_split_u8, NumPy fallback):
    undecoded u8 planes, any leading shape, exact byte parity."""
    from kspecanal_tpu.io.sources import split_u8_planes
    for shape in ((2 * 5000,), (4, 2 * 1024), (2, 3, 2 * 256)):
        raw = rng.integers(0, 256, shape, dtype=np.uint8)
        re, im = split_u8_planes(raw)
        assert re.dtype == np.uint8
        assert re.shape == shape[:-1] + (shape[-1] // 2,)
        np.testing.assert_array_equal(re, raw[..., 0::2])
        np.testing.assert_array_equal(im, raw[..., 1::2])
