"""Golden tests: the batched curscan chain vs the serial float64
NumPy oracle (SURVEY.md §4 strategy (b)), plus synthetic-tone bin-position
checks (strategy (a))."""
import numpy as np
import pytest
import jax.numpy as jnp

from kspecanal_tpu.config import (CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW,
                                  SpecConfig, WINDOW_HANNING, WINDOW_KAISER,
                                  WINDOW_ONES, cumu_weights, window_lut)
from kspecanal_tpu.ops.spectrum import curscan_jit, fft_freqs, psd_welch
from oracle import oracle_curscan, oracle_seq_cumulate, synth_tones


def make_iq(rng, n):
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return iq


def split_iq(iq):
    return (jnp.asarray(iq.real, jnp.float32), jnp.asarray(iq.imag, jnp.float32))


@pytest.mark.parametrize("window", [WINDOW_ONES, WINDOW_HANNING, WINDOW_KAISER])
@pytest.mark.parametrize("cumu", [CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW])
def test_curscan_matches_oracle(rng, window, cumu):
    cfg = SpecConfig(fft_size=256, sampling_rate=2.4e6, window=window,
                     cur_scan_non_overlap=0.5, cur_scan_cumu_mode=cumu)
    iq = make_iq(rng, cfg.full_size)
    got = np.asarray(curscan_jit(*split_iq(iq), cfg), np.float64)
    want = oracle_curscan(iq, cfg.fft_size, cfg.cur_scan_non_overlap,
                          window_lut(window, cfg.fft_size), cumu)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_curscan_fractional_hop(rng):
    """nonOverlap=0.1 makes the hop fractional; window starts use the
    reference's per-index int() truncation (kspecanal.py:386)."""
    cfg = SpecConfig(fft_size=250, sampling_rate=2.4e6, window=WINDOW_HANNING,
                     cur_scan_non_overlap=0.1, cur_scan_cumu_mode=CUMU_MAX)
    # fft_size=250 -> full_size = 250*8 = 2000 (fft_size < fS/8)
    assert cfg.full_size == 2000
    iq = make_iq(rng, cfg.full_size)
    got = np.asarray(curscan_jit(*split_iq(iq), cfg), np.float64)
    want = oracle_curscan(iq, 250, 0.1, window_lut(WINDOW_HANNING, 250), "MAX")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_full_size_rule():
    """kspecanal.py:926-929: x8 below fS/8, else x2."""
    # 2^14 < 2.4e6//8, so the x8 branch applies (NOT x2 — SURVEY.md §6's
    # "fullSize=2*fftSize" note is wrong; kspecanal.py:926-929 governs).
    assert SpecConfig(fft_size=2 ** 14, sampling_rate=2.4e6).full_size == 2 ** 17
    assert SpecConfig(fft_size=2 ** 19, sampling_rate=2.4e6).full_size == 2 ** 20
    assert SpecConfig(fft_size=256, sampling_rate=2.4e6).full_size == 256 * 8


def test_cumu_weights_match_sequential(rng):
    """Closed-form decay weights == serial (a+b)/2 cumulation."""
    specs = rng.standard_normal((17, 64))
    w = cumu_weights(CUMU_AVG, 17)
    np.testing.assert_allclose(w @ specs, oracle_seq_cumulate(specs, "AVG"),
                               rtol=1e-12)
    assert abs(w.sum() - 1.0) < 1e-12
    w1 = cumu_weights(CUMU_AVG, 1)
    np.testing.assert_allclose(w1 @ specs[:1], specs[0])
    wr = cumu_weights(CUMU_RAW, 5)
    np.testing.assert_allclose(wr @ specs[:5], specs[4])


def test_tone_lands_on_expected_bin(rng):
    """A tone at fS/4 must peak exactly fftSize/4 bins above center after
    fftshift (testfft.py rel_freqs semantics, SURVEY.md §4.1)."""
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=512, sampling_rate=2.4e6,
                     window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                     cur_scan_cumu_mode=CUMU_AVG).finalize()
    tone = cfg.sampling_rate / 4
    iq = synth_tones([tone], cfg.sampling_rate, cfg.full_size)
    spec = np.asarray(curscan_jit(*split_iq(iq), cfg))
    peak_bin = int(np.argmax(spec))
    freqs = fft_freqs(cfg)
    assert freqs.shape == (cfg.fft_size,)
    # testfft tones are sin + j*cos = j*e^{-j2pi f t}: a tone parameter +f
    # lands at -f in the spectrum (hence abs_freqs' `fC - cur` sign flip,
    # testfft.py:50).  fftshifted center bin = fftSize//2, so expect
    # center - N/4.
    assert peak_bin == cfg.fft_size // 2 - cfg.fft_size // 4
    assert abs((freqs[peak_bin] - cfg.center_freq) + tone) < cfg.sampling_rate / cfg.fft_size


def test_psd_welch_matches_mlab(rng):
    """bUsePSD cross-check path vs matplotlib.mlab.psd (kspecanal.py:374-384)."""
    mlab = pytest.importorskip("matplotlib.mlab")
    cfg = SpecConfig(fft_size=256, sampling_rate=2.4e6, window=WINDOW_HANNING,
                     cur_scan_non_overlap=0.5)
    iq = make_iq(rng, cfg.full_size)
    got = np.asarray(psd_welch(*split_iq(iq), cfg), np.float64)
    win = window_lut(WINDOW_HANNING, 256)
    pxx, freqs = mlab.psd(iq, NFFT=256, window=win,
                          noverlap=int(256 * (1 - 0.5)))
    # mlab returns complex-input PSD already fftshifted with freqs ascending.
    np.testing.assert_allclose(got, pxx, rtol=5e-4, atol=1e-7)


def test_random_config_sweep_matches_oracle(rng):
    """Property sweep: random (fftSize, window, overlap, cumulate) configs
    all match the serial float64 oracle."""
    windows = [WINDOW_ONES, WINDOW_HANNING, WINDOW_KAISER]
    cumus = [CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW]
    overlaps = [0.1, 0.25, 0.5, 0.75, 1.0]
    fft_sizes = [64, 128, 200, 256, 500, 1024]
    for trial in range(12):
        fft = fft_sizes[int(rng.integers(len(fft_sizes)))]
        win = windows[int(rng.integers(len(windows)))]
        cumu = cumus[int(rng.integers(len(cumus)))]
        ov = overlaps[int(rng.integers(len(overlaps)))]
        cfg = SpecConfig(fft_size=fft, sampling_rate=2.4e6, window=win,
                         cur_scan_non_overlap=ov, cur_scan_cumu_mode=cumu)
        iq = make_iq(rng, cfg.full_size)
        got = np.asarray(curscan_jit(*split_iq(iq), cfg), np.float64)
        want = oracle_curscan(iq, fft, ov, window_lut(win, fft), cumu)
        np.testing.assert_allclose(
            got, want, rtol=5e-4, atol=1e-5,
            err_msg=f"trial {trial}: fft={fft} win={win} cumu={cumu} ov={ov}")
