"""Independent float64 NumPy oracle of the reference numerics.

This is the test-side ground truth: a direct transcription of the *math*
specified by SURVEY.md §3.3 (the ``sdr_curscan`` formula), §2.1
(``data_cumu`` / ``data_proc`` semantics) and §3.4 (scan stitch index math),
kept deliberately naive/serial so the device implementation can be checked
against it within SNR bounds (BASELINE.md correctness target).

Reference derivations (file:line cited per function) — this is NOT the
production code path; the framework never imports from tests/.
"""
from __future__ import annotations

import numpy as np


def oracle_curscan(iq: np.ndarray, fft_size: int, non_overlap: float,
                   window: np.ndarray, cumu_mode: str = "AVG") -> np.ndarray:
    """Serial overlapped windowed-FFT chain (kspecanal.py:368-397):
    numLoops = int(len/ (fftSize*nonOverlap)); per window i starting at
    int(i*fftSize*nonOverlap): winAdj*2*|fft(x*win)|/fftSize; sequential
    cumulate; final fftshift."""
    full = len(iq)
    num_loops = int(full / (fft_size * non_overlap))
    win_adj = len(window) / np.sum(window)
    acc = None
    for i in range(num_loops):
        s = int(i * fft_size * non_overlap)
        e = s + fft_size
        frame = iq[s:e]
        if len(frame) < fft_size:
            break
        mag = win_adj * 2 * np.abs(np.fft.fft(frame * window)) / fft_size
        if acc is None:
            acc = mag
        elif cumu_mode == "AVG":
            acc = (acc + mag) / 2
        elif cumu_mode == "MAX":
            acc = np.maximum(acc, mag)
        elif cumu_mode == "MIN":
            acc = np.minimum(acc, mag)
        elif cumu_mode == "RAW":
            acc = mag
        else:
            raise ValueError(cumu_mode)
    return np.fft.fftshift(acc)


def oracle_log_no_gain(vals: np.ndarray, gain: float,
                       inf_to=None) -> np.ndarray:
    """kspecanal.py:106-112."""
    out = 10 * np.log10(vals) - gain
    if inf_to is not None:
        out[np.isinf(out)] = inf_to
    return out


def oracle_hist_low_clip(vals: np.ndarray) -> np.ndarray:
    """kspecanal.py:97-99: clip below 2nd np.histogram (10-bin) edge."""
    out = np.array(vals)
    hist = np.histogram(out)
    out[out < hist[1][1]] = hist[1][1]
    return out


def oracle_conv_smooth(vals: np.ndarray) -> np.ndarray:
    """kspecanal.py:113-120."""
    kern = np.kaiser(128, 64)
    out = np.convolve(vals, kern, mode="same")
    avg = np.average(out)
    out[:12] = avg
    out[-12:] = avg
    return out


def oracle_compress_1d(data: np.ndarray, mode: str, x_res: int) -> np.ndarray:
    """kspecanal.py:168-200 (with MIN implemented, not the dead branch)."""
    if mode == "RAW":
        return data
    if mode == "CONV":
        return oracle_conv_smooth(data)
    cols = len(data) // x_res
    if cols == 0:
        return data
    t = data[: x_res * cols].reshape(x_res, cols)
    if mode == "MAX":
        return np.max(t, axis=1)
    if mode == "MIN":
        return np.min(t, axis=1)
    if mode == "AVG":
        return np.average(t, axis=1)
    raise ValueError(mode)


def oracle_seq_cumulate(specs: np.ndarray, mode: str) -> np.ndarray:
    """Sequentially cumulate a (N, F) stack per kspecanal.py:124-147 with
    first-entry copy semantics."""
    acc = specs[0].copy()
    for x in specs[1:]:
        if mode == "AVG":
            acc = (acc + x) / 2
        elif mode == "MAX":
            acc = np.maximum(acc, x)
        elif mode == "MIN":
            acc = np.minimum(acc, x)
        elif mode == "RAW":
            acc = x.copy()
    return acc


def synth_tones(freqs_hz, sample_rate: float, n: int, gain_db: float = 0.0,
                t_start: float = 0.0) -> np.ndarray:
    """Deterministic multi-tone complex IQ, testfft.py:58-77 semantics:
    each tone contributes ``g*sin(2πft) + j*g*cos(2πft)`` with
    ``g = 10**(gain/10)``; times from np.linspace(tStart, tStart+dur, n)."""
    gain_mult = 10 ** (gain_db / 10)
    dur = n / sample_rate
    t = np.linspace(t_start, t_start + dur, n)
    s = np.zeros(n, dtype=complex)
    for f in freqs_hz:
        s += gain_mult * (np.sin(2 * np.pi * f * t) + 1j * np.cos(2 * np.pi * f * t))
    return s


def oracle_zero_span_iters(spectra_linear, gain: float):
    """Serial zero-span display loop over pre-computed linear curscan
    spectra (kspecanal.py:460-478): LogNoGain (no inf replacement), then
    Max/Min/Avg cumulated with None-first-copy semantics.
    Returns (fftMax, fftMin, fftAvg, fftCur) in dB."""
    fmax = fmin = favg = fcur = None
    for spec in spectra_linear:
        pr = 10 * np.log10(spec) - gain
        fcur = pr
        fmax = pr.copy() if fmax is None else np.maximum(fmax, pr)
        fmin = pr.copy() if fmin is None else np.minimum(fmin, pr)
        favg = pr.copy() if favg is None else (favg + pr) / 2
    return fmax, fmin, favg, fcur


def oracle_scan_sweeps(band_spectra_per_sweep, cfg_like):
    """Serial port of the _scan_range stitch (kspecanal.py:594-668) over
    pre-computed per-band LINEAR curscan spectra.

    ``band_spectra_per_sweep``: list over sweeps of (num_bands, fft_size)
    linear spectra.  ``cfg_like`` needs: fft_size, sampling_rate,
    start_freq, end_freq, scan_range_non_overlap, min_amp4clip, gain,
    b_scan_range_base_data_is_raw.
    Returns dict with Cur/Max/Min/Avg arrays (dB domain).
    """
    c = cfg_like
    f = c.fft_size
    span = c.sampling_rate
    num_groups = int((c.end_freq - c.start_freq) / span)
    total = num_groups * f

    def disp(vals):
        out = 10 * np.log10(vals) - c.gain
        out[np.isinf(out)] = 0
        return out

    cur = disp(np.ones(total) * c.min_amp4clip)
    fmax = cur.copy()
    favg = cur.copy()
    fmin = disp(np.ones(total))

    for run_count, spectra in enumerate(band_spectra_per_sweep):
        cumu4avg = "RAW" if run_count == 0 else "AVG"
        i = 0
        i_old_end = 0
        cur_freq = c.start_freq + span / 2
        start_freq = cur_freq - span / 2
        bi = 0
        while start_freq < c.end_freq:
            i_start = int(i * f * c.scan_range_non_overlap)
            i_end = i_start + f
            i_done = int((i + 1) * f * c.scan_range_non_overlap)
            s_start = 0
            s_end = (i_end - i_start - (i_end - total)) if i_end > total \
                else (i_end - i_start)
            fft_cur = np.clip(spectra[bi], c.min_amp4clip, None)
            fft_pr = disp(np.array(fft_cur))
            # Cur stitch :642-650
            s_raw_start = s_start + (f - (i_end - i_old_end))
            cur[i_old_end:i_end] = fft_pr[s_raw_start:s_end]
            if i_old_end != 0:
                ioe = min(i_old_end, total)
                s_avg_end = s_start + (ioe - i_start)
                cur[i_start:ioe] = (cur[i_start:ioe]
                                    + fft_pr[s_start:s_avg_end]) / 2
            i_old_end = i_end
            # Max/Min/Avg :651-668
            if c.b_scan_range_base_data_is_raw:
                src, s0, s1, d0, d1 = fft_pr, s_start, s_end, i_start, i_end
            else:
                src, s0, s1, d0, d1 = cur, i_start, i_done, i_start, i_done
            fmax[d0:d1] = np.maximum(fmax[d0:d1], src[s0:s1])
            fmin[d0:d1] = np.minimum(fmin[d0:d1], src[s0:s1])
            if cumu4avg == "RAW":
                favg[d0:d1] = src[s0:s1]
            else:
                favg[d0:d1] = (favg[d0:d1] + src[s0:s1]) / 2
            cur_freq += span * c.scan_range_non_overlap
            start_freq = cur_freq - span / 2
            i += 1
            bi += 1
    return {"Cur": cur, "Max": fmax, "Min": fmin, "Avg": favg}
