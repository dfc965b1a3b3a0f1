"""Offline batch analysis of raw rtl_sdr capture files — the accelerated
equivalent of ``octave/process_rtlsdr.m`` (which batch-decodes captures and
plots normalized spectra of several signal variants, process_rtlsdr.m:16-62).

Usage:
    python -m kspecanal_tpu.tools capture.iq [capture2.iq ...] \
        [fftSize N] [window hanning] [decimate 2048] [out spectra.npz]

For each file: decode (native C++ fast path), optionally decimate by
group-summing (the m-script's 2048-group sum, :16-25), then compute the
batched windowed-FFT average spectrum of the complex signal and of the
real/imag/abs variants the m-script studies (:27-50), saving everything to
an .npz (headless-friendly; no plotting required).
"""
from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from kspecanal_tpu.config import SpecConfig, WINDOWS
from kspecanal_tpu.io.sources import load_rtlsdr_capture
from kspecanal_tpu.ops.spectrum import curscan_auto_batched
from kspecanal_tpu.utils.logging import log_info


def _analyze_planes(re, im, cfg) -> dict:
    """All four spectrum variants from float32 planes (host path)."""
    run = jax.jit(lambda r, i: curscan_auto_batched(r, i, cfg))
    out = {"complex": np.asarray(jnp.mean(run(re, im), axis=0))}
    zero = jnp.zeros_like(re)
    out["real"] = np.asarray(jnp.mean(run(re, zero), axis=0))
    out["imag"] = np.asarray(jnp.mean(run(im, zero), axis=0))
    mag = jnp.sqrt(re ** 2 + im ** 2)
    out["abs"] = np.asarray(jnp.mean(run(mag, zero), axis=0))
    return out


def analyze_capture(path: str, fft_size: int = 2048,
                    window: str = "WIN.HANNING",
                    decimate: Optional[int] = None) -> dict:
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft_size,
                     window=window).finalize()
    full = cfg.full_size
    if decimate:
        # group-sum decimation (process_rtlsdr.m:16-25), host-side
        re, im = load_rtlsdr_capture(path)
        n = (len(re) // decimate) * decimate
        re = re[:n].reshape(-1, decimate).sum(axis=1)
        im = im[:n].reshape(-1, decimate).sum(axis=1)
        t = len(re) // full
        if t == 0:
            raise ValueError(f"{path}: capture shorter than one block "
                             f"({full})")
        out = _analyze_planes(
            jnp.asarray(re[: t * full].reshape(t, full), jnp.float32),
            jnp.asarray(im[: t * full].reshape(t, full), jnp.float32), cfg)
    else:
        # RAW-byte ingest: ship uint8 (2 B/sample, 4x less than f32
        # planes) and decode on device — host->device transfer dominates
        # offline analysis wall time (parallel/stream.decode_u8_on_device).
        raw = np.fromfile(path, np.uint8)
        t = (len(raw) // 2) // full
        if t == 0:
            raise ValueError(f"{path}: capture shorter than one block "
                             f"({full})")
        blocks = jnp.asarray(raw[: t * 2 * full].reshape(t, 2 * full))

        @jax.jit
        def run_all(rw):
            from kspecanal_tpu.parallel.stream import decode_u8_on_device
            re, im = decode_u8_on_device(rw)
            zero = jnp.zeros_like(re)
            mag = jnp.sqrt(re ** 2 + im ** 2)
            return (jnp.mean(curscan_auto_batched(re, im, cfg), axis=0),
                    jnp.mean(curscan_auto_batched(re, zero, cfg), axis=0),
                    jnp.mean(curscan_auto_batched(im, zero, cfg), axis=0),
                    jnp.mean(curscan_auto_batched(mag, zero, cfg), axis=0))

        c, r, i, a = run_all(blocks)
        out = {"complex": np.asarray(c), "real": np.asarray(r),
               "imag": np.asarray(i), "abs": np.asarray(a)}
    out["num_blocks"] = t
    out["fft_size"] = fft_size
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    files, fft_size, window, decimate, out_path = [], 2048, "WIN.HANNING", None, None
    i = 0
    while i < len(args):
        a = args[i]
        if a.upper() == "FFTSIZE":
            i += 1; fft_size = int(args[i])
        elif a.upper() == "WINDOW":
            i += 1; window = f"WIN.{args[i].upper()}"
            assert window in WINDOWS, window
        elif a.upper() == "DECIMATE":
            i += 1; decimate = int(args[i])
        elif a.upper() == "OUT":
            i += 1; out_path = args[i]
        else:
            files.append(a)
        i += 1
    if not files:
        print(__doc__)
        return 1
    results = {}
    for path in files:
        r = analyze_capture(path, fft_size, window, decimate)
        log_info(f"{path}: {r['num_blocks']} blocks, fftSize {fft_size}, "
                 f"peak {float(np.max(r['complex'])):.3e}")
        for k, v in r.items():
            results[f"{path}:{k}"] = v
    if out_path:
        np.savez(out_path, **results)
        log_info(f"saved {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
