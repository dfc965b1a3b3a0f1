#!/usr/bin/env python3
"""Benchmark: IQ samples/s/chip through the windowed-FFT + waterfall chain
(the BASELINE.json primary metric).

Measures the flagship streaming-waterfall pipeline (BASELINE.json config 2
geometry: fftSize 2048, kaiser window, 50% overlap; plus the 64-4096 sweep)
on the available accelerator, against the serial float64 NumPy oracle of
the reference math (kspecanal.py:368-397 + display chain) run on this
host's CPU — the reference publishes no numbers, so the CPU oracle IS the
baseline (BASELINE.md).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "samples/s", "vs_baseline": N}
"""
import json
import sys
import time

import numpy as np

from kspecanal_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


def numpy_baseline_samples_per_s(cfg, t_blocks: int) -> float:
    """Serial NumPy port of the reference chain: per block, overlapped
    windowed FFTs + sequential AVG cumulate + fftshift + LogNoGain + row
    compress (kspecanal.py:385-397,469-484)."""
    from kspecanal_tpu.config import window_lut

    win = window_lut(cfg.window, cfg.fft_size)
    win_adj = len(win) / np.sum(win)
    rng = np.random.default_rng(0)
    blocks = (rng.standard_normal((t_blocks, cfg.full_size))
              + 1j * rng.standard_normal((t_blocks, cfg.full_size)))
    starts = cfg.window_starts
    n = cfg.fft_size
    t0 = time.perf_counter()
    for b in range(t_blocks):
        acc = None
        for s in starts:
            frame = blocks[b, s:s + n]
            mag = win_adj * 2 * np.abs(np.fft.fft(frame * win)) / n
            acc = mag if acc is None else (acc + mag) / 2
        spec = np.fft.fftshift(acc)
        db = 10 * np.log10(spec) - cfg.gain
        row = np.max(db[: (len(db) // cfg.x_res) * cfg.x_res]
                     .reshape(cfg.x_res, -1), axis=1)
    dt = time.perf_counter() - t0
    return t_blocks * cfg.full_size / dt


def device_samples_per_s(cfg, t_blocks: int, iters: int = 10) -> float:
    """Sustained device throughput of the full waterfall chain, on data
    generated on the device; a scalar host readback ends each timing."""
    import jax
    import jax.numpy as jnp
    from kspecanal_tpu.parallel.stream import waterfall_stream

    mk = jax.jit(lambda k: jax.random.normal(
        k, (2, t_blocks, cfg.full_size), jnp.float32))
    planes = mk(jax.random.key(0))
    re, im = planes[0], planes[1]
    # Warmup / compile, then end the timing with a scalar readback
    res = waterfall_stream(re, im, cfg)
    _ = float(res.fft_avg[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        res = waterfall_stream(re, im, cfg)
    _ = float(res.fft_avg[0])
    dt = (time.perf_counter() - t0) / iters
    return t_blocks * cfg.full_size / dt


def _progress(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def device_marginal_samples_per_s(cfg, u8: bool, t_lo: int = 4096,
                                  t_hi: int = 8192, iters: int = 5) -> float:
    """T=t_lo -> t_hi differenced device rate: cancels the fixed
    per-dispatch cost."""
    import jax
    import jax.numpy as jnp
    from kspecanal_tpu.parallel.stream import waterfall_stream

    def one(t_blocks):
        if u8:
            mk = jax.jit(lambda k: jax.random.randint(
                k, (2, t_blocks, cfg.full_size), 0, 256).astype(jnp.uint8))
        else:
            mk = jax.jit(lambda k: jax.random.normal(
                k, (2, t_blocks, cfg.full_size), jnp.float32))
        planes = mk(jax.random.key(0))
        re, im = planes[0], planes[1]
        res = waterfall_stream(re, im, cfg)
        _ = float(res.fft_avg[0])
        t0 = time.perf_counter()
        for _ in range(iters):
            res = waterfall_stream(re, im, cfg)
        _ = float(res.fft_avg[0])
        return (time.perf_counter() - t0) / iters

    lo = min(one(t_lo) for _ in range(2))
    hi = min(one(t_hi) for _ in range(2))
    if hi <= lo:
        return float("nan")
    return (t_hi - t_lo) * cfg.full_size / (hi - lo)


def device_u8_samples_per_s(cfg, t_blocks: int, iters: int = 10) -> float:
    """Full waterfall chain fed RAW uint8 capture planes (the 8-bit-ADC
    production path), decoded on the device."""
    import jax
    import jax.numpy as jnp
    from kspecanal_tpu.parallel.stream import waterfall_stream

    mk = jax.jit(lambda k: jax.random.randint(
        k, (2, t_blocks, cfg.full_size), 0, 256).astype(jnp.uint8))
    planes = mk(jax.random.key(0))
    re, im = planes[0], planes[1]
    res = waterfall_stream(re, im, cfg)
    _ = float(res.fft_avg[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        res = waterfall_stream(re, im, cfg)
    _ = float(res.fft_avg[0])
    dt = (time.perf_counter() - t0) / iters
    return t_blocks * cfg.full_size / dt


def scan_sweep_samples_per_s(iters: int = 10, sweeps_per_dispatch: int = 16,
                             precision: str = "HIGHEST",
                             preset: tuple = ("fmScan", "fftSize", "2048"),
                             return_work_dt: bool = False):
    """Scan-mode sweeps: batched band curscans + the jitted
    overlap-average stitch fold, S sweeps per dispatch
    (models.scan.sweep_steps_jit — one full FM sweep is only ~280
    Ksamples, too little work for a dispatch of its own).
    ``preset`` picks the CLI alias: fmScan (BASELINE config 3, 18 bands)
    or quickFullScan (config 4, 30e6-1.5e9, fftSize 64, 1225 bands)."""
    import jax
    import jax.numpy as jnp
    from kspecanal_tpu.cli import parse_args
    from kspecanal_tpu.models import scan as scan_mod

    cfg, _ = parse_args([*preset, "tpuPrecision", precision])
    plan = scan_mod.make_scan_plan(cfg)
    b = plan.num_bands
    s = sweeps_per_dispatch
    mk = jax.jit(lambda k: jax.random.normal(
        k, (2, s, b, cfg.full_size), jnp.float32))
    planes = mk(jax.random.key(0))
    re, im = planes[0], planes[1]
    oks = jnp.ones((s, b), bool)
    state = scan_mod.init_state(cfg, plan)
    state = scan_mod.sweep_steps_jit(state, re, im, oks, cfg, plan)
    _ = float(state.fft_avg[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        state = scan_mod.sweep_steps_jit(state, re, im, oks, cfg, plan)
    _ = float(state.fft_avg[0])
    dt = (time.perf_counter() - t0) / iters
    if return_work_dt:
        return s * b * cfg.full_size, dt
    return s * b * cfg.full_size / dt


def session_samples_per_s(source_kind: str, n_iters: int = 1024,
                          catch_up: int = 128,
                          precision: str = "HIGHEST",
                          cfg_kw: dict = None) -> float:
    """End-to-end CLI-loop throughput: ``run_zero_span`` with
    ``tpuCatchUp``, renderer off, on the primary config — the number a
    user actually gets from ``python -m kspecanal_tpu``.  ``file``
    exercises the raw-u8 ship + in-jit decode path (2 B/sample over the
    host link); ``devicesynth`` the on-device
    simulator (no host sample traffic at all).  Prints the per-stage
    breakdown (acquire vs dsp) to stderr."""
    import tempfile

    import numpy as np
    from kspecanal_tpu import session as sess_mod
    from kspecanal_tpu.config import SpecConfig, WINDOW_KAISER
    from kspecanal_tpu.io import sources

    kw = dict(prg_mode="ZEROSPAN", fft_size=2048, sampling_rate=2.4e6,
              window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
              x_res=512, tpu_precision=precision)
    kw.update(cfg_kw or {})
    cfg = SpecConfig(**kw).finalize()
    tmp = None
    if source_kind == "file":
        rng = np.random.default_rng(0)
        tmp = tempfile.NamedTemporaryFile(suffix=".iq", delete=False)
        # 64 blocks of capture, wrapped as needed (u8 interleaved IQ)
        tmp.write(rng.integers(0, 256, 64 * 2 * cfg.full_size,
                               dtype=np.uint8).tobytes())
        tmp.close()
        # The CLI's file-source ladder (native C++ streaming reader with
        # raw-u8 ring, NumPy fallback) — the bench measures what the CLI
        # actually constructs.
        src, _ = sources.make_file_source(
            tmp.name, center_freq=cfg.center_freq,
            sample_rate=cfg.sampling_rate, gain=cfg.gain)
    elif source_kind == "devicenoise":
        # reuse=True: one staged u8 buffer per batch shape, returned every
        # read — the SAME methodology as the kernel benches (repeated
        # dispatches over one staged buffer), so this entry measures what
        # the session machinery adds over the raw kernel dispatch.
        src = sources.DeviceNoiseIQSource(center_freq=cfg.center_freq,
                                          sample_rate=cfg.sampling_rate,
                                          gain=0.5, seed=0, reuse=True)
    else:
        src = sources.DeviceSynthIQSource(center_freq=cfg.center_freq,
                                          sample_rate=cfg.sampling_rate,
                                          gain=0.5, seed=0)
    sess = sess_mod.Session(cfg, src, renderer=None, catch_up=catch_up)
    # warmup: compile the batched step outside the timed window
    sess_mod.run_zero_span(sess, max_iters=catch_up)
    sess = sess_mod.Session(cfg, src, renderer=None, catch_up=catch_up)
    t0 = time.perf_counter()
    state = sess_mod.run_zero_span(sess, max_iters=n_iters)
    _ = float(state.fft_avg[0])   # wait for the device
    dt = time.perf_counter() - t0
    _progress(f"  session[{source_kind}] stages: "
              + "; ".join(sess.timer.report().splitlines()))
    src.close()    # stop the native producer thread before the file goes
    if tmp is not None:
        import os
        os.unlink(tmp.name)
    notes = {
        "file": "native reader -> host u8 split -> host-to-device copy -> "
                "device decode; the drain stage holds the copy backlog",
        "devicesynth": "includes the on-device tone-bank simulator; see "
                       "session_devicenoise for the loop itself",
        "devicenoise": "u8 noise staged once and reused per batch (the "
                       "kernel benches' methodology), so this measures "
                       "the session machinery (drivers, batched folds, "
                       "dispatch) against the raw kernel rate; compare "
                       "with the same-precision fft2048 u8/f32 entries",
    }
    out = {"tpu": n_iters * cfg.full_size / dt,
           "note": notes[source_kind]}
    acq, dsp = sess.timer.rate("acquire"), sess.timer.rate("dsp")
    drain = sum(sess.timer.times.get("drain", []))
    drain_frac = drain * out["tpu"] / (n_iters * cfg.full_size)
    if source_kind == "file":
        # the host-side accounting stays in the JSON
        out["host_acquire_rate"] = acq
        out["drain_frac"] = drain_frac
    else:
        # on-device sources: the host stages only enqueue, their "rates"
        # are not meaningful throughputs — stderr only (keeps the JSON
        # line under the driver's 2 KB tail)
        _progress(f"  session[{source_kind}] acquire {acq:.3g} dsp "
                  f"{dsp:.3g} drain_frac {drain_frac:.2f}")
    return out


def scan_sweep_u8_samples_per_s(iters: int = 10,
                                sweeps_per_dispatch: int = 16,
                                precision: str = "DEFAULT",
                                preset: tuple = ("fmScan", "fftSize", "2048"),
                                return_work_dt: bool = False):
    """Scan-mode sweeps fed RAW u8 capture planes (S, B, full) x2 — the
    production 8-bit-SDR ingest: the host splits interleaved bytes
    (native/iqdecode.cpp iq_split_u8) and ships 2 B/sample of undecoded
    planes, decoded on the device.  This is exactly what the scan drivers
    dispatch (sweep_steps_jit on u8 planes)."""
    import jax
    import jax.numpy as jnp
    from kspecanal_tpu.cli import parse_args
    from kspecanal_tpu.models import scan as scan_mod

    cfg, _ = parse_args([*preset, "tpuPrecision", precision])
    plan = scan_mod.make_scan_plan(cfg)
    b = plan.num_bands
    s = sweeps_per_dispatch
    mk = jax.jit(lambda k: jax.random.randint(
        k, (2, s, b, cfg.full_size), 0, 256).astype(jnp.uint8))
    planes = mk(jax.random.key(0))
    re, im = planes[0], planes[1]
    oks = jnp.ones((s, b), bool)
    state = scan_mod.init_state(cfg, plan)
    state = scan_mod.sweep_steps_jit(state, re, im, oks, cfg, plan)
    _ = float(state.fft_avg[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        state = scan_mod.sweep_steps_jit(state, re, im, oks, cfg, plan)
    _ = float(state.fft_avg[0])
    dt = (time.perf_counter() - t0) / iters
    if return_work_dt:
        return s * b * cfg.full_size, dt
    return s * b * cfg.full_size / dt


def replay_frames_per_s(n_frames: int = 8192, catch_up: int = 1024,
                        fft_size: int = 256) -> dict:
    """zeroSpanPlay throughput (BASELINE config 1): recorded linear
    spectra through the batched display-update fold
    (zs.display_updates — transform, curve folds, heatmap ring).
    Frames are synthesized host-side (the recorder format is a stream of
    pickles); the number is display-update frames/s through the REAL
    replay driver with ``tpuCatchUp``."""
    import tempfile

    import numpy as np
    from kspecanal_tpu import session as sess_mod
    from kspecanal_tpu.config import SpecConfig, WINDOW_HANNING
    from kspecanal_tpu.io.replay import ZeroSpanRecorder

    cfg = SpecConfig(prg_mode="ZEROSPANPLAY", fft_size=fft_size,
                     sampling_rate=2.4e6, window=WINDOW_HANNING,
                     x_res=min(512, fft_size)).finalize()
    rng = np.random.default_rng(0)
    tmp = tempfile.NamedTemporaryFile(suffix=".pkl", delete=False)
    tmp.close()
    frames = rng.random((n_frames, fft_size)).astype(np.float64) * 1e-3
    with ZeroSpanRecorder(tmp.name, cfg.center_freq, cfg.sampling_rate,
                          cfg.gain) as rec:
        for f in frames:
            rec.append(f)
    import dataclasses
    pcfg = dataclasses.replace(cfg, zero_span_play_file=tmp.name,
                               prg_loop_cnt=n_frames).finalize()
    # warmup (compile) on a short run, then the timed full replay
    sess_mod.run_zero_span_play(
        sess_mod.Session(pcfg, None, catch_up=catch_up),
        max_iters=2 * catch_up)
    sess = sess_mod.Session(pcfg, None, catch_up=catch_up)
    t0 = time.perf_counter()
    state = sess_mod.run_zero_span_play(sess)
    _ = float(state.fft_avg[0])
    dt = time.perf_counter() - t0
    import os
    os.unlink(tmp.name)
    return {"tpu": n_frames / dt, "unit": "frames/s",
            "note": "display-update chain on recorded frames "
                    "(kspecanal.py:530-564), one dispatch per "
                    f"{catch_up}-frame batch"}


def _compact(obj, path=""):
    """Driver-parseable form of the result tree: float values rounded to
    4 significant digits, 'note'/'methodology' strings emitted to stderr
    instead of the JSON line (the driver tails only ~2000 chars)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ("note", "methodology") and isinstance(v, str):
                _progress(f"note[{path or 'result'}]: {v}")
                continue
            out[k] = _compact(v, f"{path}.{k}" if path else k)
        return out
    if isinstance(obj, float):
        # json.dumps would emit bare NaN/Infinity — invalid JSON that
        # breaks the driver parse this compaction exists to protect.
        import math
        if not math.isfinite(obj):
            return None
        return float(f"{obj:.4g}")
    return obj


def main():
    from kspecanal_tpu.config import SpecConfig, WINDOW_KAISER

    details = {}
    # Primary: config 2 geometry (fftSize 2048, kaiser, 50% overlap),
    # T=8192 blocks (134 Msamples, 1.1 GB of planes).
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=2048, sampling_rate=2.4e6,
                     window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
                     x_res=512).finalize()
    _progress("primary fft2048 on device...")
    # Best-of-2.
    value = max(device_samples_per_s(cfg, t_blocks=8192) for _ in range(2))
    _progress(f"primary done: {value/1e9:.2f} Gsamp/s; cpu oracle...")
    # best-of-5: the serial NumPy oracle is sensitive to ambient host load
    # (readings have spanned 12.8-22.1 Msamp/s across rounds)
    base = max(numpy_baseline_samples_per_s(cfg, t_blocks=8)
               for _ in range(5))
    details["fft2048"] = {"tpu": value, "cpu_oracle": base}

    # Precision ladder on the primary config (tpuPrecision option).
    import dataclasses
    for prec in ("HIGH", "DEFAULT"):
        _progress(f"primary at tpuPrecision {prec}...")
        cp = dataclasses.replace(cfg, tpu_precision=prec)
        details[f"fft2048_{prec.lower()}"] = {
            "tpu": device_samples_per_s(cp, t_blocks=8192)}

    # 8-bit-native ingest (raw u8 planes, decoded on the device): the
    # realistic SDR production path.
    cfg_d = dataclasses.replace(cfg, tpu_precision="DEFAULT")
    _progress("primary DEFAULT, u8-native input...")
    details["fft2048_default_u8"] = {
        "tpu": device_u8_samples_per_s(cfg_d, t_blocks=8192),
        "marginal": device_marginal_samples_per_s(cfg_d, u8=True)}
    _progress("primary DEFAULT f32 marginal...")
    details["fft2048_default"]["marginal"] = (
        device_marginal_samples_per_s(cfg_d, u8=False))

    # Secondary: spot checks across the 64-16384 fftSize range; fft64
    # (the quickFullScan regime) uses a very large batch.
    for fft_size, t_blocks in ((64, 65536), (4096, 4096), (16384, 1024)):
        c = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft_size,
                       sampling_rate=2.4e6, window=WINDOW_KAISER,
                       cur_scan_non_overlap=0.5,
                       x_res=min(512, fft_size)).finalize()
        _progress(f"sweep fft{fft_size}...")
        details[f"fft{fft_size}"] = {
            "tpu": device_samples_per_s(c, t_blocks=t_blocks)}

    # fft16384 DEFAULT u8.
    c16d = SpecConfig(prg_mode="ZEROSPAN", fft_size=16384,
                      sampling_rate=2.4e6, window=WINDOW_KAISER,
                      cur_scan_non_overlap=0.5, x_res=512,
                      tpu_precision="DEFAULT").finalize()
    _progress("fft16384 DEFAULT u8-native...")
    details["fft16384_default_u8"] = {
        "tpu": device_u8_samples_per_s(c16d, t_blocks=1024, iters=5),
        "marginal": device_marginal_samples_per_s(
            c16d, u8=True, t_lo=512, t_hi=1024)}

    # quickFullScan-regime u8 ingest at DEFAULT precision.
    c64 = SpecConfig(prg_mode="ZEROSPAN", fft_size=64, sampling_rate=2.4e6,
                     window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
                     x_res=64, tpu_precision="DEFAULT").finalize()
    _progress("fft64 DEFAULT f32 vs u8-native...")
    details["fft64_default"] = {
        "tpu": device_samples_per_s(c64, t_blocks=65536)}
    details["fft64_default_u8"] = {
        "tpu": device_u8_samples_per_s(c64, t_blocks=65536)}

    # Deep waterfall (BASELINE config 5 + the reference-default overlap):
    # 90% overlap, fractional hop.
    for fft_size, t_blocks in ((2048, 2048), (16384, 256)):
        c5 = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft_size,
                        sampling_rate=2.4e6, window=WINDOW_KAISER,
                        cur_scan_non_overlap=0.1, x_res=512).finalize()
        _progress(f"deep waterfall fft{fft_size} ovl 0.9...")
        details[f"fft{fft_size}_ovl90"] = {"tpu": device_samples_per_s(
            c5, t_blocks=t_blocks, iters=5)}

    # BASELINE config 5 geometry (fft16384, 90% overlap) at DEFAULT.
    c5d = SpecConfig(prg_mode="ZEROSPAN", fft_size=16384,
                     sampling_rate=2.4e6, window=WINDOW_KAISER,
                     cur_scan_non_overlap=0.1, x_res=512,
                     tpu_precision="DEFAULT").finalize()
    _progress("deep waterfall fft16384 ovl 0.9 DEFAULT...")
    details["fft16384_ovl90_default"] = {"tpu": device_samples_per_s(
        c5d, t_blocks=256, iters=5)}

    # Reference-default overlap at DEFAULT precision, plus the u8-native
    # production variant.
    c90 = SpecConfig(prg_mode="ZEROSPAN", fft_size=2048, sampling_rate=2.4e6,
                     window=WINDOW_KAISER, cur_scan_non_overlap=0.1,
                     x_res=512).finalize()
    c90d = dataclasses.replace(c90, tpu_precision="DEFAULT")
    _progress("deep waterfall fft2048 ovl 0.9 DEFAULT...")
    details["fft2048_ovl90_default"] = {
        "tpu": device_samples_per_s(c90d, t_blocks=4096, iters=5)}
    _progress("deep waterfall fft2048 ovl 0.9 DEFAULT u8-native...")
    details["fft2048_ovl90_default_u8"] = {
        "tpu": device_u8_samples_per_s(c90d, t_blocks=4096, iters=5)}

    # Scan mode (BASELINE config 3): full FM sweeps through the batched
    # gathered stitch, S=128 sweeps per dispatch (the scan drivers' batch
    # cap).  The marginal entries difference S=64 -> S=128 runs,
    # cancelling the fixed per-dispatch cost.  Best-of-2 everywhere.
    def _best2_workdt(fn, **kw):
        runs = [fn(return_work_dt=True, **kw) for _ in range(2)]
        return min(runs, key=lambda r: r[1])   # (work, dt), fastest

    def _marginal(fn, **kw):
        w64, t64 = _best2_workdt(fn, sweeps_per_dispatch=64, **kw)
        w128, t128 = _best2_workdt(fn, sweeps_per_dispatch=128, **kw)
        return {"s128": w128 / t128,
                "marginal": ((w128 - w64) / (t128 - t64)
                             if t128 > t64 else float("nan"))}

    _progress("fm scan sweep (S=128 + S=64->128 marginal)...")
    m = _marginal(scan_sweep_samples_per_s)
    details["fm_scan"] = {"tpu": m["s128"], "marginal": m["marginal"]}
    # ... and at DEFAULT precision.
    _progress("fm scan sweep DEFAULT (S=128 + marginal)...")
    m = _marginal(scan_sweep_samples_per_s, precision="DEFAULT")
    details["fm_scan_default"] = {"tpu": m["s128"],
                                  "marginal": m["marginal"]}
    # ... and HIGH.
    _progress("fm scan sweep HIGH (S=128 + marginal)...")
    m = _marginal(scan_sweep_samples_per_s, precision="HIGH")
    details["fm_scan_high"] = {"tpu": m["s128"], "marginal": m["marginal"]}
    # ... and the raw-u8 ship variant (what the scan drivers dispatch
    # for 8-bit sources): 2 B/sample over the host link.
    _progress("fm scan sweep DEFAULT u8-native (S=128 + marginal)...")
    m = _marginal(scan_sweep_u8_samples_per_s, precision="DEFAULT")
    details["fm_scan_default_u8"] = {"tpu": m["s128"],
                                     "marginal": m["marginal"]}

    # quickFullScan (BASELINE config 4): 30 MHz - 1.5 GHz, fftSize 64,
    # 1225 bands/sweep; one sweep is only 627 Ksamples, so S=128
    # sweeps/dispatch.
    _progress("quickFullScan sweep...")
    details["quick_full_scan"] = {"tpu": scan_sweep_samples_per_s(
        iters=5, sweeps_per_dispatch=128, preset=("quickFullScan",))}
    # ... and the production 8-bit combination: raw u8 sweeps at DEFAULT.
    _progress("quickFullScan sweep, DEFAULT u8-native...")
    details["quick_full_scan_default_u8"] = {
        "tpu": scan_sweep_u8_samples_per_s(
            iters=5, sweeps_per_dispatch=128, preset=("quickFullScan",),
            precision="DEFAULT")}

    # Replay mode (BASELINE config 1): display-update chain on recorded
    # frames through the real zeroSpanPlay driver, batched by tpuCatchUp.
    _progress("zeroSpanPlay replay (fft256, batched display fold)...")
    details["zero_span_play"] = replay_frames_per_s()

    # Session path: the throughput a user gets from the real CLI loop
    # (run_zero_span + tpuCatchUp, renderer off) — not just the kernels.
    _progress("session path (file source, u8 in-jit decode)...")
    details["session_file_u8"] = session_samples_per_s(
        "file", n_iters=8192, catch_up=2048)
    # catch_up=16384 batches far past the heatmap-ring depth (exact —
    # the batched step writes only the rows a sequential run would
    # keep); one dispatch covers 67 Msamp of device work.
    def _best2(fn):
        a, b = fn(), fn()
        return a if a["tpu"] >= b["tpu"] else b

    _progress("session path (device synth source, HIGHEST)...")
    details["session_devicesynth"] = _best2(lambda: session_samples_per_s(
        "devicesynth", n_iters=65536, catch_up=16384))
    _progress("session path (device synth source, DEFAULT)...")
    details["session_devicesynth_default"] = _best2(
        lambda: session_samples_per_s(
            "devicesynth", n_iters=65536, catch_up=16384,
            precision="DEFAULT"))
    # The session MACHINERY itself (drivers, batched folds, dispatch),
    # decoupled from simulator cost: devicenoise generates bit-cheap
    # on-device noise instead of devicesynth's tone bank.
    _progress("session path (device noise source, HIGHEST)...")
    details["session_devicenoise"] = _best2(lambda: session_samples_per_s(
        "devicenoise", n_iters=65536, catch_up=16384))
    _progress("session path (device noise source, DEFAULT)...")
    details["session_devicenoise_default"] = _best2(
        lambda: session_samples_per_s(
            "devicenoise", n_iters=65536, catch_up=16384,
            precision="DEFAULT"))

    # Reference-launch-default session: fftSize 16384, ones window, 90%
    # overlap, AVG cumulation (kspecanal.py:45-55 g* defaults) through
    # the real run_zero_span driver — what a reference user gets if they
    # switch frameworks and change nothing.
    _progress("session path (reference launch defaults, fft16384 ones "
              "ovl90)...")
    details["session_reference_default"] = _best2(
        lambda: session_samples_per_s(
            "devicenoise", n_iters=4096, catch_up=1024,
            precision="DEFAULT",
            cfg_kw=dict(fft_size=16384, window="WIN.ONES",
                        cur_scan_non_overlap=0.1,
                        cur_scan_cumu_mode="AVG")))

    result = {
        "metric": "IQ samples/s/chip, fft2048 kaiser 50% overlap chain",
        "value": value,
        "unit": "samples/s",
        "vs_baseline": value / base,
        "details": details,
    }
    # The driver captures only the last ~2000 chars of stdout, so the
    # JSON line must stay well under that (round 4's note-bloated line
    # outgrew it and the round lost its machine-readable artifact).
    # Notes move to stderr; floats round to 4 significant digits.
    line = json.dumps(_compact(result))
    print(line)
    _progress(f"bench line chars: {len(line)}")


if __name__ == "__main__":
    sys.exit(main())
