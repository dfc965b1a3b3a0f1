#!/usr/bin/env python3
"""Smoke run of the spectrum/waterfall session path on an NVIDIA GPU.

Drives the CLI's session drivers (``cli.build_session`` + ``session.do_run``,
renderer off) at the sizes users run, holds every phase to the float64
oracle in ``tests/oracle.py``, and prints one line per phase, the card's
name and power limit (from ``nvidia-smi``), and a final JSON line.

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --four-cards  # only the sharded paths, four cards

It exits non-zero, printing no JSON line, when JAX finds no GPU or any
phase fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [REPO] + [os.path.join(REPO, d) for d in ("tests", "scripts")]

# Every check reports the peak-normalised error max|got - want| / max|want|
# of a float32 device result against the float64 oracle (dB curves are
# compared as the linear magnitudes they encode).  float32 FFT rounding
# grows like eps * log2(N) of the peak, ~1e-6 at N = 16384; the H100
# measured at most 7.2e-7 on the zero-span, file and replay phases.
TOL = 5e-6
# Scan curves fold dB averages across overlapping bands and sweeps; the
# H100 measured 7.2e-6 on fmScan.
SCAN_TOL = 2e-5

# 2^26 IQ samples: ~28 s of a 2.4 Msps receiver.
LONG_RUN_SAMPLES = 1 << 26


class NoGpuError(RuntimeError):
    pass


@dataclasses.dataclass
class Phase:
    name: str
    samples: int
    seconds: float
    err: float
    tol: float = TOL
    note: str = ""

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.err)) and self.err <= self.tol

    def line(self) -> str:
        return (f"phase {self.name}: samples={self.samples} "
                f"wall_s={self.seconds:.3f} max_err={self.err:.3e} "
                f"tol={self.tol:.0e} {'ok' if self.ok else 'FAIL'}"
                + (f" {self.note}" if self.note else ""))


# ---------------------------------------------------------------------------
# Device report
# ---------------------------------------------------------------------------

def require_gpu():
    """The devices JAX found; :class:`NoGpuError` unless they are GPUs."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGpuError(f"JAX found no GPU (platform "
                         f"{devs[0].platform!r}); this smoke run has no "
                         "CPU fallback")
    return devs


def card_report() -> str:
    """Name and power limit of each card, read by a child process that
    never imports JAX (so only this process holds the card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Helpers: record what the session consumed, compare with the oracle
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps a session source and keeps every block it hands out, in
    order, so the oracle can replay exactly the same samples."""

    def __init__(self, inner):
        self._inner = inner
        self.chunks: list = []
        for name in ("read", "read_raw", "read_device_batch"):
            if hasattr(inner, name):
                setattr(self, name, self._recording(getattr(inner, name)))

    def _recording(self, fn):
        def call(*args):
            out = fn(*args)
            self.chunks.append(out)
            return out
        return call

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def reader(self) -> str:
        """Class name of the innermost source (under read-ahead wrappers)."""
        src = self._inner
        while hasattr(src, "_inner"):
            src = src._inner
        return type(src).__name__

    def blocks(self):
        """Yield ``(re, im)`` per block in the dtype the device received
        (raw captures as undecoded uint8 planes)."""
        for c in self.chunks:
            if isinstance(c, np.ndarray):            # raw interleaved u8
                yield c[0::2], c[1::2]
                continue
            re, im = np.asarray(c[0]), np.asarray(c[1])
            if re.ndim == 1:
                yield re, im
            else:
                yield from zip(re, im)


def to_complex(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    if re.dtype == np.uint8:
        return (re.astype(np.float64) - 127.0) + 1j * (
            im.astype(np.float64) - 127.0)
    return re.astype(np.float64) + 1j * im.astype(np.float64)


def worst(errs) -> float:
    """The largest error; NaN if any is NaN (Python's max would drop it)."""
    return float(np.max(np.asarray(list(errs), np.float64)))


def peak_rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def db_to_lin(db, gain: float) -> np.ndarray:
    """Invert LogNoGain (``10*log10(v) - gain``) to the linear magnitude."""
    return 10.0 ** ((np.asarray(db, np.float64) + gain) / 10.0)


def curves_err(state, want, gain: float, fields) -> float:
    """Largest error over the named dB curves of a mode state."""
    return worst(peak_rel_err(db_to_lin(getattr(state, f), gain),
                              db_to_lin(want[i], gain))
                 for i, f in enumerate(fields))


def oracle_block_spectra(cfg, blocks):
    from kspecanal_tpu.config import window_lut
    from oracle import oracle_curscan
    win = window_lut(cfg.window, cfg.fft_size)
    return [oracle_curscan(to_complex(re, im), cfg.fft_size,
                           cfg.cur_scan_non_overlap, win,
                           cfg.cur_scan_cumu_mode) for re, im in blocks]


def device_block_spectrum(cfg, re, im) -> np.ndarray:
    """One block through the same batched curscan the session runs."""
    import jax
    from kspecanal_tpu.ops.spectrum import curscan_auto_batched
    run = jax.jit(lambda r, i: curscan_auto_batched(r, i, cfg))
    return np.asarray(run(re[None], im[None])[0])


def tones_on_mhz(cfg, levels, count: int = 3) -> bool:
    """The reference's visual check: the strongest peaks of a synth
    session sit on integer MHz, within one FFT bin."""
    from kspecanal_tpu.ops.peaks import find_peaks
    from kspecanal_tpu.ops.spectrum import fft_freqs
    peaks = find_peaks(fft_freqs(cfg), np.asarray(levels), count,
                       cfg.plt_highs_delta4marking)
    bin_hz = cfg.sampling_rate / cfg.fft_size
    return len(peaks) == count and all(
        abs(p.freq - round(p.freq / 1e6) * 1e6) <= bin_hz for p in peaks)


def run_cli(argv, record: bool = True):
    """Build the session the CLI would for ``argv`` and run it; returns
    ``(cfg, state, recorder-or-None, wall seconds)``."""
    from kspecanal_tpu import session
    from kspecanal_tpu.cli import build_session, parse_args
    cfg, run = parse_args(list(argv) + ["tpuRenderer", "none"])
    sess = build_session(cfg, run)
    rec = None
    if record and sess.source is not None:
        rec = sess.source = Recorder(sess.source)
    t0 = time.perf_counter()
    try:
        state = session.do_run(sess)
        if hasattr(state, "fft_avg"):
            state.fft_avg.block_until_ready()
    finally:
        if sess.source is not None:
            sess.source.close()
    return sess.cfg, state, rec, time.perf_counter() - t0


def zero_span_check(name, argv, synth_tones: bool) -> Phase:
    """Run a zero-span session and hold block 0's spectrum and the final
    Max/Min/Avg curves to the oracle."""
    from oracle import oracle_zero_span_iters
    cfg, state, rec, secs = run_cli(argv)
    blocks = list(rec.blocks())
    spectra = oracle_block_spectra(cfg, blocks)
    err_spec = peak_rel_err(device_block_spectrum(cfg, *blocks[0]),
                            spectra[0])
    want = oracle_zero_span_iters(spectra, cfg.gain)
    err_curves = curves_err(state, want, cfg.gain,
                            ("fft_max", "fft_min", "fft_avg"))
    note = (f"spectrum_err={err_spec:.3e} curves_err={err_curves:.3e} "
            f"reader={rec.reader}")
    err = worst([err_spec, err_curves])
    if synth_tones:
        on_mhz = tones_on_mhz(cfg, state.fft_avg)
        note += f" tones_on_mhz={on_mhz}"
        if not on_mhz:
            err = float("inf")
    return Phase(name, len(blocks) * cfg.full_size, secs, err, note=note)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_waterfall(fft_size: int = 2048, catch_up: int = 1024,
                    samples: int = LONG_RUN_SAMPLES):
    """BASELINE config 2: zero-span waterfall, fftSize 2048, kaiser, 50%
    overlap, 2.4 Msps, on-device tone synthesis in catch-up batches."""
    from kspecanal_tpu.config import SpecConfig
    full = SpecConfig(fft_size=fft_size).full_size
    argv = ["zeroSpan", "fftSize", str(fft_size), "window", "kaiser",
            "curScanNonOverlap", "0.5", "samplingRate", "2.4e6",
            "tpuSource", "devicesynth", "tpuCatchUp", str(catch_up),
            "prgLoopCnt", str(-(-samples // full))]
    return [zero_span_check("zero_span_config2", argv, synth_tones=True)]


def phase_reference_defaults(fft_size: int = 16384, serial_iters: int = 4,
                             catch_up: int = 1024,
                             samples: int = LONG_RUN_SAMPLES):
    """The reference's launch defaults (fftSize 16384, ones window, 90%
    overlap, AVG): the serial cadence, then catch-up batches."""
    from kspecanal_tpu.config import SpecConfig
    full = SpecConfig(fft_size=fft_size).full_size
    base = ["zeroSpan", "fftSize", str(fft_size), "window", "ones",
            "curScanNonOverlap", "0.1", "curScanCumuMode", "avg",
            "tpuSource", "devicesynth"]
    return [
        zero_span_check("reference_defaults_serial",
                        base + ["prgLoopCnt", str(serial_iters)],
                        synth_tones=True),
        zero_span_check("reference_defaults_catchup",
                        base + ["tpuCatchUp", str(catch_up), "prgLoopCnt",
                                str(-(-samples // full))],
                        synth_tones=True),
    ]


def build_native_reader() -> None:
    """Rebuild the native reader from the committed sources on this
    machine; the phase fails if the build does."""
    out = subprocess.run(["make", "-B", "-C", os.path.join(REPO, "native")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"native reader build failed:\n{out.stderr}")


def phase_file(fft_size: int = 2048, capture_blocks: int = 64,
               serial_iters: int = 32, catch_up: int = 2048,
               samples: int = LONG_RUN_SAMPLES):
    """A raw u8 rtl_sdr capture, made from a seed, read three ways:
    serial, catch-up batches, and the read-ahead wrapper."""
    from kspecanal_tpu.config import SpecConfig
    from kspecanal_tpu.io import native_iq
    from kspecanal_tpu.io.sources import StreamingFileIQSource
    from make_fixture import make_capture
    build_native_reader()
    full = SpecConfig(fft_size=fft_size).full_size
    phases = []
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "cap.iq")
        make_capture(cap, n=capture_blocks * full, seed=0)
        base = ["zeroSpan", "fftSize", str(fft_size), "window", "kaiser",
                "curScanNonOverlap", "0.5", "tpuSource", f"file:{cap}"]
        for name, extra in (
                ("file_serial", ["prgLoopCnt", str(serial_iters)]),
                ("file_catchup", ["tpuCatchUp", str(catch_up), "prgLoopCnt",
                                  str(-(-samples // full))]),
                ("file_prefetch", ["tpuPrefetch", "true",
                                   "prgLoopCnt", str(serial_iters)])):
            p = zero_span_check(name, base + extra, synth_tones=False)
            native = (f"reader={StreamingFileIQSource.__name__}" in p.note
                      and native_iq._lib is not None)
            p.note += f" native={native}"
            if not native:
                p.err = float("inf")
            phases.append(p)
    return phases


def scan_check(name, argv) -> Phase:
    """Run a few scan sweeps and hold the stitched Cur/Max/Min/Avg curves
    to the serial oracle stitch over the same per-band samples."""
    from oracle import oracle_scan_sweeps
    from kspecanal_tpu.session import make_plan_cached
    cfg, state, rec, secs = run_cli(argv)
    nb = make_plan_cached(cfg).num_bands
    spectra = np.asarray(oracle_block_spectra(cfg, rec.blocks()))
    sweeps = list(spectra.reshape(-1, nb, cfg.fft_size))
    want = oracle_scan_sweeps(sweeps, cfg)
    err = curves_err(state, [want[k] for k in ("Cur", "Max", "Min", "Avg")],
                     cfg.gain, ("fft_cur", "fft_max", "fft_min", "fft_avg"))
    return Phase(name, len(sweeps) * nb * cfg.full_size, secs, err,
                 tol=SCAN_TOL, note=f"bands={nb} sweeps={len(sweeps)}")


def phase_scans(sweeps: int = 3, fm=("fmScan",), qfs=("quickFullScan",)):
    """fmScan 88-108 MHz at scanRangeNonOverlap 0.5 (batched sweeps) and
    quickFullScan 30 MHz-1.5 GHz at fftSize 64 (serial sweeps)."""
    common = ["tpuSource", "synth", "prgLoopCnt", str(sweeps)]
    return [
        scan_check("fm_scan", [*fm, "scanRangeNonOverlap", "0.5",
                               "tpuCatchUp", str(sweeps)] + common),
        scan_check("quick_full_scan", [*qfs] + common),
    ]


def phase_record_replay(fft_size: int = 2048, frames: int = 64,
                        catch_up: int = 16):
    """zeroSpanSave -> zeroSpanPlay round trip, then a replay of the
    recording the reference program itself wrote."""
    from oracle import oracle_zero_span_iters
    from kspecanal_tpu.io.replay import ZeroSpanPlayer
    phases = []
    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "session.save")
        cfg, _, rec, secs = run_cli(
            ["zeroSpanSave", "fftSize", str(fft_size), "window", "kaiser",
             "curScanNonOverlap", "0.5", "tpuSource", "synth",
             "zeroSpanSaveFile", save, "prgLoopCnt", str(frames)])
        with ZeroSpanPlayer(save) as player:
            recorded = [np.asarray(f, np.float64) for _, f in player.frames()]
        want = oracle_block_spectra(cfg, rec.blocks())
        err = worst(peak_rel_err(g, w) for g, w in zip(recorded, want))
        if len(recorded) != frames:
            err = float("inf")
        phases.append(Phase("zero_span_save", frames * cfg.full_size, secs,
                            err, note=f"frames={len(recorded)}"))
        for name, path in (
                ("zero_span_play", save),
                ("zero_span_play_reference",
                 os.path.join(REPO, "tests", "fixtures",
                              "reference_zerospan_1024.save"))):
            with ZeroSpanPlayer(path) as player:
                frm = [np.asarray(f, np.float64) for _, f in player.frames()]
            cfg, state, _, secs = run_cli(
                ["zeroSpanPlay", "zeroSpanPlayFile", path, "tpuCatchUp",
                 str(catch_up), "prgLoopCnt", str(len(frm))], record=False)
            want = oracle_zero_span_iters(frm, cfg.gain)
            err = curves_err(state, want, cfg.gain,
                             ("fft_max", "fft_min", "fft_avg"))
            on_mhz = tones_on_mhz(cfg, state.fft_avg)
            if not on_mhz:
                err = float("inf")
            phases.append(Phase(name, len(frm) * cfg.fft_size, secs, err,
                                note=f"frames={len(frm)} "
                                     f"tones_on_mhz={on_mhz}"))
    return phases


class _Outcomes:
    """pytest plugin counting test outcomes of the in-process run."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.skipped:
            self.skipped += 1
        elif report.failed:
            self.failed += 1
        elif report.when == "call":
            self.passed += 1


def phase_gpu_tests():
    """The ``gpu``-marked tests, in this process (one process per card)."""
    import pytest
    counts = _Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[counts])
    ok = rc == 0 and counts.passed > 0 and not counts.skipped
    return [Phase("gpu_tests", 0, time.perf_counter() - t0,
                  0.0 if ok else float("inf"), tol=0.0,
                  note=f"pytest_rc={int(rc)} passed={counts.passed} "
                       f"failed={counts.failed} skipped={counts.skipped}")]


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def phase_four_cards(fft_size: int = 16384, blocks: int = 8,
                     scan=("quickFullScan",), cli_iters: int = 4):
    """BASELINE config 5 geometry (fftSize 16384, kaiser, 90% overlap)
    through each sharded path on four cards, against the same
    computation on card 0 alone; the band-sharded sweep uses
    quickFullScan (config 4)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kspecanal_tpu import cli
    from kspecanal_tpu.config import SpecConfig, WINDOW_KAISER
    from kspecanal_tpu.io.state import load_state
    from kspecanal_tpu.models import scan as scan_mod
    from kspecanal_tpu.ops.spectrum import curscan_jit
    from kspecanal_tpu.parallel.bandshard import sweep_step_band_sharded
    from kspecanal_tpu.parallel.fftshard import curscan_fft_sharded
    from kspecanal_tpu.parallel.mesh import make_mesh
    from kspecanal_tpu.parallel.stream import (waterfall_stream,
                                               waterfall_stream_sharded)
    from kspecanal_tpu.parallel.timeshard import curscan_time_sharded

    card0 = jax.devices()[0]
    mesh = make_mesh(time=4)
    if len({d.id for d in mesh.devices.flat}) != 4:
        raise RuntimeError(f"mesh devices not distinct: {mesh.devices}")
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft_size,
                     window=WINDOW_KAISER, cur_scan_non_overlap=0.1,
                     x_res=min(512, fft_size)).finalize()
    rng = np.random.default_rng(5)
    re = rng.standard_normal((blocks, cfg.full_size)).astype(np.float32)
    im = rng.standard_normal((blocks, cfg.full_size)).astype(np.float32)

    def on_card0(x):
        return jax.device_put(x, card0)

    def sharded(x, spec):
        arr = jax.device_put(x, NamedSharding(mesh, spec))
        if len({s.device for s in arr.addressable_shards}) != 4:
            raise RuntimeError("input not spread over four devices")
        return arr

    def timed(fn):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, time.perf_counter() - t0

    def lin(x):
        return db_to_lin(x, cfg.gain)

    phases = []
    want = waterfall_stream(on_card0(re), on_card0(im), cfg)
    got, secs = timed(lambda: waterfall_stream_sharded(
        sharded(re, P("time")), sharded(im, P("time")), cfg, mesh))
    err = worst(peak_rel_err(lin(getattr(got, f)), lin(getattr(want, f)))
                for f in got._fields)
    phases.append(Phase("waterfall_stream_sharded_time4", re.size, secs, err))

    want = curscan_jit(on_card0(re[0]), on_card0(im[0]), cfg)
    got, secs = timed(lambda: curscan_time_sharded(
        sharded(re[0], P("time")), sharded(im[0], P("time")), cfg, mesh))
    phases.append(Phase("curscan_time_sharded", cfg.full_size, secs,
                        peak_rel_err(got, want)))
    got, secs = timed(lambda: curscan_fft_sharded(
        sharded(re[0], P()), sharded(im[0], P()), cfg, mesh))
    phases.append(Phase("curscan_fft_sharded", cfg.full_size, secs,
                        peak_rel_err(got, want)))

    scfg, _ = cli.parse_args(list(scan))
    plan = scan_mod.make_scan_plan(scfg)
    sre = rng.standard_normal((plan.num_bands, scfg.full_size)).astype(
        np.float32)
    sim = rng.standard_normal(sre.shape).astype(np.float32)
    oks = np.ones(plan.num_bands, bool)
    oks[1] = False                       # a failed retune's sentinel band
    want = scan_mod.sweep_step_jit(scan_mod.init_state(scfg, plan),
                                   on_card0(sre), on_card0(sim),
                                   on_card0(oks), scfg, plan)
    for name, bmesh in (("sweep_band_sharded_band4",
                         make_mesh(time=1, band=4)),
                        ("sweep_band_sharded_2x2",
                         make_mesh(time=2, band=2))):
        got, secs = timed(lambda: sweep_step_band_sharded(
            scan_mod.init_state(scfg, plan), sre, sim, oks, scfg, plan,
            bmesh))
        err = worst(peak_rel_err(db_to_lin(getattr(got, f), scfg.gain),
                                 db_to_lin(getattr(want, f), scfg.gain))
                    for f in ("fft_cur", "fft_max", "fft_min", "fft_avg"))
        phases.append(Phase(name, sre.size, secs, err,
                            note=f"bands={plan.num_bands}"))

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["zeroSpan", "fftSize", str(fft_size), "window", "kaiser",
                "curScanNonOverlap", "0.1", "tpuSource", "devicesynth",
                "tpuRenderer", "none", "prgLoopCnt", str(cli_iters)]
        states = {}
        t0 = time.perf_counter()
        for key, extra in (("mesh", ["tpuMeshTime", "4"]), ("one", [])):
            path = os.path.join(tmp, key)
            if cli.main(argv + extra + ["tpuStateFile", path]) != 0:
                raise RuntimeError(f"CLI zeroSpan ({key}) failed")
            states[key] = load_state(path, cli.parse_args(argv)[0])
        secs = time.perf_counter() - t0
        err = worst(peak_rel_err(lin(getattr(states["mesh"], f)),
                                 lin(getattr(states["one"], f)))
                    for f in ("fft_max", "fft_min", "fft_avg"))
        phases.append(Phase("cli_zero_span_mesh_time4",
                            cli_iters * cfg.full_size, secs, err))
    return phases


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    try:
        devs = require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    import jax
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    from kspecanal_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print(f"device: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)} "
          f"jax={jax.__version__}", flush=True)
    print(card_report(), flush=True)

    runs = ([phase_four_cards] if args.four_cards else
            [phase_waterfall, phase_reference_defaults, phase_file,
             phase_scans, phase_record_replay, phase_gpu_tests])
    failed = []
    for run in runs:
        try:
            for p in run():
                print(p.line(), flush=True)
                if not p.ok:
                    failed.append(p.name)
        except Exception:
            traceback.print_exc()
            print(f"phase {run.__name__}: FAILED (exception)", flush=True)
            failed.append(run.__name__)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
