"""Measure the spectral kernels on the GPU: the gather + FFT chain at
fftSize 64-2048, 50% and 90% overlap, f32 and u8 input, each with a
kernel breakdown from a profiler trace; one trace of the config-2 session
step; the tone-synth sin/cos; and the error of each ``tpuPrecision`` rung
on the bin-sharded matmul DFT.

    python scripts/spectral_probe.py [--out DIR]

Prints one line per measurement; traces go under DIR (default
``chiprun_out/probe``) and are deleted once reduced.  Times are
``block_until_ready`` wall times, median and quartiles over repeats.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kspecanal_tpu.config import SpecConfig, window_lut  # noqa: E402
from kspecanal_tpu.ops import spectrum  # noqa: E402

SAMPLES_PER_CALL = 1 << 25


def timeit(fn, *args, reps: int = 10):
    """(median, q1, q3) seconds of ``fn(*args)`` after one warm-up call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    q = statistics.quantiles(ts, n=4)
    return statistics.median(ts), q[0], q[2]


_CATEGORIES = (("fft", ("fft",)), ("gemm", ("gemm", "cutlass", "xmma",
                                            "dot", "sm90")),
               ("gather", ("gather",)), ("reduce", ("reduce",)),
               ("copy", ("copy", "memcpy", "memset")))


def kernel_breakdown(trace_dir: str, wall_s: float):
    """Device kernel time by category and the device busy share over the
    traced wall time, from the trace's GPU stream lines."""
    from jax.profiler import ProfileData
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    per_name, spans = {}, []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_name[ev.name] = per_name.get(ev.name, 0.0) + \
                    ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    cats = {}
    for name, ns in per_name.items():
        low = name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in low for k in keys)), "fusion")
        cats[cat] = cats.get(cat, 0.0) + ns
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return cats, busy / (wall_s * 1e9), top


def traced(fn, args, trace_dir: str, reps: int = 3):
    """Kernel breakdown of ``reps`` calls; the busy share is taken over
    the calls alone, not the profiler's start and stop."""
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(fn(*args))
        wall = time.perf_counter() - t0
    cats, busy, top = kernel_breakdown(trace_dir, wall)
    shutil.rmtree(trace_dir, ignore_errors=True)
    total = sum(cats.values()) or 1.0
    share = " ".join(f"{c}={ns / total:.2f}" for c, ns in
                     sorted(cats.items(), key=lambda kv: -kv[1]))
    names = "; ".join(f"{n[:60]}={ns / 1e6 / reps:.3f}ms" for n, ns in top)
    return f"busy={busy:.2f} kernel_share[{share}] top[{names}]"


def planes(cfg, blocks: int, u8: bool, key):
    shape = (2, blocks, cfg.full_size)
    if u8:
        x = jax.random.randint(key, shape, 0, 256).astype(jnp.uint8)
    else:
        x = jax.random.normal(key, shape, jnp.float32)
    return x[0], x[1]


def chain_breakdown(out_dir: str):
    key = jax.random.key(0)
    for fft in (64, 128, 256, 2048):
        for nono in (0.5, 0.1):
            cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft,
                             window="WIN.KAISER", cur_scan_non_overlap=nono,
                             x_res=min(512, fft)).finalize()
            blocks = SAMPLES_PER_CALL // cfg.full_size
            for u8 in (False, True):
                re, im = planes(cfg, blocks, u8, key)
                f = jax.jit(lambda r, i, cfg=cfg:
                            spectrum.curscan_auto_batched(r, i, cfg))
                med, q1, q3 = timeit(f, re, im)
                tag = (f"fft{fft} ovl{int(round((1 - nono) * 100))} "
                       f"{'u8' if u8 else 'f32'}")
                br = traced(f, (re, im), os.path.join(out_dir, "t"))
                print(f"chain {tag}: {blocks * cfg.full_size / med / 1e9:.3f}"
                      f" Gsamp/s median_ms={med * 1e3:.3f} "
                      f"q1_ms={q1 * 1e3:.3f} q3_ms={q3 * 1e3:.3f} {br}",
                      flush=True)
                del re, im


def config2_session_trace(out_dir: str, blocks: int = 1024):
    """The catch-up session step of BASELINE config 2 (headless)."""
    from kspecanal_tpu.io.sources import DeviceSynthIQSource
    from kspecanal_tpu.models import zerospan as zs
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=2048, window="WIN.KAISER",
                     cur_scan_non_overlap=0.5, x_res=512).finalize()
    src = DeviceSynthIQSource(seed=0)
    re, im = src.read_device_batch(blocks, cfg.full_size)
    state = zs.init_state(cfg)
    step = jax.jit(lambda s, r, i: zs.zero_span_steps(s, r, i, cfg,
                                                     with_view=False)[0])
    med, q1, q3 = timeit(step, state, re, im)
    br = traced(step, (state, re, im), os.path.join(out_dir, "s"))
    print(f"config2_step blocks={blocks}: "
          f"{blocks * cfg.full_size / med / 1e9:.3f} Gsamp/s "
          f"median_ms={med * 1e3:.3f} q1_ms={q1 * 1e3:.3f} "
          f"q3_ms={q3 * 1e3:.3f} {br}", flush=True)
    med, _, _ = timeit(lambda: src.read_device_batch(blocks, cfg.full_size))
    print(f"config2_synth blocks={blocks}: median_ms={med * 1e3:.3f}",
          flush=True)


def sincos(n: int = 1 << 24, tones: int = 3):
    """The integer-phase polynomial sin/cos against jnp.sin/jnp.cos."""
    from kspecanal_tpu.io.sources import _sincos_from_phase_u32
    phase = jax.random.bits(jax.random.key(1), (tones, n), jnp.uint32)
    poly = jax.jit(lambda p: [a.sum(0) for a in _sincos_from_phase_u32(p)])
    scale = float(2.0 * np.pi / 2.0 ** 32)
    xla = jax.jit(lambda p: [jnp.sin(p.astype(jnp.float32) * scale).sum(0),
                             jnp.cos(p.astype(jnp.float32) * scale).sum(0)])
    for name, fn in (("poly", poly), ("jnp", xla)):
        med, q1, q3 = timeit(fn, phase)
        print(f"sincos {name} tones={tones} n={n}: median_ms={med * 1e3:.3f}"
              f" q1_ms={q1 * 1e3:.3f} q3_ms={q3 * 1e3:.3f}", flush=True)
    ref = 2.0 * np.pi * np.asarray(phase[:, :4096], np.float64) / 2.0 ** 32
    s, c = (np.asarray(a) for a in jax.jit(_sincos_from_phase_u32)(
        phase[:, :4096]))
    print(f"sincos poly max_abs_err sin={np.max(np.abs(s - np.sin(ref))):.2e}"
          f" cos={np.max(np.abs(c - np.cos(ref))):.2e}", flush=True)


def precision_rungs():
    """Error of each tpuPrecision rung on the bin-sharded matmul DFT
    (one-device mesh), against the float64 oracle, on noise input."""
    import dataclasses
    from oracle import oracle_curscan
    from kspecanal_tpu.parallel.fftshard import curscan_fft_sharded
    from kspecanal_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(7)
    mesh = make_mesh(time=1)
    for fft in (64, 2048):
        base = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft,
                          window="WIN.KAISER", cur_scan_non_overlap=0.5,
                          x_res=min(512, fft)).finalize()
        iq = (rng.standard_normal(base.full_size)
              + 1j * rng.standard_normal(base.full_size))
        want = oracle_curscan(iq, fft, 0.5, window_lut(base.window, fft))
        re = jnp.asarray(iq.real, jnp.float32)
        im = jnp.asarray(iq.imag, jnp.float32)
        for prec in ("HIGHEST", "HIGH", "DEFAULT"):
            cfg = dataclasses.replace(base, tpu_precision=prec)
            got = np.asarray(curscan_fft_sharded(re, im, cfg, mesh))
            err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
            print(f"precision fft{fft} {prec}: fftshard_err={err:.3e}",
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "probe"))
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"spectral_probe: needs a GPU, found {dev.platform}")
    print(f"device: {dev.device_kind} count={len(jax.devices())}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    precision_rungs()
    sincos()
    config2_session_trace(args.out)
    chain_breakdown(args.out)


if __name__ == "__main__":
    main()
