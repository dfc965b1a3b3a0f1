"""Card tests: the hot path on an NVIDIA GPU against the float64 oracle.

Run them on the card with ``pytest -m gpu tests/test_gpu.py`` (``python
chip_smoke.py`` runs them inside its own process); elsewhere every test
skips through the ``gpu_device`` fixture.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kspecanal_tpu.config import (CUMU_AVG, SpecConfig, cumu_weights,
                                  window_lut)
from oracle import oracle_curscan, oracle_zero_span_iters

pytestmark = pytest.mark.gpu

# Peak-normalised error of float32 device results against the float64
# oracle (chip_smoke.py's bound for spectra, with its reasoning).
TOL = 5e-6


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("fft,nono,window", [
    (2048, 0.5, "WIN.KAISER"),       # BASELINE config 2
    (16384, 0.1, "WIN.KAISER"),      # BASELINE config 5
    (16384, 0.1, "WIN.ONES"),        # the reference's launch defaults
    (64, 0.1, "WIN.ONES"),           # quickFullScan bands
])
def test_curscan_matches_oracle_on_gpu(gpu_device, fft, nono, window, u8):
    from kspecanal_tpu.ops.spectrum import curscan_auto_batched
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, window=window,
                     cur_scan_non_overlap=nono,
                     x_res=min(512, fft)).finalize()
    rng = np.random.default_rng(fft)
    shape = (2, 4, cfg.full_size)
    if u8:
        planes = rng.integers(0, 256, shape, dtype=np.uint8)
        iq = (planes[0] - 127.0) + 1j * (planes[1] - 127.0)
    else:
        planes = rng.standard_normal(shape).astype(np.float32)
        iq = planes[0].astype(np.float64) + 1j * planes[1]
    run = jax.jit(lambda r, i: curscan_auto_batched(r, i, cfg))
    got = np.asarray(run(jax.device_put(planes[0], gpu_device),
                         jax.device_put(planes[1], gpu_device)))
    win = window_lut(window, fft)
    for b in range(iq.shape[0]):
        want = oracle_curscan(iq[b], fft, nono, win)
        assert _rel(got[b], want) < TOL, b


def _fold_inputs(rng, t=64, f=4096):
    """dB-scale values that differ in the fourth significant digit: a
    TF32 product (10-bit mantissa) rounds them away, float32 keeps them."""
    return -60.0 + 1e-2 * rng.random((t, f))


@pytest.mark.parametrize("path", ["reduce_windows", "zero_span_fold",
                                  "waterfall_stream", "sweep_fold",
                                  "tf32_control"])
def test_weighted_folds_keep_float32_on_gpu(gpu_device, path):
    """The Avg folds pin HIGHEST precision: on the card they must agree
    with float64 far below TF32 rounding.  The matvec folds measured full
    float32 even at DEFAULT on the H100; the scan's (S, S) @ (S, total)
    sweep fold is a matmul, and the control runs it at DEFAULT, where it
    must miss the bound (TF32) — so the bound tells the two apart."""
    from kspecanal_tpu.models import zerospan as zs
    from kspecanal_tpu.ops.dsp import reduce_windows
    from kspecanal_tpu.parallel.stream import waterfall_stream
    rng = np.random.default_rng(3)
    if path in ("sweep_fold", "tf32_control"):
        # the lower-triangular decay matrix of models/scan.py's gathered
        # sweep fold, applied to S = 64 sweeps of dB curves
        x = _fold_inputs(rng).astype(np.float32)
        k = np.arange(x.shape[0])
        wm = np.where(k[None, :] <= k[:, None],
                      2.0 ** -(k[:, None] - k[None, :] + 1.0), 0.0)
        prec = (jax.lax.Precision.HIGHEST if path == "sweep_fold"
                else jax.lax.Precision.DEFAULT)
        got = jax.jit(lambda v: jnp.einsum(
            "si,it->st", jnp.asarray(wm, jnp.float32), v,
            precision=prec))(jax.device_put(x, gpu_device))
        err = np.max(np.abs(np.asarray(got) - wm @ x.astype(np.float64)))
        if path == "tf32_control":
            assert err > 1e-3, err
            return
        assert err < 1e-3, err
        return
    if path == "reduce_windows":
        x = _fold_inputs(rng)
        w = cumu_weights(CUMU_AVG, x.shape[0])
        got = jax.jit(functools.partial(reduce_windows, CUMU_AVG,
                                        weights=w))(
            jax.device_put(x.astype(np.float32), gpu_device))
        want = w @ x.astype(np.float32).astype(np.float64)
        err = np.max(np.abs(np.asarray(got) - want))
    elif path == "zero_span_fold":
        cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=4096,
                         x_res=512).finalize()
        lin = 10.0 ** ((_fold_inputs(rng) + cfg.gain) / 10.0)
        state, _ = jax.jit(lambda s: zs.display_updates(
            zs.init_state(cfg), s, cfg, with_view=False))(
            jax.device_put(lin.astype(np.float32), gpu_device))
        want = oracle_zero_span_iters(lin.astype(np.float32), cfg.gain)[2]
        err = np.max(np.abs(np.asarray(state.fft_avg) - want))
    else:
        cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256,
                         window="WIN.HANNING", cur_scan_non_overlap=0.5,
                         x_res=256).finalize()
        iq = rng.standard_normal((2, 32, cfg.full_size)).astype(np.float32)
        res = waterfall_stream(jax.device_put(iq[0], gpu_device),
                               jax.device_put(iq[1], gpu_device), cfg)
        win = window_lut(cfg.window, cfg.fft_size)
        spectra = [oracle_curscan(r.astype(np.float64) + 1j * i, 256, 0.5,
                                  win) for r, i in zip(iq[0], iq[1])]
        want = oracle_zero_span_iters(spectra, cfg.gain)[2]
        err = np.max(np.abs(np.asarray(res.fft_avg) - want))
    # dB units: float32 keeps ~1e-5 dB at -60 dB; TF32 loses ~3e-2.
    assert err < 1e-3, err


def test_fft_sharded_highest_on_gpu(gpu_device):
    """The bin-sharded matmul DFT at the default tpuPrecision (HIGHEST)
    holds the float32 bound on the card."""
    from kspecanal_tpu.parallel.fftshard import curscan_fft_sharded
    from kspecanal_tpu.parallel.mesh import make_mesh
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=2048,
                     window="WIN.KAISER", cur_scan_non_overlap=0.5,
                     x_res=512).finalize()
    rng = np.random.default_rng(9)
    iq = (rng.standard_normal(cfg.full_size)
          + 1j * rng.standard_normal(cfg.full_size))
    re = jax.device_put(iq.real.astype(np.float32), gpu_device)
    im = jax.device_put(iq.imag.astype(np.float32), gpu_device)
    want = oracle_curscan(iq, 2048, 0.5, window_lut(cfg.window, 2048))
    shard = curscan_fft_sharded(re, im, cfg,
                                make_mesh(time=1, devices=[gpu_device]))
    assert _rel(shard, want) < TOL
