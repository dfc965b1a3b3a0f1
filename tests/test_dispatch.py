"""The spectral entry point on any backend: ``curscan_auto_batched``
against the float64 oracle, its choice of path by FFT size and dtype,
the matmul FFT, the HIGHEST precision of every hot-path matmul, and the
compile-cache location."""
import functools
import os
from unittest import mock

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest

from kspecanal_tpu.config import (CUMU_AVG, SpecConfig, WINDOW_HANNING,
                                  WINDOW_KAISER, cumu_weights, window_lut)
from kspecanal_tpu.ops import spectrum
from kspecanal_tpu.ops.mxu_fft import _factorize, fft_mxu
from kspecanal_tpu.ops.spectrum import curscan_auto_batched
from oracle import oracle_curscan

HIGHEST = jax.lax.Precision.HIGHEST


def test_mxu_fft_matches_numpy(rng):
    for n in (64, 256, 2048, 250):
        x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
        xr, xi = jax.jit(fft_mxu)(jnp.asarray(x.real, jnp.float32),
                                  jnp.asarray(x.imag, jnp.float32))
        got = np.asarray(xr) + 1j * np.asarray(xi)
        want = np.fft.fft(x, axis=-1)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_factorize():
    assert _factorize(16384) == (128, 128)
    assert _factorize(2048) == (64, 32)
    assert _factorize(64) == (8, 8)
    assert _factorize(13) == (13, 1)  # prime -> XLA fallback


def test_auto_dispatch_runs_everywhere(rng):
    """curscan_auto_batched must work for any config on any backend."""
    for nono in (0.5, 0.1):
        cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256,
                         sampling_rate=2.4e6, window=WINDOW_HANNING,
                         cur_scan_non_overlap=nono).finalize()
        re = jnp.asarray(rng.standard_normal((2, cfg.full_size)), jnp.float32)
        im = jnp.asarray(rng.standard_normal((2, cfg.full_size)), jnp.float32)
        out = jax.jit(lambda r, i: curscan_auto_batched(r, i, cfg))(re, im)
        assert out.shape == (2, cfg.fft_size)


def test_auto_dispatch_u8_decodes_off_fused_path():
    """u8 planes through curscan_auto_batched equal the host-decoded
    float32 planes."""
    rng = np.random.default_rng(32)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256, sampling_rate=2.4e6,
                     window=WINDOW_HANNING,
                     cur_scan_non_overlap=0.5).finalize()
    raw_re = rng.integers(0, 256, (2, cfg.full_size), dtype=np.uint8)
    raw_im = rng.integers(0, 256, (2, cfg.full_size), dtype=np.uint8)
    got = curscan_auto_batched(jnp.asarray(raw_re), jnp.asarray(raw_im), cfg)
    want = curscan_auto_batched(
        jnp.asarray(raw_re.astype(np.float32) - 127.0),
        jnp.asarray(raw_im.astype(np.float32) - 127.0), cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mode", ["AVG", "MAX", "MIN"])
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("nono", [0.5, 0.1], ids=["ovl50", "ovl90"])
@pytest.mark.parametrize("fft", [2048, 16384])
def test_auto_batched_matches_oracle(fft, nono, u8, mode):
    """The production entry point at the BASELINE sizes (config 2's
    fft2048, config 5's fft16384; 50% and 90% overlap; float32 planes and
    raw rtl_sdr bytes) against the serial float64 oracle."""
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                     window=WINDOW_KAISER, cur_scan_non_overlap=nono,
                     cur_scan_cumu_mode=mode).finalize()
    rng = np.random.default_rng(fft + int(nono * 10))
    if u8:
        planes = rng.integers(0, 256, (2, 1, cfg.full_size), dtype=np.uint8)
        iq = (planes[0, 0] - 127.0) + 1j * (planes[1, 0] - 127.0)
    else:
        planes = rng.standard_normal((2, 1, cfg.full_size)).astype(
            np.float32)
        iq = planes[0, 0].astype(np.float64) + 1j * planes[1, 0]
    got = np.asarray(jax.jit(lambda r, i: curscan_auto_batched(r, i, cfg))(
        jnp.asarray(planes[0]), jnp.asarray(planes[1]))[0], np.float64)
    want = oracle_curscan(iq, fft, nono, window_lut(WINDOW_KAISER, fft), mode)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=1e-6 * np.max(want))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.uint8],
                         ids=["f32", "u8"])
@pytest.mark.parametrize("fft", [64, 128, 256, 2048])
def test_dispatch_routes_by_size_and_dtype(fft, dtype):
    """Every FFT size takes the gather + FFT chain (the direct DFT lost to
    cuFFT at each size measured); raw u8 planes reach it decoded
    (``x - 127``) as float32."""
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                     cur_scan_non_overlap=0.5, x_res=min(512, fft)).finalize()
    seen = []

    def fake(name):
        return lambda r, i, c: seen.append((name, r.dtype, float(r[0, 0])))

    with mock.patch.object(spectrum, "curscan_batched", fake("chain")):
        x = jnp.full((1, cfg.full_size), 200, dtype)
        spectrum.curscan_auto_batched(x, x, cfg)
    decoded = 73.0 if dtype == jnp.uint8 else 200.0
    assert seen == [("chain", jnp.float32, decoded)]


def test_dispatch_never_asks_the_backend(rng):
    """The route is a function of the input; no backend or device query
    is made."""
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256, sampling_rate=2.4e6,
                     cur_scan_non_overlap=0.5).finalize()
    re = jnp.asarray(rng.standard_normal((1, cfg.full_size)), jnp.float32)

    def forbidden(*a, **k):
        raise AssertionError("dispatch queried the backend")

    with mock.patch.object(jax, "default_backend", forbidden), \
            mock.patch.object(jax, "devices", forbidden):
        out = jax.jit(lambda r: spectrum.curscan_auto_batched(r, r, cfg))(re)
    assert out.shape == (1, 256)


# ---------------------------------------------------------------------------
# Every float32 matmul on the hot path asks for HIGHEST precision
# ---------------------------------------------------------------------------

def _dots(closed):
    """(precision, operand dtype) of every dot_general, nested jaxprs
    (jit, shard_map, scan bodies) included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append((eqn.params["precision"],
                              eqn.invars[0].aval.dtype))
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    if isinstance(sub, jex.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jex.Jaxpr):
                        walk(sub)

    walk(closed.jaxpr)
    return found


def _zs_cfg(**kw):
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=64, sampling_rate=2.4e6,
                      window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
                      x_res=64, **kw).finalize()


def _planes(t, cfg):
    z = jnp.ones((t, cfg.full_size), jnp.float32)
    return z, z


def _hot_path(name):
    """(function, args) of one hot-path call site."""
    from kspecanal_tpu.models import scan as scan_mod
    from kspecanal_tpu.models import zerospan as zs
    from kspecanal_tpu.ops import dsp
    from kspecanal_tpu.parallel import stream
    from kspecanal_tpu.parallel.fftshard import curscan_fft_sharded
    from kspecanal_tpu.parallel.mesh import make_mesh
    from kspecanal_tpu.parallel.timeshard import curscan_time_sharded
    cfg = _zs_cfg()
    re, im = _planes(8, cfg)
    mesh = make_mesh(time=4)
    curves = (jnp.zeros(64),) * 3
    if name == "reduce_windows":
        w = cumu_weights(CUMU_AVG, 7)
        return (lambda m: dsp.reduce_windows(CUMU_AVG, m, w),
                (jnp.ones((7, 64)),))
    if name == "curscan":
        return functools.partial(spectrum.curscan, cfg=cfg), (re[0], im[0])
    if name == "waterfall_stream":
        return functools.partial(stream.waterfall_stream, cfg=cfg), (re, im)
    if name in ("stream_step_first", "stream_step_cont"):
        first = name.endswith("first")
        return (lambda r, i: stream.waterfall_stream_step(
            curves, r, i, cfg, first), (re, im))
    if name == "zero_span_steps":
        st = zs.init_state(cfg)
        return lambda r, i: zs.zero_span_steps(st, r, i, cfg), (re, im)
    if name == "stream_sharded":
        return stream._build_stream_sharded(cfg, 8, mesh), (re, im)
    if name == "time_sharded":
        return (lambda r, i: curscan_time_sharded(r, i, cfg, mesh),
                (re[0], im[0]))
    if name == "fft_sharded":
        return (lambda r, i: curscan_fft_sharded(r, i, cfg, mesh),
                (re[0], im[0]))
    if name == "scan_sweeps":
        scfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=94e6,
                          sampling_rate=2e6, fft_size=64, x_res=64,
                          cur_scan_non_overlap=0.5).finalize()
        plan = scan_mod.make_scan_plan(scfg)
        z = jnp.ones((3, plan.num_bands, scfg.full_size), jnp.float32)
        oks = jnp.ones((3, plan.num_bands), bool)
        st = scan_mod.init_state(scfg, plan)
        return (lambda r, i: scan_mod.sweep_steps_jit(
            st, r, i, oks, scfg, plan), (z, z))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "reduce_windows", "curscan", "waterfall_stream", "stream_step_first",
    "stream_step_cont", "zero_span_steps", "stream_sharded", "time_sharded",
    "fft_sharded", "scan_sweeps"])
def test_hot_path_dots_are_highest(name):
    """An f32 matmul without HIGHEST may run in TF32 on the GPU (about
    three decimal digits); every one on the hot path must ask for full
    float32 products (fft_sharded via the default tpuPrecision)."""
    fn, args = _hot_path(name)
    dots = _dots(jax.make_jaxpr(fn)(*args))
    assert dots, f"{name}: no matmul found"
    for precision, dtype in dots:
        assert dtype == jnp.float32
        assert precision == (HIGHEST, HIGHEST), (name, precision)


# ---------------------------------------------------------------------------
# Compile cache location
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    from kspecanal_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        got = compile_cache.enable_compile_cache()
        assert got == compile_cache.DEFAULT_CACHE_DIR
        assert ("jax_compilation_cache_dir", got) in updates
        # a fixed directory of the checkout, which git ignores
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert os.path.dirname(got) == repo
        with open(os.path.join(repo, ".gitignore")) as f:
            assert os.path.basename(got) + "/" in f.read().split()
    else:
        path = str(tmp_path / env_dir)
        monkeypatch.setenv(compile_cache.ENV_VAR, path)
        assert compile_cache.enable_compile_cache() == path
        assert updates == []          # JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


# ---------------------------------------------------------------------------
# Long decay folds: underflowed weights never meet a -inf dB bin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fold", ["zero_span_catchup", "waterfall_stream",
                                  "stream_step_cont"])
def test_long_avg_fold_with_zero_bin_matches_serial(fold):
    """A fold over more than ~150 spectra (where the oldest float32 decay
    weights underflow to 0) of spectra with an exactly-zero bin (-inf dB)
    gives the serial fold's result — -inf there, no NaN anywhere."""
    from kspecanal_tpu.models import zerospan as zs
    from kspecanal_tpu.parallel import stream
    cfg = _zs_cfg()
    k = 200
    rng = np.random.default_rng(11)
    lin = rng.random((k, cfg.fft_size)).astype(np.float32) + 0.1
    lin[:, 5] = 0.0
    serial = zs.init_state(cfg)
    for row in lin:
        serial, _ = zs.display_update_jit(serial, jnp.asarray(row), cfg)
    want = np.asarray(serial.fft_avg)
    assert np.isneginf(want[5]) and np.isfinite(np.delete(want, 5)).all()
    if fold == "zero_span_catchup":
        got = zs.display_updates_jit(zs.init_state(cfg), jnp.asarray(lin),
                                     cfg, with_view=False)[0].fft_avg
    else:
        dbs = jnp.asarray(10 * np.log10(lin) - cfg.gain)
        with mock.patch.object(stream, "_batch_products",
                               lambda r, i, c, adj=None: (dbs, dbs)):
            if fold == "waterfall_stream":
                got = stream.waterfall_stream.__wrapped__(
                    jnp.zeros((k, 1)), None, cfg).fft_avg
            else:
                # a continuing chunk: carry -inf at bin 5 in, 200 rows more
                z = jnp.zeros(cfg.fft_size).at[5].set(-jnp.inf)
                got = stream.waterfall_stream_step.__wrapped__(
                    (z, z, z), jnp.zeros((k, 1)), None, cfg, False)[0][2]
    got = np.asarray(got)
    assert not np.isnan(got).any()
    assert np.isneginf(got[5])
    np.testing.assert_allclose(np.delete(got, 5), np.delete(want, 5),
                               rtol=1e-5, atol=1e-4)
