"""Multi-chip sharding on the 8-device virtual CPU mesh: time-sharded
curscan with halo exchange must reproduce the single-device result exactly
(SURVEY.md §4 strategy (c))."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kspecanal_tpu.config import (CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW,
                                  SpecConfig, WINDOW_HANNING, WINDOW_KAISER)
from kspecanal_tpu.ops.spectrum import curscan_jit
from kspecanal_tpu.parallel.mesh import make_mesh
from kspecanal_tpu.parallel.timeshard import (curscan_time_sharded,
                                              make_time_shard_plan)


def iq_pair(rng, n):
    return (jnp.asarray(rng.standard_normal(n), jnp.float32),
            jnp.asarray(rng.standard_normal(n), jnp.float32))


@pytest.mark.parametrize("cumu", [CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_time_sharded_curscan_matches_single(rng, cumu, shards):
    cfg = SpecConfig(fft_size=256, sampling_rate=2.4e6, window=WINDOW_HANNING,
                     cur_scan_non_overlap=0.5, cur_scan_cumu_mode=cumu)
    re, im = iq_pair(rng, cfg.full_size)
    mesh = make_mesh(time=shards)
    got = np.asarray(curscan_time_sharded(re, im, cfg, mesh))
    want = np.asarray(curscan_jit(re, im, cfg))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)


def test_time_sharded_fractional_hop(rng):
    """90% overlap (the deep-waterfall config) with non-uniform window
    starts straddling shard boundaries."""
    cfg = SpecConfig(fft_size=256, sampling_rate=2.4e6, window=WINDOW_KAISER,
                     cur_scan_non_overlap=0.1, cur_scan_cumu_mode=CUMU_AVG)
    re, im = iq_pair(rng, cfg.full_size)
    mesh = make_mesh(time=4)
    got = np.asarray(curscan_time_sharded(re, im, cfg, mesh))
    want = np.asarray(curscan_jit(re, im, cfg))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)


def test_plan_window_partition():
    cfg = SpecConfig(fft_size=256, sampling_rate=2.4e6,
                     cur_scan_non_overlap=0.5)
    plan = make_time_shard_plan(cfg, 4)
    # All windows accounted for exactly once
    n_valid = sum(sum(v) for v in plan.valid)
    assert n_valid == cfg.num_windows
    assert plan.block == cfg.full_size // 4
    assert plan.halo == cfg.fft_size
    # AVG weights sum to 1 across all shards
    total_w = sum(sum(w) for w in plan.weights)
    assert abs(total_w - 1.0) < 1e-9


def test_too_many_shards_rejected():
    cfg = SpecConfig(fft_size=1024, sampling_rate=2.4e6)
    with pytest.raises(ValueError):
        make_time_shard_plan(cfg, 8192)


def test_stream_matches_serial_zero_span(rng):
    """Sharded streaming waterfall == serial zero-span loop, exactly."""
    from kspecanal_tpu.models import zerospan as zs
    from kspecanal_tpu.parallel.stream import (waterfall_stream,
                                               waterfall_stream_sharded)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256, sampling_rate=2.4e6,
                     window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                     x_res=256).finalize()
    T = 16
    re = jnp.asarray(rng.standard_normal((T, cfg.full_size)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((T, cfg.full_size)), jnp.float32)

    # Serial reference: the per-iteration jitted step
    state = zs.init_state(cfg)
    rows = []
    for t in range(T):
        state, view = zs.zero_span_step_jit(state, re[t], im[t], cfg)
    # Single-chip batched stream
    res1 = waterfall_stream(re, im, cfg)
    np.testing.assert_allclose(np.asarray(res1.fft_max),
                               np.asarray(state.fft_max), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res1.fft_min),
                               np.asarray(state.fft_min), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res1.fft_avg),
                               np.asarray(state.fft_avg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(res1.fft_cur),
                               np.asarray(state.fft_cur), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res1.rows[-1]),
                               np.asarray(state.heatmap[T - 1]),
                               rtol=1e-5, atol=1e-5)
    # Sharded stream over 8 virtual chips
    mesh = make_mesh(time=8)
    res8 = waterfall_stream_sharded(re, im, cfg, mesh)
    np.testing.assert_allclose(np.asarray(res8.fft_avg),
                               np.asarray(res1.fft_avg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res8.fft_max),
                               np.asarray(res1.fft_max), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res8.rows),
                               np.asarray(res1.rows), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res8.fft_cur),
                               np.asarray(res1.fft_cur), rtol=1e-6, atol=1e-6)


def test_band_sharded_scan_matches_single(rng):
    from kspecanal_tpu.models import scan as scan_mod
    from kspecanal_tpu.parallel.bandshard import sweep_step_band_sharded
    cfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=96e6,
                     sampling_rate=2e6, fft_size=128, x_res=128,
                     window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                     scan_range_non_overlap=0.5).finalize()
    plan = scan_mod.make_scan_plan(cfg)
    B = plan.num_bands
    re = jnp.asarray(rng.standard_normal((B, cfg.full_size)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((B, cfg.full_size)), jnp.float32)
    oks = jnp.ones(B, bool)
    s_single = scan_mod.init_state(cfg, plan)
    s_shard = scan_mod.init_state(cfg, plan)
    for _ in range(2):
        s_single = scan_mod.sweep_step_jit(s_single, re, im, oks, cfg, plan)
    mesh = make_mesh(time=1, band=4)  # 8 bands over 4 devices
    for _ in range(2):
        s_shard = sweep_step_band_sharded(s_shard, re, im, oks, cfg, plan,
                                          mesh)
    for a, b in zip(s_single[:5], s_shard[:5]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-5)


def test_chunked_stream_matches_monolithic(rng):
    """Long-session chunked processing == one-shot batched stream, exactly
    (cross-chunk decay continuation)."""
    from kspecanal_tpu.parallel.stream import (run_stream_session,
                                               waterfall_stream)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                     window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                     x_res=128).finalize()
    T = 20
    re = rng.standard_normal((T * cfg.full_size,)).astype(np.float32)
    im = rng.standard_normal((T * cfg.full_size,)).astype(np.float32)
    mono = waterfall_stream(jnp.asarray(re.reshape(T, -1)),
                            jnp.asarray(im.reshape(T, -1)), cfg)
    chunked = run_stream_session(re, im, cfg, chunk_blocks=7)  # uneven
    np.testing.assert_allclose(np.asarray(chunked.fft_avg),
                               np.asarray(mono.fft_avg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(chunked.fft_max),
                               np.asarray(mono.fft_max), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(chunked.fft_min),
                               np.asarray(mono.fft_min), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(chunked.fft_cur),
                               np.asarray(mono.fft_cur), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(chunked.rows, np.asarray(mono.rows),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_fft_sharded_curscan_matches_single(rng, shards):
    """Tensor-parallel (bin-axis sharded) curscan == single-device."""
    from kspecanal_tpu.parallel.fftshard import (curscan_fft_sharded,
                                                 supports_fft_sharding)
    cfg = SpecConfig(fft_size=2048, sampling_rate=2.4e6, window=WINDOW_KAISER,
                     cur_scan_non_overlap=0.5, cur_scan_cumu_mode=CUMU_AVG)
    assert supports_fft_sharding(cfg, shards)
    re, im = iq_pair(rng, cfg.full_size)
    mesh = make_mesh(time=shards)
    got = np.asarray(curscan_fft_sharded(re, im, cfg, mesh))
    want = np.asarray(curscan_jit(re, im, cfg))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)


def test_fft_sharded_max_mode(rng):
    from kspecanal_tpu.parallel.fftshard import curscan_fft_sharded
    cfg = SpecConfig(fft_size=2048, sampling_rate=2.4e6, window=WINDOW_HANNING,
                     cur_scan_non_overlap=0.5, cur_scan_cumu_mode=CUMU_MAX)
    re, im = iq_pair(rng, cfg.full_size)
    mesh = make_mesh(time=4)
    got = np.asarray(curscan_fft_sharded(re, im, cfg, mesh))
    want = np.asarray(curscan_jit(re, im, cfg))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)


def test_stream_rows_match_session_with_adj(rng):
    """Stream rows with a baseline == the serial zero-span heatmap rows
    (display-time subtraction, state curves unadjusted)."""
    import functools
    from kspecanal_tpu.models import zerospan as zs
    import kspecanal_tpu.parallel.stream as stream_mod
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                     window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                     x_res=128).finalize()
    adj = jnp.asarray(rng.standard_normal(cfg.fft_size), jnp.float32)
    T = 5
    re = jnp.asarray(rng.standard_normal((T, cfg.full_size)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((T, cfg.full_size)), jnp.float32)
    dbs, rows = jax.jit(
        functools.partial(stream_mod._batch_products, cfg=cfg))(
            re, im, adj=adj)
    state = zs.init_state(cfg)
    for t in range(T):
        state, view = zs.zero_span_step_adj_jit(state, re[t], im[t], adj, cfg)
        np.testing.assert_allclose(np.asarray(rows[t]),
                                   np.asarray(state.heatmap[t]),
                                   rtol=1e-5, atol=1e-5)
    # state curves are unadjusted in both paths
    np.testing.assert_allclose(np.asarray(jnp.max(dbs, axis=0)),
                               np.asarray(state.fft_max), rtol=1e-5, atol=1e-5)


def test_raw_u8_device_decode_matches_host():
    """waterfall_stream_u8 (raw bytes decoded in-jit) == host decode path."""
    from kspecanal_tpu.io.sources import load_rtlsdr_capture
    from kspecanal_tpu.parallel.stream import (waterfall_stream,
                                               waterfall_stream_u8)
    rng = np.random.default_rng(31)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256, sampling_rate=2.4e6,
                     window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                     x_res=256).finalize()
    t = 3
    raw = rng.integers(0, 256, size=t * 2 * cfg.full_size).astype(np.uint8)
    x = raw.astype(np.float32) - 127.0
    re = jnp.asarray(x[0::2].reshape(t, cfg.full_size))
    im = jnp.asarray(x[1::2].reshape(t, cfg.full_size))
    want = waterfall_stream(re, im, cfg)
    got = waterfall_stream_u8(
        jnp.asarray(raw.reshape(t, 2 * cfg.full_size)), cfg)
    np.testing.assert_allclose(np.asarray(got.rows), np.asarray(want.rows),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got.fft_avg),
                               np.asarray(want.fft_avg),
                               rtol=1e-6, atol=1e-7)


def test_waterfall_stream_sharded_u8_planes(rng):
    """Raw uint8 planes compose with the time-sharded stream (pods get
    the 2 B/sample host link too): identical to the f32-decoded sharded
    run and to the unsharded u8 run."""
    from kspecanal_tpu.parallel.stream import (waterfall_stream,
                                               waterfall_stream_sharded)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256, sampling_rate=2.4e6,
                     window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                     x_res=256).finalize()
    mesh = make_mesh(time=4)
    t = 8
    u8r = jnp.asarray(rng.integers(0, 256, (t, cfg.full_size)).astype("uint8"))
    u8i = jnp.asarray(rng.integers(0, 256, (t, cfg.full_size)).astype("uint8"))
    got = waterfall_stream_sharded(u8r, u8i, cfg, mesh)
    want = waterfall_stream_sharded(
        u8r.astype(jnp.float32) - 127.0, u8i.astype(jnp.float32) - 127.0,
        cfg, mesh)
    base = waterfall_stream(u8r, u8i, cfg)
    for f in got._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(base, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
