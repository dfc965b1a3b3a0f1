"""Streaming waterfall: process a long IQ stream as many zero-span
iterations in parallel — the data-parallel throughput path (BASELINE.json
configs 2 and 5).

The reference's zero-span loop (kspecanal.py:460-505) is serial: one
capture -> one curscan -> one heatmap row, with only the windows inside a
single curscan available for batching.  But across iterations the products
are reduction-structured, so the whole stream parallelizes exactly:

  * every heatmap row depends only on its own IQ block  -> fully parallel
  * Max/Min curves are associative reductions over rows -> pmax/pmin
  * the Avg curve's sequential (a+b)/2 decay (kspecanal.py:137-139,476)
    has closed-form per-iteration weights (config.cumu_weights), and each
    device knows its blocks' GLOBAL iteration indices statically
    -> weighted partial + psum reproduces the serial result EXACTLY.

Note the zero-span curves cumulate in the dB domain (post LogNoGain,
kspecanal.py:469-476) while the per-curscan window cumulation is linear —
both are preserved here.

Single-device (`waterfall_stream`) and sharded (`waterfall_stream_sharded`)
entry points share the same per-block body; the sharded one runs under
shard_map over the mesh 'time' axis with the row axis left sharded (each
device keeps its own waterfall slab — assembling the full heatmap is an
optional all_gather for display only).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kspecanal_tpu.config import CUMU_AVG, SpecConfig, cumu_weights
from kspecanal_tpu.ops import dsp
from kspecanal_tpu.ops.spectrum import curscan_auto_batched


class StreamResult(NamedTuple):
    rows: jax.Array      # (T, hm_width) dB waterfall rows
    fft_max: jax.Array   # (fft_size,) curves over the whole stream (dB)
    fft_min: jax.Array
    fft_avg: jax.Array
    fft_cur: jax.Array   # last iteration's spectrum (dB)


def decode_u8_on_device(raw: jax.Array):
    """In-jit decode of raw rtl_sdr bytes: (..., 2*n) uint8 interleaved I/Q
    with a value-127 offset (octave/load_rtlsdr.m:8-13) -> float32 planes.

    Shipping RAW bytes to the device (2 B/sample) instead of float32
    planes (8 B/sample) quarters the host->device transfer of offline
    capture analysis.  The decode itself is a trivial elementwise op XLA
    fuses away.
    """
    x = raw.astype(jnp.float32) - 127.0
    return x[..., 0::2], x[..., 1::2]


def _batch_products(iq_re, iq_im, cfg: SpecConfig, adj=None):
    """All blocks' zero-span DSP: batched curscan -> LogNoGain -> heatmap
    rows.

    ``adj`` is the optional signal-level baseline: like the reference, it
    is a DISPLAY-time subtraction (kspecanal.py:400-411) — rows are
    compressed from the adjusted spectra while the returned dB spectra
    (which feed the max/min/avg state curves) stay unadjusted."""
    spec_lin = curscan_auto_batched(iq_re, iq_im, cfg)   # (T, fft_size)
    # Honor the configured display chain (gZeroSpanFftDispProcMode,
    # kspecanal.py:63,469) — models/zerospan.py does the same, so a
    # non-default chain keeps both paths identical.  Applied per row:
    # HistLowClip reduces over its input, so the batch axis must not leak
    # into its min/max.
    dbs = jax.vmap(lambda s: dsp.fftvals_dispproc(
        s, cfg.zero_span_disp_proc, gain=cfg.gain))(spec_lin)
    disp = dbs if adj is None else dbs - adj[None, :]
    rows = jax.vmap(
        lambda d: dsp.compress_1d(d, cfg.plt_compress_hm, cfg.x_res))(disp)
    return dbs, rows


@functools.partial(jax.jit, static_argnames=("cfg",))
def waterfall_stream(iq_re: jax.Array, iq_im: jax.Array,
                     cfg: SpecConfig) -> StreamResult:
    """(T, full_size) IQ planes -> waterfall rows + exact curves, one chip.
    All T iterations batch through one device program."""
    dbs, rows = _batch_products(iq_re, iq_im, cfg)
    t = iq_re.shape[0]
    return StreamResult(
        rows=rows,
        fft_max=jnp.max(dbs, axis=0),
        fft_min=jnp.min(dbs, axis=0),
        fft_avg=dsp.weighted_rows(cumu_weights(CUMU_AVG, t), dbs),
        fft_cur=dbs[-1],
    )


def _stream_shard_body(iq_re, iq_im, weights_tbl, cfg: SpecConfig,
                       num_shards: int):
    k = jax.lax.axis_index("time")
    dbs, rows = _batch_products(iq_re, iq_im, cfg)
    partial = dsp.weighted_rows(weights_tbl[k], dbs)
    fft_avg = jax.lax.psum(partial, "time")
    fft_max = jax.lax.pmax(jnp.max(dbs, axis=0), "time")
    fft_min = jax.lax.pmin(jnp.min(dbs, axis=0), "time")
    # Cur = globally-last block's spectrum: only the last shard's last row;
    # psum of a one-hot masked value broadcasts it losslessly.
    is_last = (k == num_shards - 1).astype(dbs.dtype)
    fft_cur = jax.lax.psum(dbs[-1] * is_last, "time")
    return rows, fft_max, fft_min, fft_avg, fft_cur


@functools.lru_cache(maxsize=16)
def _build_stream_sharded(cfg: SpecConfig, t_total: int, mesh: Mesh):
    s = mesh.shape["time"]
    if t_total % s:
        raise ValueError(f"stream length {t_total} not divisible by "
                         f"{s} shards")
    w = cumu_weights(CUMU_AVG, t_total).reshape(s, t_total // s)
    weights_tbl = jnp.asarray(w, jnp.float32)

    fn = shard_map(
        functools.partial(_stream_shard_body, cfg=cfg, num_shards=s),
        mesh=mesh,
        in_specs=(P("time"), P("time"), P()),
        out_specs=(P("time"), P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def run(iq_re, iq_im):
        rows, fmax, fmin, favg, fcur = fn(iq_re, iq_im, weights_tbl)
        return StreamResult(rows, fmax, fmin, favg, fcur)

    return run


def waterfall_stream_sharded(iq_re: jax.Array, iq_im: jax.Array,
                             cfg: SpecConfig, mesh: Mesh) -> StreamResult:
    """(T, full_size) IQ sharded over the mesh 'time' axis (T % S == 0).
    Rows come back sharded over 'time'; curves replicated and exact."""
    run = _build_stream_sharded(cfg, iq_re.shape[0], mesh)
    return run(iq_re, iq_im)


# ---------------------------------------------------------------------------
# Chunked long streams (BASELINE.json config 5: minutes of IQ)
# ---------------------------------------------------------------------------

def _cont_weights(t: int) -> np.ndarray:
    """Decay weights for a NON-first chunk: the incoming average is a live
    value, so every new block decays it by 2 (f = f_prev*2^-T + sum w_i x_i
    with w_i = 2^-(t-i)) — no first-copy doubling."""
    i = np.arange(t)
    return 2.0 ** -(t - i.astype(np.float64))


@functools.partial(jax.jit, static_argnames=("cfg",))
def waterfall_stream_u8(raw: jax.Array, cfg: SpecConfig) -> StreamResult:
    """(T, 2*full_size) raw capture bytes -> StreamResult.

    The interleaved bytes deinterleave into uint8 PLANES (still
    1 B/plane/sample) which flow into ``curscan_auto_batched`` as-is; it
    decodes them with the elementwise ``x - 127``, which XLA fuses into
    the framing gather."""
    return waterfall_stream(raw[..., 0::2], raw[..., 1::2], cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "first"))
def waterfall_stream_step(carry, iq_re, iq_im, cfg: SpecConfig, first: bool):
    """One chunk of a long session: fold (T_chunk, full_size) IQ into the
    running (max, min, avg) curves; returns new carry + this chunk's
    waterfall rows.  Exact continuation of the serial decay across chunks.
    """
    fmax, fmin, favg = carry
    dbs, rows = _batch_products(iq_re, iq_im, cfg)
    t = iq_re.shape[0]
    if first:
        favg2 = dsp.weighted_rows(cumu_weights(CUMU_AVG, t), dbs)
        fmax2 = jnp.max(dbs, axis=0)
        fmin2 = jnp.min(dbs, axis=0)
    else:
        favg2 = (dsp.decay_carry(favg, t)
                 + dsp.weighted_rows(_cont_weights(t), dbs))
        fmax2 = jnp.maximum(fmax, jnp.max(dbs, axis=0))
        fmin2 = jnp.minimum(fmin, jnp.min(dbs, axis=0))
    return (fmax2, fmin2, favg2), (rows, dbs[-1])


def stream_session(iq_re: np.ndarray, iq_im: np.ndarray, cfg: SpecConfig,
                   chunk_blocks: int = 256):
    """Process an arbitrarily long IQ recording through the waterfall chain
    in bounded device memory.

    Generator yielding ``(chunk_index, rows)`` per chunk; its ``return``
    value (``StopIteration.value``, or use :func:`run_stream_session`) is
    the final StreamResult with rows=None.
    """
    full = cfg.full_size
    t_total = iq_re.shape[0] // full
    z = jnp.zeros(cfg.fft_size, jnp.float32)
    carry = (z, z, z)
    cur = z
    for ci, start in enumerate(range(0, t_total, chunk_blocks)):
        t = min(chunk_blocks, t_total - start)
        re = jnp.asarray(
            iq_re[start * full:(start + t) * full].reshape(t, full))
        im = jnp.asarray(
            iq_im[start * full:(start + t) * full].reshape(t, full))
        carry, (rows, cur) = waterfall_stream_step(
            carry, re, im, cfg, first=(ci == 0))
        yield ci, rows
    return StreamResult(rows=None, fft_max=carry[0], fft_min=carry[1],
                        fft_avg=carry[2], fft_cur=cur)


def run_stream_session(iq_re: np.ndarray, iq_im: np.ndarray,
                       cfg: SpecConfig,
                       chunk_blocks: int = 256) -> StreamResult:
    """Convenience wrapper: run the whole recording, return final curves +
    all rows concatenated (host side)."""
    rows_all = []
    gen = stream_session(iq_re, iq_im, cfg, chunk_blocks)
    while True:
        try:
            _, rows = next(gen)
            rows_all.append(np.asarray(rows))
        except StopIteration as stop:
            final = stop.value
            break
    return StreamResult(rows=np.concatenate(rows_all, axis=0),
                        fft_max=final.fft_max, fft_min=final.fft_min,
                        fft_avg=final.fft_avg, fft_cur=final.fft_cur)
