"""IQ sample sources: raw-capture files, synthetic tones, live-SDR stub.

All sources speak one protocol: ``read(n) -> (re, im)`` float32 planes plus
``retune(fc, fs, gain) -> bool`` — the duck interface the DSP layer consumes.
Complex never crosses the host<->device boundary: sources emit split
float32 (or raw uint8) planes directly.

Reference equivalents:
  * raw rtl_sdr capture format (uint8 interleaved IQ, value-127 offset):
    octave/load_rtlsdr.m:8-13
  * synthetic multi-tone simulator: testfft.py:13-81
  * hardware HAL semantics (retune flush, failure -> recreate + bOk=False):
    kspecanal.py:287-347
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np

Planes = Tuple[np.ndarray, np.ndarray]

# Chunked-read unit mirroring gSdrReadUnit = 2**18 (kspecanal.py:311).
SDR_READ_UNIT = 2 ** 18


def split_u8_planes(raw: np.ndarray) -> Planes:
    """Interleaved raw u8 I/Q (last axis 2n bytes) -> UNDECODED u8 planes
    (last axis n), on the HOST: native C++ split when built, NumPy
    strided copy otherwise.  The device program decodes the planes;
    splitting host-side keeps the strided deinterleave off the device on
    every raw ship path."""
    try:
        from kspecanal_tpu.io import native_iq
        return native_iq.split_u8_iq(raw)
    except (ImportError, OSError):
        return (np.ascontiguousarray(raw[..., 0::2]),
                np.ascontiguousarray(raw[..., 1::2]))


class IQSource(Protocol):
    center_freq: float
    sample_rate: float
    gain: float

    def read(self, n: int) -> Planes: ...
    def retune(self, center_freq: float, sample_rate: float,
               gain: float) -> bool: ...
    def close(self) -> None: ...


def load_rtlsdr_capture(path: str, count: Optional[int] = None,
                        offset: int = 0) -> Planes:
    """Decode an ``rtl_sdr`` capture file into float32 IQ planes.

    Format per octave/load_rtlsdr.m: uint8 bytes, value-127 offset,
    interleaved I then Q.  ``offset``/``count`` are in complex samples.

    Uses the native C++ decoder when built (see native/iqdecode.cpp);
    falls back to vectorized NumPy.
    """
    with open(path, "rb") as f:
        f.seek(offset * 2)
        raw = np.fromfile(f, dtype=np.uint8,
                          count=-1 if count is None else count * 2)
    if len(raw) % 2:
        raw = raw[:-1]
    try:
        from kspecanal_tpu.io import native_iq
        return native_iq.decode_u8_iq(raw)
    except (ImportError, OSError):
        x = raw.astype(np.float32) - np.float32(127.0)
        return np.ascontiguousarray(x[0::2]), np.ascontiguousarray(x[1::2])


class FileIQSource:
    """Streams IQ from a raw rtl_sdr capture file, wrapping around at EOF
    so arbitrarily long sessions can replay a finite capture.

    Holds the capture as RAW bytes (2 B/sample) and decodes per read;
    :meth:`read_raw` exposes the undecoded u8 stream so the session can
    ship bytes to the device and decode in-jit
    (``parallel.stream.decode_u8_on_device``) — 4x less host->device
    traffic than float32 planes."""

    def __init__(self, path: str, center_freq: float = 92e6,
                 sample_rate: float = 2.4e6, gain: float = 19.1,
                 wrap: bool = True):
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        with open(path, "rb") as f:
            raw = np.fromfile(f, dtype=np.uint8)
        if len(raw) % 2:
            raw = raw[:-1]
        self._raw = raw
        if len(raw) == 0:
            raise ValueError(f"empty IQ capture: {path}")
        self._pos = 0            # complex-sample position
        self._wrap = wrap
        self.exhausted = False

    def _n_samples(self) -> int:
        return len(self._raw) // 2

    def read_raw(self, n: int) -> np.ndarray:
        """``2*n`` u8 interleaved IQ bytes (127-fill past EOF when
        non-wrapping, decoding to the same zeros as :meth:`read`)."""
        out = np.empty(2 * n, np.uint8)
        total = self._n_samples()
        got = 0
        while got < n:
            take = min(n - got, total - self._pos)
            out[2 * got:2 * (got + take)] = \
                self._raw[2 * self._pos:2 * (self._pos + take)]
            self._pos += take
            got += take
            if self._pos == total:
                if not self._wrap:
                    self.exhausted = True
                    out[2 * got:] = 127
                    return out
                self._pos = 0
        return out

    # Recorded data does not change under retune: a prefetch wrapper may
    # keep read-ahead blocks across retunes (io/prefetch.py).
    retune_invalidates = False

    def read(self, n: int) -> Planes:
        raw = self.read_raw(n)
        try:
            from kspecanal_tpu.io import native_iq
            return native_iq.decode_u8_iq(raw)
        except (ImportError, OSError):
            x = raw.astype(np.float32) - np.float32(127.0)
            return (np.ascontiguousarray(x[0::2]),
                    np.ascontiguousarray(x[1::2]))

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass


def make_file_source(path: str, center_freq: float, sample_rate: float,
                     gain: float):
    """The production file-source ladder (shared by cli.make_source and
    bench.py so the bench measures what the CLI runs): prefer the native
    streaming reader (C++ producer thread, O(block) memory, raw-u8 ring);
    fall back to the whole-file NumPy decode without the toolchain.
    Returns ``(source, fallback_reason_or_None)``."""
    try:
        return StreamingFileIQSource(path, center_freq=center_freq,
                                     sample_rate=sample_rate,
                                     gain=gain), None
    except (OSError, ImportError) as e:
        return FileIQSource(path, center_freq=center_freq,
                            sample_rate=sample_rate, gain=gain), str(e)


def _grid_tone_offsets(center_freq: float, sample_rate: float,
                       spacing: float) -> np.ndarray:
    """testfft.py:36-55 ``abs_freqs`` grid: one tone per integer multiple
    of ``spacing`` inside [fC - fS/2, fC + fS/2], as offsets ``fC - cur``
    (shared by the host and on-device synth sources)."""
    start = center_freq - sample_rate / 2
    end = center_freq + sample_rate / 2
    s = int(math.ceil(start / spacing) * spacing)
    e = int((end // spacing) * spacing) + 1
    return np.array([center_freq - cur for cur in range(s, e, int(spacing))])


class SynthIQSource:
    """Deterministic multi-tone simulator — the testfft.py fixture rebuilt
    as a seedable source.

    Tone placement follows testfft.py:36-55 ``abs_freqs``: one tone per
    integer MHz inside the tuned band, synthesized at offset ``fC - cur``
    with the reference's ``g*sin(2pi f t) + j*g*cos(2pi f t)`` convention
    (= j*e^{-j 2pi f t}: parameter +f lands at spectral -f), amplitude
    ``10**(gain/10)`` each, random start phase (testfft.py:63-77).
    ``seed=None`` reproduces the reference's nondeterministic start time;
    an int seed gives deterministic streams for tests.
    """

    def __init__(self, center_freq: float = 92e6, sample_rate: float = 2.4e6,
                 gain: float = 0.5, seed: Optional[int] = 0,
                 tones_hz: Optional[Sequence[float]] = None,
                 tone_spacing_hz: float = 1e6):
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self._rng = np.random.default_rng(seed)
        self._tones = tones_hz  # explicit relative offsets, or None -> grid
        self._spacing = tone_spacing_hz

    def grid_tones(self) -> np.ndarray:
        """testfft.py:36-55: a tone at every integer multiple of the grid
        spacing within [fC - fS/2, fC + fS/2], at offset fC - cur."""
        return _grid_tone_offsets(self.center_freq, self.sample_rate,
                                  self._spacing)

    def read(self, n: int) -> Planes:
        f = (np.asarray(self._tones, np.float64) if self._tones is not None
             else self.grid_tones())
        gain_mult = 10 ** (self.gain / 10)
        dur = n / self.sample_rate
        t_start = float(self._rng.random())
        t = np.linspace(t_start, t_start + dur, n)
        ang = 2 * np.pi * f[:, None] * t[None, :]
        re = gain_mult * np.sin(ang).sum(axis=0)
        im = gain_mult * np.cos(ang).sum(axis=0)
        return re.astype(np.float32), im.astype(np.float32)

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass


class DeviceSynthIQSource:
    """testfft-semantics tone simulator that synthesizes ON DEVICE
    (``tpuSource devicesynth``).

    Same tone math as :class:`SynthIQSource` (testfft.py:36-77: a tone per
    integer MHz in-band at offset ``fC - cur``, ``g*sin + j*g*cos``,
    random start phase per read) but generated as float32 planes directly
    in device memory under jit.  The host never touches sample data, so the
    session pipeline runs at device rate — the simulator mode for
    benchmarking and soak-testing the full CLI path without an SDR and
    without the host->device transfer bottleneck.

    :meth:`read_device_batch` returns ``(K, n)`` jax arrays for the
    batched catch-up loop; :meth:`read` adapts to the host protocol.
    """

    def __init__(self, center_freq: float = 92e6, sample_rate: float = 2.4e6,
                 gain: float = 0.5, seed: Optional[int] = 0,
                 tone_spacing_hz: float = 1e6):
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self._spacing = tone_spacing_hz
        import jax
        self._key = jax.random.key(0 if seed is None else seed)

    def _tones(self) -> Tuple[float, ...]:
        return tuple(_grid_tone_offsets(self.center_freq, self.sample_rate,
                                        self._spacing))

    def read_device_batch(self, k: int, n: int):
        import jax
        self._key, sub = jax.random.split(self._key)
        fn = _build_device_synth(self._tones(), float(self.sample_rate),
                                 float(self.gain), k, n)
        return fn(sub)

    def read(self, n: int) -> Planes:
        re, im = self.read_device_batch(1, n)
        return (np.asarray(re[0], np.float32), np.asarray(im[0], np.float32))

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass


def _sincos_from_phase_u32(phase):
    """(sin, cos) of ``2*pi * phase / 2**32`` directly from the uint32
    cycle-fraction phase — the synth hot loop's replacement for XLA's
    ``sin``/``cos``.

    XLA's transcendentals spend most of their ops on argument range
    reduction, but the fixed-point phase makes reduction EXACT integer
    arithmetic: the top two bits select the nearest quadrant and the
    wrapped remainder bitcasts to a signed offset in [-pi/4, pi/4],
    where short Taylor polynomials reach ~3e-7 (sin, through x^9) /
    ~2.5e-8 (cos, through x^8) absolute error — beneath the tone-purity
    floor the integer phase accumulator exists to protect.  Its speed
    against ``jnp.sin``/``jnp.cos`` on the H100 is in PERF.md.
    """
    import jax
    import jax.numpy as jnp
    two_pi_over_2_32 = float(2.0 * np.pi / 2.0**32)
    q = (phase + jnp.uint32(0x20000000)) >> jnp.uint32(30)  # nearest quad
    delta = phase - (q << jnp.uint32(30))                   # wraps exactly
    x = jax.lax.bitcast_convert_type(
        delta, jnp.int32).astype(jnp.float32) * two_pi_over_2_32
    x2 = x * x
    # sin(x) = x(1 - x^2/6 + x^4/120 - x^6/5040 + x^8/362880)
    s = x * (1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0 + x2 * (
        -1.0 / 5040.0 + x2 * (1.0 / 362880.0)))))
    # cos(x) = 1 - x^2/2 + x^4/24 - x^6/720 + x^8/40320
    c = 1.0 + x2 * (-0.5 + x2 * (1.0 / 24.0 + x2 * (
        -1.0 / 720.0 + x2 * (1.0 / 40320.0))))
    odd = (q & jnp.uint32(1)).astype(bool)
    s_sign = jnp.where((q & jnp.uint32(2)).astype(bool), -1.0, 1.0)
    c_sign = jnp.where(((q + jnp.uint32(1)) & jnp.uint32(2)).astype(bool),
                       -1.0, 1.0)
    sin_out = jnp.where(odd, c, s) * s_sign
    cos_out = jnp.where(odd, s, c) * c_sign
    return sin_out, cos_out


@functools.lru_cache(maxsize=32)
def _build_device_synth(tones: Tuple[float, ...], sample_rate: float,
                        gain: float, k: int, n: int):
    """Jitted (K, n) tone-bank synthesis (cached per static geometry).

    Phase is tracked as a fixed-point fraction-of-a-cycle in uint32 (2^-32
    cycle units) and advanced by integer multiply, wrapping mod 2^32 — a
    float32 phase ``2*pi*f*t`` reaches ~1e7 rad where the f32 ulp is ~1
    rad, which buries the tones in quantization noise; the integer
    accumulator keeps phase exact (frequency rounding 2^-32
    cycles/sample ~= 0.3 mHz) at any duration."""
    import jax
    import jax.numpy as jnp
    f = np.asarray(tones, np.float64)
    gain_mult = float(10 ** (gain / 10))
    # Host SynthIQSource time base: np.linspace(t0, t0+dur, n) — step
    # dur/(n-1) seconds — so mirror its cycles/sample exactly.
    step_s = (n / sample_rate) / max(n - 1, 1)
    p_int = jnp.asarray(np.round(((f * step_s) % 1.0) * 2.0**32
                                 ).astype(np.int64) % 2**32, jnp.uint32)
    f_int = jnp.asarray(np.round(f).astype(np.int64) % 2**32, jnp.uint32)

    def one(key):
        # t0 ~ U[0,1) s in 2^-32 units; start phase frac(f*t0) per tone
        t0_int = jax.random.bits(key, (), jnp.uint32)
        phase0 = f_int * t0_int                       # wraps mod 2^32
        i = jnp.arange(n, dtype=jnp.uint32)
        phase = phase0[:, None] + p_int[:, None] * i[None, :]
        # integer-exact quadrant reduction + short polynomials — see
        # _sincos_from_phase_u32 (the XLA sin/cos pair was the session
        # bottleneck at large catch-up batches)
        s, c = _sincos_from_phase_u32(phase)
        re = gain_mult * s.sum(axis=0)
        im = gain_mult * c.sum(axis=0)
        return re, im

    def batch(key):
        keys = jax.random.split(key, k)
        return jax.vmap(one)(keys)

    return jax.jit(batch)


class DeviceNoiseIQSource:
    """On-device uniform-noise source (``tpuSource devicenoise``).

    Emits RAW uint8 ADC-style planes (uniform [0, 255], value-127 offset
    — exactly the rtl_sdr capture format, octave/load_rtlsdr.m) straight
    from device random bits: no transcendentals and only 1 B/sample of
    generator output, so acquisition is negligible next to any DSP.
    This is the source for measuring/soaking the SESSION MACHINERY
    (drivers, batched folds, dispatch) — the testfft-semantics tone
    SIMULATOR is :class:`DeviceSynthIQSource`, whose ~6
    transcendentals/sample tone bank can bind the loop once everything
    else runs at kernel rate.

    The batched session driver feeds the u8 planes to
    ``curscan_auto_batched`` unchanged (decoded on the device); the host-side
    ``read()`` protocol decodes to float32 planes.  ``gain`` is carried
    for the source protocol but the amplitude is the full 8-bit range.
    """

    def __init__(self, center_freq: float = 92e6, sample_rate: float = 2.4e6,
                 gain: float = 0.5, seed: Optional[int] = 0,
                 reuse: bool = False):
        """``reuse=True``: generate each (k, n) batch ONCE and return the
        same device buffer on every subsequent read — zero acquisition
        cost, exactly the methodology of the kernel benches (which time
        repeated dispatches over one staged buffer), so a session run
        over a reusing source isolates the cost of the session machinery
        itself.  Default False = fresh noise per read (soak mode)."""
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self.reuse = bool(reuse)
        self._cache: dict = {}
        import jax
        self._key = jax.random.key(0 if seed is None else seed)

    def read_device_batch(self, k: int, n: int):
        if self.reuse and (k, n) in self._cache:
            return self._cache[(k, n)]
        import jax
        self._key, sub = jax.random.split(self._key)
        out = _build_device_noise(k, n)(sub)
        if self.reuse:
            self._cache[(k, n)] = out
        return out

    def read(self, n: int) -> Planes:
        re, im = self.read_device_batch(1, n)
        return (np.asarray(re[0]).astype(np.float32) - np.float32(127.0),
                np.asarray(im[0]).astype(np.float32) - np.float32(127.0))

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass


@functools.lru_cache(maxsize=32)
def _build_device_noise(k: int, n: int):
    """Jitted (K, n) uint8 noise planes: each random u32 bitcasts into
    four uniform bytes — the cheapest correct on-device sample stream
    (1 B/sample written; the DSP decodes it like any raw capture)."""
    import jax
    import jax.numpy as jnp
    assert n % 4 == 0, n

    def batch(key):
        bits = jax.random.bits(key, (2, k, n // 4), jnp.uint32)
        u8 = jax.lax.bitcast_convert_type(bits, jnp.uint8).reshape(2, k, n)
        return u8[0], u8[1]

    return jax.jit(batch)


class DecimatingSource:
    """Time-domain decimation preprocessor — the reference's own TODO
    (README.rst:612-622): treat the capture as oversampled, merge each
    group of ``factor`` adjacent samples into one, "gaining 1 additional
    bit resolution wrt samples, while reducing the effective freq band".

    The wrapper keeps the CONFIG in post-decimation terms: ``retune``
    drives the inner source at ``factor * samplingRate`` and ``read(n)``
    consumes ``factor * n`` raw samples, so frequency axes, fullSize
    derivation and scan band stepping all see the effective (decimated)
    rate unchanged.  Each group is summed and divided by ``factor/2``,
    generalizing the TODO's "decimate 4 adjacent samples into 1 and then
    divide by 2" (net one extra amplitude bit).
    """

    def __init__(self, inner: IQSource, factor: int):
        if factor < 2:
            raise ValueError(f"decimation factor must be >= 2: {factor}")
        self._inner = inner
        self._f = int(factor)

    @property
    def center_freq(self):
        return self._inner.center_freq

    @property
    def sample_rate(self):
        return self._inner.sample_rate / self._f

    @property
    def gain(self):
        return self._inner.gain

    @property
    def exhausted(self):
        return bool(getattr(self._inner, "exhausted", False))

    def read(self, n: int) -> Planes:
        re, im = self._inner.read(n * self._f)
        scale = np.float32(2.0 / self._f)     # sum / (factor/2)
        return (
            (re.reshape(n, self._f).sum(axis=1) * scale).astype(np.float32),
            (im.reshape(n, self._f).sum(axis=1) * scale).astype(np.float32))

    def retune(self, center_freq, sample_rate, gain) -> bool:
        return self._inner.retune(center_freq, sample_rate * self._f, gain)

    def close(self):
        self._inner.close()


class FlakySource:
    """Fault-injection wrapper: fails every k-th retune, mirroring the
    reference's recovery contract where ``sdr_setup`` returns ``bOk=False``
    and the scan substitutes a sentinel band (kspecanal.py:296-308,635-639).
    """

    def __init__(self, inner: IQSource, fail_every: int = 3):
        self._inner = inner
        self._fail_every = fail_every
        self._n = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def read(self, n: int) -> Planes:
        return self._inner.read(n)

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self._n += 1
        if self._fail_every and self._n % self._fail_every == 0:
            return False
        return self._inner.retune(center_freq, sample_rate, gain)

    def close(self):
        self._inner.close()


class RtlSdrSource:
    """Live hardware adapter (optional): wraps pyrtlsdr with the reference's
    HAL semantics — settle-flush of 16*1024 samples after retune
    (kspecanal.py:301), chunked reads of SDR_READ_UNIT with pow2 rounding of
    the tail (kspecanal.py:312-347), and failure -> recreate + False
    (kspecanal.py:296-308).  Gated: importing rtlsdr is deferred so the
    framework runs without the dependency.
    """

    def __init__(self, center_freq: float = 92e6, sample_rate: float = 2.4e6,
                 gain: float = 19.1):
        import rtlsdr  # deferred: optional hardware dependency
        self._rtlsdr = rtlsdr
        self._sdr = rtlsdr.RtlSdr()
        # Device-caps echo on open (sdr_info, kspecanal.py:281-284).
        print("INFO:Sdr:SupportedGains:", self._sdr.valid_gains_db)
        print("INFO:Sdr:Bandwidth:", self._sdr.bandwidth)
        print("INFO:Sdr:freqCorrection:", self._sdr.freq_correction)
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self.retune(center_freq, sample_rate, gain)

    def retune(self, center_freq, sample_rate, gain) -> bool:
        try:
            self._sdr.sample_rate = sample_rate
            self._sdr.center_freq = center_freq
            self._sdr.gain = gain
            self._sdr.read_samples(16 * 1024)  # settle flush
            ok = True
        except Exception:
            self._sdr.close()
            self._sdr = self._rtlsdr.RtlSdr()
            ok = False
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return ok

    def read(self, n: int) -> Planes:
        out = np.empty(n, np.complex128)
        pos = 0
        while pos < n:
            want = min(SDR_READ_UNIT, n - pos)
            rd = 2 ** int(math.ceil(math.log2(want)))
            out[pos:pos + want] = self._sdr.read_samples(rd)[:want]
            pos += want
        return (out.real.astype(np.float32), out.imag.astype(np.float32))

    def close(self):
        self._sdr.close()


class StreamingFileIQSource:
    """Raw-capture source backed by the NATIVE streaming reader
    (native/iqstream.cpp): a C++ producer thread reads + decodes fixed-size
    blocks into a ring ahead of the consumer, so file IO and uint8->f32
    decode overlap device compute and host memory stays O(block * depth)
    however long the capture is (``FileIQSource`` decodes the whole file
    up front).  Wraps at EOF.  Falls back to FileIQSource when the native
    toolchain is unavailable (see cli.make_source).
    """

    def __init__(self, path: str, center_freq: float = 92e6,
                 sample_rate: float = 2.4e6, gain: float = 19.1,
                 depth: int = 4):
        from kspecanal_tpu.io.native_iq import IqStream  # may raise OSError
        self._IqStream = IqStream
        self._path = path
        self._depth = depth
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self._stream = None
        self._block = 0
        self._raw = False
        self._consumed = 0       # complex samples popped by the consumer
        # open eagerly with a placeholder block to validate the path
        probe = IqStream(path, 1024, depth=1)
        if probe.file_samples == 0:
            probe.close()
            raise ValueError(f"empty IQ capture: {path}")
        self._file_samples = probe.file_samples
        probe.close()

    # Recorded data does not change under retune (see FileIQSource).
    retune_invalidates = False

    def _ensure_stream(self, n: int, raw: bool):
        if self._stream is None or self._block != n or self._raw != raw:
            if self._stream is not None:
                self._stream.close()
            # Reopen AT the consumer's logical position: the producer
            # thread read ahead of what was popped, so a plain reopen
            # would rewind to wherever its file cursor happened to be (or
            # worse, to 0) and replay data on a block-size or raw/decoded
            # mode switch.
            self._stream = self._IqStream(
                self._path, n, depth=self._depth, raw=raw,
                start_sample=self._consumed % self._file_samples)
            self._block = n
            self._raw = raw
        return self._stream

    def read(self, n: int) -> Planes:
        out = self._ensure_stream(n, raw=False).read_block()
        self._consumed += n
        return out

    def read_raw(self, n: int) -> np.ndarray:
        """Next block as RAW interleaved uint8 (2n bytes), read ahead by
        the native producer thread — the session's u8 ship path (in-jit
        decode, 2 B/sample over the host link) keeps native read-ahead."""
        out = self._ensure_stream(n, raw=True).read_block_raw()
        self._consumed += n
        return out

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        if self._stream is not None:
            self._stream.close()
            self._stream = None
