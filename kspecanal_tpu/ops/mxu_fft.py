"""Matmul-based FFT (two-factor Cooley-Tukey / Bailey 4-step).

Decompose N = N1*N2 and express the DFT as two batched matmuls against
precomputed DFT matrices plus a twiddle multiply:

    n = n1*N2 + n2,  k = k1 + N1*k2
    A[n1, n2] = x[n1*N2 + n2]
    B[k1, n2] = sum_n1 F1[k1, n1] * A[n1, n2]          (matmul over N1)
    C[k1, n2] = B[k1, n2] * T[k1, n2],  T = W_N^(k1*n2) (twiddle)
    X[k1 + N1*k2] = sum_n2 C[k1, n2] * F2[k2, n2]      (matmul over N2)

Cost: 8*N*(N1+N2) real FLOPs per transform vs ~5*N*log2(N) for a radix-2
FFT.  The single-device hot path uses XLA's FFT; this form exists for the
bin-sharded transform (parallel/fftshard.py), whose only communication is
the reduction over the N2 contraction, and for the byte accounting in
scripts/collective_bytes.py.

Complex arithmetic is carried as split float32 planes.  Matmuls take an
explicit ``precision``: HIGHEST keeps full float32 products (~1e-6
relative error vs the float64 oracle, tests/test_dispatch.py).

Factor choice: N1, N2 as close to sqrt(N) as possible (N1 >= N2).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST

_PRECISIONS = {
    "DEFAULT": jax.lax.Precision.DEFAULT,
    "HIGH": jax.lax.Precision.HIGH,
    "HIGHEST": jax.lax.Precision.HIGHEST,
}


def matmul_precision(name: str) -> jax.lax.Precision:
    """Map a SpecConfig.tpu_precision string to a lax.Precision.  On the
    GPU, HIGHEST keeps float32 products; HIGH and DEFAULT let XLA feed
    the tensor cores reduced-precision inputs (each rung's measured
    error is in PERF.md)."""
    try:
        return _PRECISIONS[name.upper()]
    except KeyError:
        raise ValueError(f"unknown tpuPrecision {name!r} "
                         f"(one of {sorted(_PRECISIONS)})") from None


@functools.lru_cache(maxsize=64)
def _factorize(n: int) -> Tuple[int, int]:
    """Split n = n1*n2 with n1 >= n2, both as close to sqrt(n) as we can."""
    best = (n, 1)
    r = int(np.sqrt(n))
    for n2 in range(r, 0, -1):
        if n % n2 == 0:
            best = (n // n2, n2)
            break
    return best


@functools.lru_cache(maxsize=64)
def _dft_tables(n: int):
    """(F1re, F1im, F2re, F2im, Tre, Tim) float32 tables for the
    :func:`_factorize` split of n."""
    n1, n2 = _factorize(n)
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    f1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1)          # (n1, n1)
    f2 = np.exp(-2j * np.pi * np.outer(k2, k2) / n2)          # (n2, n2)
    tw = np.exp(-2j * np.pi * np.outer(k1, k2) / n)           # (n1, n2)
    return tuple(np.asarray(a, np.float32) for a in (
        f1.real, f1.imag, f2.real, f2.imag, tw.real, tw.imag))


def fft_mxu(re: jax.Array, im: jax.Array,
            precision: jax.lax.Precision = _HIGHEST,
            ) -> Tuple[jax.Array, jax.Array]:
    """Batched complex DFT of split planes: (..., N) -> (..., N).

    Equivalent to ``jnp.fft.fft(re + 1j*im, axis=-1)`` split into planes,
    but lowered to matmuls.  N must be factorizable (any non-prime).
    """
    n = re.shape[-1]
    n1, n2 = _factorize(n)
    if n2 == 1:  # prime length: fall back to XLA's FFT
        spec = jnp.fft.fft(re + 1j * im, axis=-1)
        return jnp.real(spec), jnp.imag(spec)
    f1r, f1i, f2r, f2i, twr, twi = (jnp.asarray(t) for t in _dft_tables(n))
    batch = re.shape[:-1]
    ar = re.reshape(batch + (n1, n2))
    ai = im.reshape(batch + (n1, n2))

    # B = F1 @ A  (contract n1; batch dims ride along)
    def mm_f1(x):
        return jnp.einsum("kn,...nm->...km", f1r, x, precision=precision), \
               jnp.einsum("kn,...nm->...km", f1i, x, precision=precision)

    # B = (F1r + iF1i)(Ar + iAi) = (F1r@Ar - F1i@Ai) + i(F1r@Ai + F1i@Ar)
    brr, bri = mm_f1(ar)   # F1r@Ar, F1i@Ar
    bir, bii = mm_f1(ai)   # F1r@Ai, F1i@Ai
    br = brr - bii
    bi = bir + bri

    # C = B * T (elementwise twiddle)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr

    # D[k2, k1] = sum_n2 C[k1, n2] F2[k2, n2]
    def mm_f2(x):
        return jnp.einsum("...km,lm->...lk", x, f2r, precision=precision), \
               jnp.einsum("...km,lm->...lk", x, f2i, precision=precision)

    drr, dri = mm_f2(cr)
    dir_, dii = mm_f2(ci)
    dr = drr - dii
    di = dir_ + dri
    # X[k1 + N1*k2] = D[k2, k1]: row-major flatten of (n2, n1)
    return (dr.reshape(batch + (n,)), di.reshape(batch + (n,)))

