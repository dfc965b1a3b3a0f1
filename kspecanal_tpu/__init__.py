"""kspecanal_tpu — accelerator-native spectrum/waterfall analysis framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
RTL-SDR spectrum analyzer ``hanishkvc/prgs-sdr-kspecanal`` (see SURVEY.md):
overlapped sliding-window FFT spectra, max/min/avg/cur signal-level curves,
waterfall heatmap, zero-span and stepped multi-band scan modes with
overlap-averaged stitching, session record/replay, and signal-level
baselines — expressed as batched on-device kernels over sharded arrays
instead of serial NumPy loops.
"""

from kspecanal_tpu.config import SpecConfig  # noqa: F401

__version__ = "0.1.0"
