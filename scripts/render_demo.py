"""Render a demo session to PNG (headless Agg) — visual smoke artifact:
levels plot with peak markers + waterfall heatmap, driven by the synthetic
multi-tone source (tones must land on MHz gridlines, the reference's visual
correctness check — SURVEY.md §4.1).

Usage: python scripts/render_demo.py [out.png]
"""
import sys

import matplotlib
matplotlib.use("Agg")

sys.path.insert(0, ".")

import jax  # noqa: E402

# Always pin CPU: a visual smoke render needs no accelerator, and it must
# not claim the memory of a card another process holds.
jax.config.update("jax_platforms", "cpu")

from kspecanal_tpu.cli import parse_args  # noqa: E402
from kspecanal_tpu.gui import MatplotlibRenderer  # noqa: E402
from kspecanal_tpu.io.sources import SynthIQSource  # noqa: E402
from kspecanal_tpu import session as sess_mod  # noqa: E402


def main(out_path: str = "/tmp/kspec_demo.png") -> None:
    cfg, _ = parse_args(["zeroSpan", "centerFreq", "92e6", "samplingRate",
                         "2.4e6", "fftSize", "1024", "xRes", "512",
                         "window", "hanning"])
    renderer = MatplotlibRenderer(cfg, interactive=False)
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, gain=3.0, seed=42)
    sess = sess_mod.Session(cfg, src, renderer=renderer)
    sess_mod.run_zero_span(sess, max_iters=24)
    renderer.fig.savefig(out_path, dpi=110)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/kspec_demo.png")
