"""Command-line interface — same spelling as the reference
(``handle_args``, kspecanal.py:778-949): case-insensitive ``KEY value``
token pairs, a bare mode token anywhere, and the FMSCAN / QUICKFULLSCAN
aliases.  The canonical invocations in hkvc-run.new.examples:1-15 are the
compatibility contract.

Extra (new) options are namespaced with a ``tpu`` prefix so every
reference invocation keeps working unchanged:
  * ``tpuSource synth|file:<path>|rtlsdr`` — IQ source selection (the
    reference chooses via a source edit, kspecanal.py:13-14)
  * ``tpuHeadless true`` — run without the matplotlib GUI
  * ``tpuMeshTime N`` / ``tpuMeshBand N`` — device-mesh axis sizes for the
    sharded pipeline (parallel/).
"""
from __future__ import annotations

import dataclasses
import signal
import sys
from typing import List, Optional, Tuple

from kspecanal_tpu.config import (MODE_ALIAS_FMSCAN, MODE_ALIAS_QUICKFULLSCAN,
                                  MODE_SCAN, MODE_ZEROSPAN, MODE_ZEROSPANPLAY,
                                  MODE_ZEROSPANSAVE, SpecConfig)
from kspecanal_tpu.utils.logging import log_info

_MODES = (MODE_ZEROSPAN, MODE_ZEROSPANSAVE, MODE_ZEROSPANPLAY, MODE_SCAN,
          MODE_ALIAS_FMSCAN, MODE_ALIAS_QUICKFULLSCAN)


def _boolean(v: str) -> bool:
    """kspecanal.py:771-775: only 'TRUE' (case-insensitive) is true."""
    return v.upper() == "TRUE"


@dataclasses.dataclass
class RunOptions:
    """Host-side options that are not part of the DSP config."""
    source: str = "synth"
    headless: bool = False
    mesh_time: int = 1
    mesh_band: int = 1
    prefetch: bool = False   # background read-ahead pipeline (io/prefetch)
    profile_dir: str = ""    # jax.profiler trace output directory
    renderer: str = "gui"    # gui | term | none
    state_file: str = ""     # checkpoint/resume .npz (io/state)
    catch_up: int = 0        # zero-span blocks per dispatch (0/1 = serial)
    render_every: str = "sweep"  # scan render cadence: sweep | band
    decimate: int = 1        # time-domain decimation preprocessor factor
    log_iter: bool = True    # per-iteration timing prints (tpuLogIter)


class CliError(ValueError):
    pass


# (upper-cased CLI key) -> (config field, converter)
_KEYMAP = {
    "CENTERFREQ": ("center_freq", float),
    "STARTFREQ": ("start_freq", float),
    "ENDFREQ": ("end_freq", float),
    "SAMPLINGRATE": ("sampling_rate", float),
    "GAIN": ("gain", float),
    "MINAMP4CLIP": ("min_amp4clip", float),
    "CURSCANNONOVERLAP": ("cur_scan_non_overlap", float),
    "CURSCANCUMUMODE": ("cur_scan_cumu_mode", lambda v: v.upper()),
    "SCANRANGENONOVERLAP": ("scan_range_non_overlap", float),
    "FFTSIZE": ("fft_size", int),
    "XRES": ("x_res", int),
    "BDATAMIN": ("b_data_min", _boolean),
    "BDATAMAX": ("b_data_max", _boolean),
    "BDATAAVG": ("b_data_avg", _boolean),
    "BDATACUR": ("b_data_cur", _boolean),
    "PLTCOMPRESS": ("plt_compress", lambda v: v.upper()),
    "WINDOW": ("window", lambda v: "WIN.{}".format(v.upper())),
    "BPLTHEATMAP": ("b_plt_heatmap", _boolean),
    "BPLTLEVELS": ("b_plt_levels", _boolean),
    "PRGLOOPCNT": ("prg_loop_cnt", int),
    "PLTHIGHSNUMMARKERS": ("plt_highs_num_markers", int),
    "PLTHIGHSDELTA4MARKING": ("plt_highs_delta4marking", float),
    "PLTHIGHSPAUSE": ("plt_highs_pause", _boolean),
    "SAVESIGLVLS": ("save_sig_lvls", str),
    "ADJSIGLVLS": ("adj_sig_lvls", str),
    "BGRID": ("b_grid", _boolean),
    "BUSEPSD": ("b_use_psd", _boolean),
    "BSCANRANGEBASEDATAISRAW": ("b_scan_range_base_data_is_raw", _boolean),
    "ZEROSPANSAVEFILE": ("zero_span_save_file", str),
    "ZEROSPANPLAYFILE": ("zero_span_play_file", str),
    # New (no reference analog): matmul precision of the DFT-by-matmul
    # path (parallel/fftshard).
    "TPUPRECISION": ("tpu_precision", lambda v: _precision_name(v)),
    # The reference's own TODO (README.rst:608-611): bypass the outer K
    # bins of each displayed curscan (Nyquist-edge leakage).
    "TPUEDGESKIPBINS": ("tpu_edge_skip_bins", int),
}


def _precision_name(v: str) -> str:
    """Validate at parse time — a bad value would otherwise only surface
    when the first matmul path is traced."""
    up = v.upper()
    if up not in ("DEFAULT", "HIGH", "HIGHEST"):
        raise CliError(f"tpuPrecision [{v}] not one of default|high|highest")
    return up

_RUNOPT_KEYMAP = {
    "TPUSOURCE": ("source", str),
    "TPUHEADLESS": ("headless", _boolean),
    "TPUMESHTIME": ("mesh_time", int),
    "TPUMESHBAND": ("mesh_band", int),
    "TPUPREFETCH": ("prefetch", _boolean),
    "TPUPROFILE": ("profile_dir", str),
    # Lowercase only the scheme: the png:<dir> form embeds a case-sensitive
    # directory path that must pass through untouched.
    "TPURENDERER": ("renderer", lambda v: (
        v[:4].lower() + v[4:] if v[:4].lower() == "png:" else v.lower())),
    # Checkpoint/resume: snapshot curves + waterfall on exit, resume on
    # start when the file matches the config (io/state.py).
    "TPUSTATEFILE": ("state_file", str),
    # Batched catch-up: K zero-span blocks per device dispatch (file/synth
    # sources; 0/1 keeps the serial one-block cadence).
    "TPUCATCHUP": ("catch_up", int),
    # Scan-mode render cadence: "sweep" (default, batched) or "band"
    # (reference behavior, kspecanal.py:670-688: redraw per retune band).
    "TPURENDEREVERY": ("render_every", lambda v: _render_every(v)),
    # Time-domain decimation preprocessor (the reference's TODO,
    # README.rst:612-622): capture at N*samplingRate, merge N adjacent
    # samples into one (+1 amplitude bit, effective band = samplingRate).
    "TPUDECIMATE": ("decimate", int),
    # Per-iteration wall-time prints (ZeroSpan:{i}:{dt} etc.).  Default
    # true matches the reference's unconditional prints
    # (kspecanal.py:462,519-522,722-724).
    "TPULOGITER": ("log_iter", _boolean),
}


def _render_every(v: str) -> str:
    lo = v.lower()
    if lo not in ("sweep", "band"):
        raise CliError(f"tpuRenderEvery [{v}] not one of sweep|band")
    return lo


def parse_args(argv: List[str]) -> Tuple[SpecConfig, RunOptions]:
    """Token-pair scan (kspecanal.py:813-911) -> finalized SpecConfig."""
    overrides = {}
    run = RunOptions()
    i = 0
    while i < len(argv):
        cur = argv[i].upper()
        if cur in _MODES:
            overrides["prg_mode"] = cur
        elif cur in _KEYMAP:
            i += 1
            if i >= len(argv):
                raise CliError(f"missing value for [{argv[i-1]}]")
            field, conv = _KEYMAP[cur]
            overrides[field] = conv(argv[i])
        elif cur in _RUNOPT_KEYMAP:
            i += 1
            if i >= len(argv):
                raise CliError(f"missing value for [{argv[i-1]}]")
            field, conv = _RUNOPT_KEYMAP[cur]
            setattr(run, field, conv(argv[i]))
        else:
            raise CliError(f"handle_args: Unknown argument [{cur}]")
        i += 1
    cfg = SpecConfig(**overrides).finalize()
    return cfg, run


def print_info(cfg: SpecConfig) -> None:
    """Effective-config echo (kspecanal.py:953-963)."""
    log_info(f" startFreq[{cfg.start_freq}] centerFreq[{cfg.center_freq}] "
             f"endFreq[{cfg.end_freq}]")
    log_info(f" samplingRate[{cfg.sampling_rate}], gain[{cfg.gain}], "
             f"bUsePSD[{cfg.b_use_psd}]")
    log_info(f" fullSize[{cfg.full_size}], fftSize[{cfg.fft_size}], "
             f"curScanCumuMode[{cfg.cur_scan_cumu_mode}], "
             f"window[{cfg.window}]")
    log_info(f" minAmp4Clip[{cfg.min_amp4clip}], "
             f"curScanNonOverlap[{cfg.cur_scan_non_overlap}], "
             f"scanRangeNonOverlap[{cfg.scan_range_non_overlap}], "
             f"bScanRangeBaseDataIsRaw[{cfg.b_scan_range_base_data_is_raw}]")
    log_info(f" prgMode [{cfg.prg_mode}], prgLoopCnt[{cfg.prg_loop_cnt}], "
             f"bPltLevels[{cfg.b_plt_levels}], "
             f"bPltHeatMap[{cfg.b_plt_heatmap}]")
    log_info(f" pltHighsNumMarkers[{cfg.plt_highs_num_markers}], "
             f"pltHighsDelta4Marking[{cfg.plt_highs_delta4marking}], "
             f"pltHighsPause[{cfg.plt_highs_pause}]")
    log_info(f" xRes [{cfg.x_res}], bGrid [{cfg.b_grid}], "
             f"pltCompress [{cfg.plt_compress}], "
             f"pltCompressHM [{cfg.plt_compress_hm}]")
    log_info(f" SaveSigLvls [{cfg.save_sig_lvls}], "
             f"AdjSigLvls [{cfg.adj_sig_lvls}]; "
             f"zeroSpanSaveFile[{cfg.zero_span_save_file}], "
             f"zeroSpanPlayFile[{cfg.zero_span_play_file}]")
    log_info(f" bDataMax [{cfg.b_data_max}], bDataMin [{cfg.b_data_min}], "
             f"bDataAvg[{cfg.b_data_avg}], bDataCur [{cfg.b_data_cur}]")


def make_source(cfg: SpecConfig, run: RunOptions):
    from kspecanal_tpu.io import sources
    if run.source == "synth":
        return sources.SynthIQSource(center_freq=cfg.center_freq,
                                     sample_rate=cfg.sampling_rate,
                                     gain=0.5, seed=None)
    if run.source == "devicesynth":
        # On-device tone synthesis: full-rate simulator mode (no SDR, no
        # host->device sample traffic) — pairs with tpuCatchUp for
        # soak/benchmark runs of the complete session pipeline.
        return sources.DeviceSynthIQSource(center_freq=cfg.center_freq,
                                           sample_rate=cfg.sampling_rate,
                                           gain=0.5)
    if run.source == "devicenoise":
        # On-device noise (no transcendentals): measures/soaks the session
        # machinery itself — the tone SIMULATOR is devicesynth.
        return sources.DeviceNoiseIQSource(center_freq=cfg.center_freq,
                                           sample_rate=cfg.sampling_rate,
                                           gain=0.5)
    if run.source.startswith("file:"):
        src, fallback = sources.make_file_source(
            run.source[5:], center_freq=cfg.center_freq,
            sample_rate=cfg.sampling_rate, gain=cfg.gain)
        if fallback is not None:
            log_info(f"native IQ stream unavailable ({fallback}); "
                     "buffered reader")
        return src
    if run.source == "rtlsdr":
        return sources.RtlSdrSource(center_freq=cfg.center_freq,
                                    sample_rate=cfg.sampling_rate,
                                    gain=cfg.gain)
    raise CliError(f"unknown tpuSource [{run.source}]")


def build_session(cfg: SpecConfig, run: RunOptions):
    """The source, renderer and mesh a run asks for, wrapped in a
    :class:`~kspecanal_tpu.session.Session` ready for ``do_run``."""
    from kspecanal_tpu import session as sess_mod

    source = None
    sweep_prefetch = False
    if cfg.prg_mode != MODE_ZEROSPANPLAY:
        source = make_source(cfg, run)
        if run.decimate > 1:
            from kspecanal_tpu.io.sources import DecimatingSource
            source = DecimatingSource(source, run.decimate)
            log_info(f"tpuDecimate: capturing at "
                     f"{cfg.sampling_rate * run.decimate:g} sps, merging "
                     f"{run.decimate} adjacent samples per output sample")
        if run.prefetch:
            if cfg.prg_mode == MODE_SCAN:
                # Per-block prefetch is useless under per-band retunes
                # (every retune flushes the queue); scan mode reads ahead
                # at whole-sweep granularity instead (SweepPrefetcher).
                sweep_prefetch = True
            elif hasattr(source, "read_device_batch"):
                # devicesynth generates ON the accelerator — a host-side
                # read-ahead wrapper would only hide that fast path.
                log_info("tpuPrefetch: ignored for on-device sources")
            else:
                from kspecanal_tpu.io.prefetch import PrefetchingSource
                source = PrefetchingSource(source, block_size=cfg.full_size)

    renderer = None
    if run.renderer == "term":
        from kspecanal_tpu.render_term import TerminalRenderer
        renderer = TerminalRenderer(cfg)
    elif run.renderer.startswith("png:"):
        # headless frame dumps: one PNG per iteration into the given dir
        from kspecanal_tpu.gui import MatplotlibRenderer
        renderer = MatplotlibRenderer(cfg, interactive=False,
                                      save_dir=run.renderer[4:])
    elif not run.headless and run.renderer == "gui":
        try:
            from kspecanal_tpu.gui import MatplotlibRenderer
            renderer = MatplotlibRenderer(cfg)
        except Exception as e:  # no display / no matplotlib backend
            log_info(f"GUI unavailable ({e}); running headless")

    mesh = None
    if run.mesh_time > 1 or run.mesh_band > 1:
        from kspecanal_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(time=run.mesh_time, band=run.mesh_band)

    return sess_mod.Session(cfg, source, renderer, mesh=mesh,
                            state_file=run.state_file,
                            catch_up=run.catch_up,
                            sweep_prefetch=sweep_prefetch,
                            render_every=run.render_every)


def main(argv: Optional[List[str]] = None) -> int:
    from kspecanal_tpu import session as sess_mod
    from kspecanal_tpu.utils.compile_cache import enable_compile_cache

    cfg, run = parse_args(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()
    from kspecanal_tpu.utils.logging import set_iter_logging
    set_iter_logging(run.log_iter)
    print_info(cfg)
    sess = build_session(cfg, run)
    source, renderer = sess.source, sess.renderer

    def _sigint(signum, stack):  # kspecanal.py:1118-1123
        log_info("sigint: quiting on user request...")
        sess.stop = True

    signal.signal(signal.SIGINT, _sigint)
    from kspecanal_tpu.utils.profiling import trace
    rc = 0
    try:
        with trace(run.profile_dir or None):
            sess_mod.do_run(sess)
    except FileNotFoundError as e:
        log_info(f"ERROR: {e}")
        rc = 1
    except Exception as e:
        import pickle
        if isinstance(e, pickle.UnpicklingError):
            log_info(f"ERROR: {cfg.zero_span_play_file} is not a "
                     f"kspecanal save stream ({e})")
            rc = 1
        else:
            raise
    finally:
        if source is not None:
            source.close()
        sess.save_baseline()
        # Interactive-GUI contract: hold the final figure until a keypress
        # (kspecanal.py:1152-1155).  Only for a live window — headless/
        # term/png runs must not block scripted use.
        if renderer is not None and getattr(renderer, "interactive", False):
            renderer.hold_until_key()
        sess.timer.log_report()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
