"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases passes its oracle checks at tiny sizes (the card runs them at
full size)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_SCAN = ("scan", "startFreq", "88e6", "endFreq", "96e6",
              "fftSize", "64")


def test_require_gpu_raises_on_cpu():
    with pytest.raises(cs.NoGpuError):
        cs.require_gpu()


def test_main_without_gpu_exits_nonzero_and_prints_no_result(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """A directory holding only chip_smoke.py cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _check(phases, names):
    assert [p.name for p in phases] == names
    for p in phases:
        assert p.ok, p.line()
        assert p.samples > 0 and p.seconds > 0


def test_phase_waterfall_tiny():
    """200 blocks in one batch: past the ~150 blocks at which the Avg
    fold's oldest float32 weights underflow to zero."""
    _check(cs.phase_waterfall(fft_size=256, catch_up=256,
                              samples=200 * 2048),
           ["zero_span_config2"])


def test_phase_reference_defaults_tiny():
    _check(cs.phase_reference_defaults(fft_size=512, serial_iters=2,
                                       catch_up=4, samples=6 * 4096),
           ["reference_defaults_serial", "reference_defaults_catchup"])


def test_phase_file_tiny():
    phases = cs.phase_file(fft_size=256, capture_blocks=4, serial_iters=3,
                           catch_up=4, samples=10 * 2048)
    _check(phases, ["file_serial", "file_catchup", "file_prefetch"])
    assert all("native=True" in p.note for p in phases)


def test_phase_scans_tiny():
    _check(cs.phase_scans(sweeps=2, fm=SMALL_SCAN, qfs=SMALL_SCAN),
           ["fm_scan", "quick_full_scan"])


def test_phase_record_replay_tiny():
    _check(cs.phase_record_replay(fft_size=256, frames=10, catch_up=4),
           ["zero_span_save", "zero_span_play", "zero_span_play_reference"])


def test_phase_four_cards_on_virtual_devices():
    """The sharded phase on four of the suite's eight virtual devices."""
    _check(cs.phase_four_cards(fft_size=256, blocks=8, scan=SMALL_SCAN,
                               cli_iters=2),
           ["waterfall_stream_sharded_time4", "curscan_time_sharded",
            "curscan_fft_sharded", "sweep_band_sharded_band4",
            "sweep_band_sharded_2x2", "cli_zero_span_mesh_time4"])


def test_phase_line_and_tolerance():
    p = cs.Phase("x", 10, 0.5, 1e-6)
    assert p.ok and p.line().startswith("phase x: samples=10 wall_s=0.500")
    assert not cs.Phase("x", 1, 1.0, float("nan")).ok
    assert not cs.Phase("x", 1, 1.0, 2 * cs.TOL).ok
    assert np.isnan(cs.worst([1e-7, float("nan"), 2e-7]))


def test_recorder_yields_the_blocks_the_session_consumed():
    class Src:
        def read(self, n):
            return np.arange(n, dtype=np.float32), np.zeros(n, np.float32)

        def read_raw(self, n):
            return np.full(2 * n, 127, np.uint8)

    rec = cs.Recorder(Src())
    rec.read(4)
    rec.read_raw(4)
    assert not hasattr(rec, "read_device_batch")
    (r0, i0), (r1, i1) = rec.blocks()
    np.testing.assert_array_equal(r0, np.arange(4))
    assert r1.dtype == np.uint8 and np.all(cs.to_complex(r1, i1) == 0)
    assert rec.reader == "Src"
