"""Static per-step collective-byte accounting for the sharded paths
(docs/SCALING.md).

Everything here is computable WITHOUT hardware: shapes come from the
config/plan, collective sizes from the program structure
(parallel/{timeshard,stream,bandshard,fftshard}.py call sites).  Run:

    python scripts/collective_bytes.py [n_shards]

and paste the table into docs/SCALING.md when shapes change.
"""
import sys

sys.path.insert(0, ".")

from kspecanal_tpu.config import SpecConfig, WINDOW_HANNING, WINDOW_KAISER


def fmt(b):
    if b >= 1 << 20:
        return f"{b / (1 << 20):.1f} MB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.1f} KB"
    return f"{b} B"


def rows(n_shards: int):
    out = []
    # BASELINE configs (BASELINE.md)
    cfgs = [
        ("1 zeroSpanPlay fft256", SpecConfig(
            prg_mode="ZEROSPAN", fft_size=256, sampling_rate=2.4e6,
            window=WINDOW_HANNING, cur_scan_non_overlap=0.5).finalize()),
        ("2 waterfall fft2048", SpecConfig(
            prg_mode="ZEROSPAN", fft_size=2048, sampling_rate=2.4e6,
            window=WINDOW_KAISER, cur_scan_non_overlap=0.5).finalize()),
        ("3 fmScan fft2048", SpecConfig(
            prg_mode="SCAN", start_freq=88e6, end_freq=108e6,
            sampling_rate=2.4e6, fft_size=2048, window=WINDOW_KAISER,
            cur_scan_non_overlap=0.5).finalize()),
        ("4 quickFullScan fft64", SpecConfig(
            prg_mode="SCAN", start_freq=30e6, end_freq=1.5e9,
            sampling_rate=2.4e6, fft_size=64,
            cur_scan_non_overlap=0.5).finalize()),
        ("5 deep fft16384 ovl90", SpecConfig(
            prg_mode="ZEROSPAN", fft_size=16384, sampling_rate=2.4e6,
            window=WINDOW_KAISER, cur_scan_non_overlap=0.1).finalize()),
    ]
    for name, cfg in cfgs:
        f = cfg.fft_size
        hop = (cfg.window_starts[1] - cfg.window_starts[0]
               if len(cfg.window_starts) > 1 else f)
        halo = (f - hop) * 2 * 4          # 2 planes f32 to one neighbor
        # DP stream: per-step psums = avg partial + cur one-hot (+ max/min
        # when enabled) over (fft,) f32, each psum moving ~2x the vector
        # per device on a bidirectional ring reduce.
        dp = 4 * f * 4
        # TP bins: one psum PAIR per window over the (n1, lanes) grid
        from kspecanal_tpu.ops.mxu_fft import _factorize
        n1, n2 = _factorize(f)
        tp = cfg.num_windows * 2 * n1 * n2 * 4
        row = [name, fmt(halo), fmt(dp), fmt(tp)]
        if cfg.prg_mode == "SCAN":
            from kspecanal_tpu.models.scan import make_scan_plan
            plan = make_scan_plan(cfg)
            b_pad = -(-plan.num_bands // n_shards) * n_shards
            ep = b_pad * f * 4            # all_gather of padded band spectra
            row.append(f"{fmt(ep)} ({plan.num_bands} bands)")
        else:
            row.append("-")
        out.append(row)
    return out


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    print(f"| BASELINE config | SP halo / step | DP psum / step | "
          f"TP psum / step | EP all_gather / sweep ({n} shards) |")
    print("|---|---|---|---|---|")
    for r in rows(n):
        print("| " + " | ".join(r) + " |")


if __name__ == "__main__":
    main()
