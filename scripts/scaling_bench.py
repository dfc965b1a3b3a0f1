"""Multi-device scaling measurement (BASELINE.md: >=80% samples/s scaling
at 1 chip / 1 host / N hosts).

Runs the sharded streaming waterfall over 1..num_devices shards of the
'time' mesh axis.  Two methodologies, picked with --mode:

  weak       fixed work PER SHARD (blocks_per_dev each).  Reports the
             per-shard rate vs the 1-shard rate.  NOTE on the virtual
             CPU mesh the shards share the same physical cores, so
             aggregate capacity does NOT grow with shards and the
             per-shard rate is EXPECTED to fall as ~1/s — the honest
             signal here is how the TOTAL rate holds up.
  fixedwork  fixed TOTAL work regardless of shard count.  With constant
             work on constant physical capacity, rate(s)/rate(1) isolates
             the partitioning overhead itself (halo exchange, psums,
             smaller fused regions) — the one scaling quantity this
             single-chip environment CAN measure meaningfully.

On real devices (four GPUs on one host) `weak` measures scaling directly,
since capacity grows with shards there.

Usage: [JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8] \
       python scripts/scaling_bench.py [fft_size] [blocks_per_device] \
              [--mode=weak|fixedwork] [--json=out.json]
"""
import sys
import time

sys.path.insert(0, ".")

import jax

import jax.numpy as jnp


def _rate(cfg, mesh, t_blocks, iters=5):
    from kspecanal_tpu.parallel.stream import waterfall_stream_sharded

    mk = jax.jit(lambda k: jax.random.normal(
        k, (2, t_blocks, cfg.full_size), jnp.float32))
    planes = mk(jax.random.key(0))
    re, im = planes[0], planes[1]
    res = waterfall_stream_sharded(re, im, cfg, mesh)
    _ = float(res.fft_avg[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        res = waterfall_stream_sharded(re, im, cfg, mesh)
    _ = float(res.fft_avg[0])
    dt = (time.perf_counter() - t0) / iters
    return t_blocks * cfg.full_size / dt


def main(fft_size=2048, blocks_per_dev=64, json_out="", mode="weak"):
    from kspecanal_tpu.config import SpecConfig, WINDOW_KAISER
    from kspecanal_tpu.parallel.mesh import make_mesh

    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft_size,
                     sampling_rate=2.4e6, window=WINDOW_KAISER,
                     cur_scan_non_overlap=0.5, x_res=512).finalize()
    n_dev = len(jax.devices())
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
    max_s = sizes[-1]
    rows = []
    base = None
    for s in sizes:
        mesh = make_mesh(time=s)
        # fixedwork: constant total blocks (divisible by every shard
        # count); weak: constant blocks per shard.
        t = blocks_per_dev * (max_s if mode == "fixedwork" else s)
        rate = _rate(cfg, mesh, t)
        if base is None:
            base = rate
        if mode == "fixedwork":
            row = {"shards": s, "samples_per_s": rate,
                   "vs_1shard": rate / base}
            print(f"shards={s:3d}  total {rate/1e9:7.2f} Gsamp/s  "
                  f"vs-1-shard={row['vs_1shard']*100:5.1f}%", flush=True)
        else:
            row = {"shards": s, "total_samples_per_s": rate,
                   "per_shard_samples_per_s": rate / s,
                   "per_shard_vs_1shard": (rate / s) / base}
            print(f"shards={s:3d}  total {rate/1e9:7.2f} Gsamp/s  "
                  f"per-shard {rate/s/1e9:7.2f}  "
                  f"per-shard-vs-1shard="
                  f"{row['per_shard_vs_1shard']*100:5.1f}%", flush=True)
        rows.append(row)
    if jax.default_backend() == "cpu":
        print("NOTE: virtual CPU devices share the SAME physical cores — "
              "aggregate capacity does not grow with shards, so weak-"
              "scaling per-shard rates fall as ~1/s by construction. "
              "fixedwork mode (constant total work) isolates the "
              "partitioning overhead instead. Real scaling needs real "
              "devices.", flush=True)
    if json_out:
        import json
        with open(json_out, "w") as f:
            json.dump({"backend": jax.default_backend(), "mode": mode,
                       "rows": rows}, f)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    jout = next((a.split("=", 1)[1] for a in sys.argv[1:]
                 if a.startswith("--json=")), "")
    md = next((a.split("=", 1)[1] for a in sys.argv[1:]
               if a.startswith("--mode=")), "weak")
    fft = int(args[0]) if len(args) > 0 else 2048
    bpd = int(args[1]) if len(args) > 1 else 64
    main(fft, bpd, jout, md)
