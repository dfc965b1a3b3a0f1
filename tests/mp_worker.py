"""Worker process for the 2-process jax.distributed test.

Usage: python mp_worker.py <coordinator_port> <process_id> <out_dir>

Each of the 2 processes owns 4 virtual CPU devices (8 global), brings up
the distributed runtime through ``parallel.mesh.init_distributed``, builds
the ('time'/'band') mesh over the GLOBAL device list, and runs one
time-sharded curscan (halo exchange + psum across processes over Gloo) and
one band-sharded scan sweep (all_gather across processes).  Results are
saved for the parent test to compare against the single-process run of the
same programs — the collectives must produce identical values whether the
8 mesh devices live in one process or span two.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# The worker pair is a CPU rehearsal of the multi-process path: it stays
# off any accelerator so it never competes with a process that holds one.
jax.config.update("jax_platforms", "cpu")

from kspecanal_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from kspecanal_tpu.parallel.mesh import init_distributed, make_mesh
    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kspecanal_tpu.config import SpecConfig, WINDOW_HANNING

    # --- time-sharded curscan: ppermute halo + psum span the processes ---
    from kspecanal_tpu.parallel.timeshard import curscan_time_sharded
    mesh = make_mesh(time=8, band=1)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256, sampling_rate=2.4e6,
                     window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                     x_res=256).finalize()
    rng = np.random.default_rng(20260820)
    re_np = rng.standard_normal(cfg.full_size).astype(np.float32)
    im_np = rng.standard_normal(cfg.full_size).astype(np.float32)
    sh = NamedSharding(mesh, P("time"))
    re = jax.make_array_from_callback((cfg.full_size,), sh,
                                      lambda idx: re_np[idx])
    im = jax.make_array_from_callback((cfg.full_size,), sh,
                                      lambda idx: im_np[idx])
    spec = curscan_time_sharded(re, im, cfg, mesh)
    spec_local = np.asarray(spec.addressable_shards[0].data)

    # Per-process throughput of the cross-process halo/psum step: the
    # scaling-overhead smoke the parent test bounds against the
    # single-process rate (VERDICT r2 item 9).
    import time
    spec.block_until_ready()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        spec = curscan_time_sharded(re, im, cfg, mesh)
    spec.block_until_ready()
    rate = iters * cfg.full_size / (time.perf_counter() - t0)

    # --- band-sharded scan sweep: all_gather spans the processes ---
    from kspecanal_tpu.models import scan as scan_mod
    from kspecanal_tpu.parallel.bandshard import sweep_step_band_sharded
    bmesh = make_mesh(time=1, band=8)
    scfg = SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=98e6,
                      fft_size=256, sampling_rate=2.4e6,
                      window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                      x_res=256).finalize()
    plan = scan_mod.make_scan_plan(scfg)
    b = plan.num_bands
    sre = rng.standard_normal((b, scfg.full_size)).astype(np.float32)
    sim = rng.standard_normal((b, scfg.full_size)).astype(np.float32)
    oks = np.ones(b, bool)
    oks[2] = False  # exercise the sentinel path across processes too
    state = scan_mod.init_state(scfg, plan)
    state = sweep_step_band_sharded(state, jnp.asarray(sre), jnp.asarray(sim),
                                    jnp.asarray(oks), scfg, plan, bmesh)
    state_np = {f: np.asarray(getattr(state, f).addressable_shards[0].data)
                for f in state._fields}

    np.savez(os.path.join(outdir, f"result_{pid}.npz"),
             spec=spec_local, rate=np.float64(rate),
             **{f"scan_{k}": v for k, v in state_np.items()})
    print(f"proc {pid}: OK rate={rate/1e6:.2f} Msamp/s", flush=True)


if __name__ == "__main__":
    main()
