#!/usr/bin/env python
"""Multi-host smoke test: distributed multi-session GN across real processes.

SURVEY.md §5.8 / §2.4 mandate a multi-host Schur reduction over
`jax.distributed`. This script proves the path end to end with *real*
process boundaries (gloo collectives between processes — a CPU multi-process
test of the collective path):

  - N processes each expose K virtual CPU devices
    (XLA_FLAGS=--xla_force_host_platform_device_count=K)
  - `jax.distributed.initialize` forms the global runtime
  - a global ('sessions','edges') mesh spans all N*K devices
  - `multisession_optimize` runs sharded GN; its psum crosses processes
  - every process verifies its result against a local single-device
    `gn.optimize` of the same sessions (allclose, f32)

On GPUs the same path runs one process per card: several JAX processes
on one card fail for want of memory, so K virtual devices per process is
a CPU-only arrangement. Locally:

  python deploy/multihost_smoke.py            # spawns itself twice, asserts
  python deploy/multihost_smoke.py --proc 0 & # or run the ranks by hand
  python deploy/multihost_smoke.py --proc 1
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# Process-group geometry comes from the environment so the launcher can run
# a 2/4/8 sweep; each group uses its own coordinator port.
N_PROCS = int(os.environ.get("TPUSLAM_SMOKE_PROCS", "2"))
DEV_PER_PROC = int(os.environ.get("TPUSLAM_SMOKE_DEVS", "2"))
COORD = "127.0.0.1:" + os.environ.get("TPUSLAM_SMOKE_PORT", "9923")


def worker(proc_id: int) -> int:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=COORD,
                               num_processes=N_PROCS, process_id=proc_id)
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tpuslam.backend import gauss_newton as gn
    from tpuslam.backend.graph import GraphCapacity
    from tpuslam.parallel import (make_slam_mesh, multisession_optimize,
                                  stack_graphs)
    from bench_scaling import _build_session

    n_global = N_PROCS * DEV_PER_PROC
    assert jax.device_count() == n_global, jax.device_count()

    cap = GraphCapacity(max_poses=64, max_landmarks=32, max_obs=512)
    cfg = gn.GNConfig(iterations=3)
    # deterministic same sessions on every process
    graphs = [_build_session(cap, s) for s in range(n_global)]
    stacked = stack_graphs(graphs)

    # sessions axis spans all processes; this process contributes its local
    # slice of the global array
    mesh = make_slam_mesh(n_sessions=n_global, n_edge_shards=1)
    local = jax.tree.map(
        lambda x: np.asarray(x)[proc_id * DEV_PER_PROC:
                                (proc_id + 1) * DEV_PER_PROC], stacked)
    gstacked = jax.tree.map(
        lambda x: multihost_utils.host_local_array_to_global_array(
            x, mesh, P("sessions")), local)

    out = multisession_optimize(gstacked, cfg, mesh)
    got = multihost_utils.process_allgather(out.poses, tiled=True)

    # local single-device oracle
    want = np.stack([np.asarray(gn.optimize(g, cfg).poses) for g in graphs])
    err = float(np.max(np.abs(got - want)))
    ok = bool(np.allclose(got, want, atol=1e-4))

    # ---- fleet tier across the same process boundary: whole blocked SLAM
    # passes (mapping -> closure -> localization) sharded over 'sessions'
    import jax.numpy as jnp
    from tpuslam.frontend.blocked import blocked_core_batched
    from tpuslam.parallel.batch import initial_states
    from tpuslam.parallel.fleet import run_fleet_blocked
    from tpuslam.runtime.config import SlamConfig

    B, T, N = 4, 8, 8
    scfg = SlamConfig(capacity=GraphCapacity(max_poses=16, max_landmarks=16,
                                             max_obs=B * N + 8),
                      max_obs_per_frame=N)
    rngf = np.random.default_rng(7)
    obs = np.zeros((n_global, T, N, 4), np.float32)
    obs[:, :, 0] = np.asarray([10.0, 0.0, 5.0, 1.0])
    obs[:, :, 0, 0] += rngf.normal(0, 0.2, (n_global, T)).astype(np.float32)
    valid = np.zeros((n_global, T, N), bool)
    valid[:, :, 0] = True
    pth = np.stack([np.arange(T, dtype=np.float32), np.zeros(T),
                    np.zeros(T)], -1)
    poses = np.broadcast_to(pth, (n_global, T, 3)).copy()

    fleet_local = (obs[proc_id * DEV_PER_PROC:(proc_id + 1) * DEV_PER_PROC],
                   valid[proc_id * DEV_PER_PROC:(proc_id + 1) * DEV_PER_PROC],
                   poses[proc_id * DEV_PER_PROC:(proc_id + 1) * DEV_PER_PROC])
    st_local = initial_states(scfg.capacity, DEV_PER_PROC)
    g_in = jax.tree.map(
        lambda x: multihost_utils.host_local_array_to_global_array(
            np.asarray(x), mesh, P("sessions")),
        (st_local, *fleet_local))
    fstates, fouts, fdone = run_fleet_blocked(g_in[0], g_in[1], g_in[2],
                                              g_in[3], scfg, mesh, block=B)
    fposes = multihost_utils.process_allgather(fstates.graph.poses,
                                               tiled=True)
    fdone_all = multihost_utils.process_allgather(fdone, tiled=True)
    # unsharded local oracle over all sessions
    ref_states, _, _ = blocked_core_batched(
        initial_states(scfg.capacity, n_global), jnp.asarray(obs),
        jnp.asarray(valid), jnp.asarray(poses), scfg, B)
    want_f = np.asarray(ref_states.graph.poses)
    fleet_ok = bool(np.allclose(fposes, want_f, atol=1e-4)) \
        and bool(np.all(np.asarray(fdone_all) == T))

    print(json.dumps({"proc": proc_id, "devices": n_global,
                      "max_abs_err_vs_single_device": err, "ok": ok,
                      "fleet_blocked_ok": fleet_ok}),
          flush=True)
    jax.distributed.shutdown()
    return 0 if (ok and fleet_ok) else 1


def _spawn_group(n_procs: int, port: int):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "TPUSLAM_SMOKE_PROCS": str(n_procs),
           "TPUSLAM_SMOKE_PORT": str(port)}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--proc", str(i)],
        env=env) for i in range(n_procs)]


def run_group(n_procs: int, port: int, timeout: int = 600) -> dict:
    procs = _spawn_group(n_procs, port)
    rcs = [p.wait(timeout=timeout) for p in procs]
    return {"procs": n_procs, "return_codes": rcs,
            "ok": all(rc == 0 for rc in rcs)}


def run_death_case(n_procs: int, port: int, grace: float = 8.0,
                   survivor_timeout: int = 240) -> dict:
    """Failure injection: SIGKILL the last rank mid-run; the survivors must
    EXIT (collective/coordinator error) rather than hang. Kills the exact
    child PID only."""
    procs = _spawn_group(n_procs, port)
    time.sleep(grace)
    procs[-1].kill()
    procs[-1].wait()
    rcs = []
    for p in procs[:-1]:
        try:
            rcs.append(p.wait(timeout=survivor_timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs.append("hung")
    no_hang = all(isinstance(rc, int) for rc in rcs)
    return {"procs": n_procs, "death": "rank -1 SIGKILL",
            "survivor_rcs": rcs, "no_hang": no_hang, "ok": no_hang}


def launcher(proc_counts, death: bool) -> int:
    results = []
    port = 9923
    for n in proc_counts:
        results.append(run_group(n, port))
        port += 1
    if death:
        results.append(run_death_case(max(proc_counts), port))
    print(json.dumps({"launcher": "done", "groups": results}))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=None)
    ap.add_argument("--procs", default="2",
                    help="comma list of process counts to sweep (e.g. 2,4,8)")
    ap.add_argument("--death", action="store_true",
                    help="add the process-death injection case")
    args = ap.parse_args()
    if args.proc is not None:
        sys.exit(worker(args.proc))
    sys.exit(launcher([int(x) for x in args.procs.split(",")], args.death))
