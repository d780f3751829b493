#!/usr/bin/env python
"""Bring-up check: tpuslam's main path on an NVIDIA GPU, compared with the
same code on the CPU backend of the same process.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # four cards: the fleet path only

One card, at the sizes the benchmark uses (trackdrive seed 11, 1.4 laps at
10 Hz keyframes, 326 keyframes, capacity P=512 L=256 E=8192):

  compat_lap   blocked pipeline (block 32) on the card vs the CPU backend:
               closure, map and edge arrays, cone-send flags identical,
               published poses within 1e-3; vs the float64 NumPy golden:
               same landmark count, graph trajectory within 2e-2 m
  improved     SlamConfig.improved (every-16 window GN inside block 32):
               closure and counts identical, online ATE within 5 mm
  lidar        one 360-degree VLP-16 sweep (~28.8k returns) through the
               PointCloudReading decode and detect_cones: same cone count,
               centroids within 1 cm
  fusion       eight GPS-anchored improved-mode sessions, fuse_sessions on
               one card: fused landmark count identical, poses within 1e-3 m
  cli_sim      `slamctl sim trackdrive --pipeline blocked|live`: same
               landmarks and closure, published ATE within 1e-3 m
  served       `slamctl replay` of the live lap's recording through
               SlamService: runs to its end, closes the loop, same landmarks

Four cards (a flat 4-way mesh; the cards are joined all to all):

  fleet        run_fleet_blocked over ('sessions',) vs the single-card
               vmapped pass: counts and closure identical, poses within 1e-3
  fleet_fuse   fuse_sessions over a 4-card edge mesh vs the single-card fuse
  chain_dd     chain_optimize(solver="dd") over 4 cards vs gn.optimize

Every phase prints one line: compile and run seconds on the card, seconds
of the comparison run, and each compared number beside its tolerance. The
last line is the JSON result; it reads "ok": true only when every phase
passed. Without a GPU the script exits non-zero and runs nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import sys
import tempfile
import time
import traceback

HERE = pathlib.Path(__file__).resolve().parent

# The CPU backend stays reachable beside the card for the reference runs.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

# benchmark scenario (bench.build_scenario) and capacity
TRACK_SEED, SIM_SEED, LAPS = 11, 12, 1.4
CAPACITY = (512, 256, 8192)
BLOCK = 32
FUSION_SESSIONS = 8
FLEET_CARDS = 4


def require_gpu(cards: int) -> None:
    """Exit non-zero unless JAX's default backend is the GPU with at least
    `cards` devices; nothing runs on the CPU in its place."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (default backend "
                         f"{backend!r}); nothing was run")
    if len(jax.devices()) < cards:
        raise SystemExit(f"chip_smoke: {cards} cards asked for, "
                         f"{len(jax.devices())} visible; nothing was run")


def import_repo():
    """Import the tpuslam package of this checkout, or exit non-zero."""
    sys.path.insert(0, str(HERE))
    try:
        import tpuslam
    except ImportError as e:
        raise SystemExit(f"chip_smoke: tpuslam not importable next to "
                         f"{HERE} ({e}); nothing was run")
    if pathlib.Path(tpuslam.__file__).resolve().parent != HERE / "tpuslam":
        raise SystemExit(f"chip_smoke: tpuslam imported from "
                         f"{tpuslam.__file__}, not from this checkout")


def result_line(device: dict) -> str:
    """The contract's last line: {"ok": true, "device": {...}}."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


class _CompileClock:
    """Seconds JAX spends lowering and compiling, summed over the process
    (jax.monitoring duration events). Tracing is left out: its events
    nest, one jit inside another, and would be counted twice."""
    EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


class Phase:
    """One phase: timed work on the card, timed reference work, and the
    comparisons between them."""

    def __init__(self, name, clock, ref_device):
        self.name, self.clock, self.ref_device = name, clock, ref_device
        self.compile_s = self.run_s = self.ref_s = 0.0
        self.checks = []
        self.error = None

    def device(self, fn, device=None):
        """Run fn on the card (default device unless given); its compile
        seconds and the rest are counted apart. fn returns host data."""
        c0, t0 = self.clock.total, time.perf_counter()
        with jax.default_device(device or jax.devices()[0]):
            out = fn()
        dt, dc = time.perf_counter() - t0, self.clock.total - c0
        self.compile_s += dc
        self.run_s += dt - dc
        return out

    def reference(self, fn, device=None):
        """Run fn on the reference device (the CPU unless given)."""
        t0 = time.perf_counter()
        with jax.default_device(device or self.ref_device):
            out = fn()
        self.ref_s += time.perf_counter() - t0
        return out

    def equal(self, what, got, want):
        same = bool(np.array_equal(np.asarray(got), np.asarray(want)))
        shown = (f"{got}|{want}" if np.ndim(got) == 0
                 else f"{'same' if same else 'differ'}[{np.size(got)}]")
        self.checks.append((what, shown, "identical", same))

    def within(self, what, err, tol):
        err = float(err)
        self.checks.append((what, f"{err:.3g}", f"<= {tol:g}",
                            bool(err <= tol)))

    def note(self, what, value):
        self.checks.append((what, str(value), "", True))

    @property
    def ok(self):
        return self.error is None and bool(self.checks) and all(
            c[3] for c in self.checks)

    def line(self):
        parts = [f"phase={self.name}", "PASS" if self.ok else "FAIL",
                 f"compile_s={self.compile_s:.1f}", f"run_s={self.run_s:.2f}",
                 f"ref_s={self.ref_s:.1f}"]
        for what, val, tol, ok in self.checks:
            parts.append(f"{what}={val}" + (f" ({tol})" if tol else "")
                         + ("" if ok else " !"))
        if self.error:
            parts.append(f"error={self.error}")
        return " ".join(parts)


# ------------------------------------------------------------------ helpers
def _scenario(seed=SIM_SEED):
    from tpuslam.sim import SimConfig, simulate, trackdrive
    return simulate(trackdrive(seed=TRACK_SEED),
                    SimConfig(laps=LAPS, keyframe_dt=0.1, speed=8.0,
                              max_range=20.0, seed=seed))


def _capacity():
    from tpuslam.backend.graph import GraphCapacity
    return GraphCapacity(*CAPACITY)


def _pose_err(a, b):
    """Max |delta| over x, y (m) and the wrapped heading (rad)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dxy = np.abs(a[..., :2] - b[..., :2]).max(initial=0.0)
    dth = np.abs(np.angle(np.exp(1j * (a[..., 2] - b[..., 2])))).max(
        initial=0.0)
    return max(dxy, dth)


def _lap(scen, cfg):
    """One whole lap through run_sequence_blocked on the default device;
    returns the decision arrays and estimates as host data."""
    import jax.numpy as jnp
    from tpuslam.frontend.blocked import run_sequence_blocked
    from tpuslam.frontend.state import initial_state
    from tpuslam.sim.simulator import ate
    st, outs = run_sequence_blocked(
        initial_state(cfg.capacity), jnp.asarray(scen.obs, jnp.float32),
        jnp.asarray(scen.obs_valid),
        jnp.asarray(scen.odom_poses, jnp.float32), cfg, block=BLOCK)
    g = st.graph
    n_obs, n_poses = int(g.n_obs), int(g.n_poses)
    pose = np.asarray(outs.pose)
    return {"closed": bool(st.loop_closure_complete),
            "n_landmarks": int(g.n_landmarks), "n_obs": n_obs,
            "obs_lm": np.asarray(g.obs_lm)[:n_obs],
            "obs_pose": np.asarray(g.obs_pose)[:n_obs],
            "send": np.asarray(outs.send), "pose": pose,
            "graph_poses": np.asarray(g.poses)[:n_poses],
            "ate": ate(pose[:, :2], scen.gt_poses[:len(pose), :2])}


# ------------------------------------------------------------ one-card phases
def phase_compat_lap(ph, scen):
    from tpuslam.runtime.config import SlamConfig
    from tpuslam.sim.golden_frontend import GoldenSlam
    cfg = SlamConfig(capacity=_capacity())
    got = ph.device(lambda: _lap(scen, cfg))
    ref = ph.reference(lambda: _lap(scen, cfg))
    for k in ("closed", "n_landmarks", "n_obs", "obs_lm", "obs_pose",
              "send"):
        ph.equal(k, got[k], ref[k])
    ph.within("pose_vs_cpu", _pose_err(got["pose"], ref["pose"]), 1e-3)

    gold = GoldenSlam()
    ph.reference(lambda: gold.run_scenario(scen))
    ph.equal("n_landmarks_vs_golden", got["n_landmarks"],
             len(gold.graph.landmarks))
    ph.equal("closed_vs_golden", got["closed"], gold.loop_closure_complete)
    gold_poses = np.stack(gold.graph.poses)
    ph.equal("n_poses_vs_golden", len(got["graph_poses"]), len(gold_poses))
    if len(got["graph_poses"]) == len(gold_poses):
        ph.within("trajectory_vs_golden_m", np.abs(
            got["graph_poses"][:, :2] - gold_poses[:, :2]).max(), 2e-2)


def phase_improved(ph, scen):
    from tpuslam.runtime.config import SlamConfig
    cfg = SlamConfig.improved(capacity=_capacity())
    got = ph.device(lambda: _lap(scen, cfg))
    ref = ph.reference(lambda: _lap(scen, cfg))
    for k in ("closed", "n_landmarks", "n_obs"):
        ph.equal(k, got[k], ref[k])
    ph.note("online_ate_m", f"{got['ate']:.4f}")
    ph.within("online_ate_vs_cpu_m", abs(got["ate"] - ref["ate"]), 5e-3)


def _sweep_cones():
    """One full VLP-16 revolution (every beam returns off a surrounding
    wall), decoded from its PointCloudReading, padded to a static size."""
    from tpuslam.perception.vlp16 import decode_point_cloud_reading
    from tpuslam.sim.vlp16_sim import (Vlp16SceneConfig,
                                       scene_to_point_cloud_reading)
    rng = np.random.default_rng(3)
    cones_roi = rng.uniform([1.0, -3.5], [11.0, 3.5], (12, 2))
    msg = scene_to_point_cloud_reading(
        cones_roi, Vlp16SceneConfig(seed=4, surround_range=30.0))
    cloud, _ = decode_point_cloud_reading(msg)
    cap = 32768
    pts = np.zeros((cap, 3), np.float32)
    n = min(len(cloud), cap)
    pts[:n] = cloud[:n]
    return pts, np.arange(cap) < n, n


def _detect(pts, mask, acfg):
    import jax.numpy as jnp
    from tpuslam.perception import detect_cones
    cones, ok, _n = detect_cones(jnp.asarray(pts), jnp.asarray(mask), acfg,
                                 seed=0)
    cones = np.asarray(cones, np.float64)[np.asarray(ok)]
    # (azimuth, zenith from sensor height, range) -> sensor-frame xyz
    az, zen, r = np.radians(cones[:, 0]), np.radians(cones[:, 1]), cones[:, 2]
    z = r * np.sin(zen) - acfg.sensor_height
    hor = np.sqrt(np.maximum(r * r - z * z, 0.0))
    return np.stack([hor * np.cos(az), hor * np.sin(az), z], -1)


def phase_lidar(ph):
    from tpuslam.perception import AttentionConfig
    pts, mask, n = _sweep_cones()
    acfg = AttentionConfig(sensor_height=0.9, ground_layer_z=-0.9,
                           inlier_found_threshold=1000, min_points=3)
    got = ph.device(lambda: _detect(pts, mask, acfg))
    ref = ph.reference(lambda: _detect(pts, mask, acfg))
    ph.note("returns", n)
    ph.equal("n_cones", len(got), len(ref))
    if len(got) == len(ref) and len(got):
        d = np.linalg.norm(got[:, None] - ref[None], axis=-1).min(axis=1)
        ph.within("centroid_vs_cpu_m", d.max(), 1e-2)


def _fusion_inputs(n_sessions, seed0):
    from tpuslam.backend.graph import GraphCapacity
    scens = [_scenario(seed0 + s) for s in range(n_sessions)]
    t = min(len(sc.times) for sc in scens)
    t -= t % 16
    cap = GraphCapacity(max_poses=max(384, t), max_landmarks=256,
                        max_obs=4096)
    return scens, t, cap


def _fuse_anchored(scens, t, cap):
    """bench.py's anchored fusion: improved-mode sessions through the
    batched blocked pass, then fuse_sessions with no ICP (shared GPS
    frame) and a joint GN on the one default device."""
    import jax.numpy as jnp
    from tpuslam.backend import gauss_newton as gn
    from tpuslam.frontend.blocked import blocked_core_batched
    from tpuslam.parallel import fusion
    from tpuslam.parallel.batch import initial_states
    from tpuslam.runtime.config import SlamConfig
    cfg = SlamConfig.improved(capacity=cap, association="mahalanobis",
                              periodic_gn_every=16)
    ob = jnp.stack([jnp.asarray(sc.obs[:t], jnp.float32) for sc in scens])
    vb = jnp.stack([jnp.asarray(sc.obs_valid[:t]) for sc in scens])
    pb = jnp.stack([jnp.asarray(sc.odom_poses[:t], jnp.float32)
                    for sc in scens])
    sts, _o, done = blocked_core_batched(
        initial_states(cap, len(scens)), ob, vb, pb, cfg, 16)
    if int(jnp.min(done)) != t:
        raise RuntimeError(f"fusion sessions incomplete: {np.asarray(done)}")
    fcfg = gn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info,
                       iterations=10, fix_first_poses=0,
                       fix_first_landmarks=0, solve_bucket_step=0,
                       edge_bucket_step=0, early_exit_tol=1e-4)
    fused, rep = fusion.fuse_sessions(sts.graph, cfg=fcfg,
                                      gate=cfg.same_cone_threshold,
                                      lm_info=sts.lm_info_xy, align=False)
    n_p = int(fused.n_poses)
    return {"n_landmarks": int(fused.n_landmarks), "n_poses": n_p,
            "poses": np.asarray(fused.poses)[:n_p],
            "lm_xy": np.asarray(fused.lm_xy)[:int(fused.n_landmarks)]}


def phase_fusion(ph):
    scens, t, cap = _fusion_inputs(FUSION_SESSIONS, 60)
    got = ph.device(lambda: _fuse_anchored(scens, t, cap))
    ref = ph.reference(lambda: _fuse_anchored(scens, t, cap))
    ph.note("sessions", FUSION_SESSIONS)
    for k in ("n_landmarks", "n_poses"):
        ph.equal(k, got[k], ref[k])
    if got["n_poses"] == ref["n_poses"]:
        ph.within("poses_vs_cpu", _pose_err(got["poses"], ref["poses"]),
                  1e-3)
    cones = scens[0].track.cones_xy
    err = np.median(np.linalg.norm(
        got["lm_xy"][:, None] - cones[None], axis=-1).min(axis=1))
    ph.note("map_error_m", f"{err:.4f}")


def _cli(argv):
    """`slamctl <argv>` in process; its stdout parsed as JSON."""
    from tpuslam.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"slamctl {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue())


def phase_cli_sim(ph, rec_path):
    lap = ["sim", "trackdrive", "--laps", str(LAPS), "--seed",
           str(TRACK_SEED)]
    blocked = ph.device(lambda: _cli(
        lap + ["--pipeline", "blocked", "--block", str(BLOCK)]))
    live = ph.device(lambda: _cli(
        lap + ["--pipeline", "live", "--rec-out", rec_path]))
    ph.note("frames", live["frames"])
    ph.equal("landmarks", blocked["landmarks"], live["landmarks"])
    ph.equal("loop_closed", blocked["loop_closed"], live["loop_closed"])
    ph.within("ate_blocked_vs_live_m",
              abs(blocked["ate_published_m"] - live["ate_published_m"]),
              1e-3)
    return live


def phase_served(ph, rec_path, live):
    # the recording holds one frame per 500 ms; the reference's keyframe
    # gate admits frames MORE than timeBetweenKeyframes apart, so a 250 ms
    # gate keeps every recorded frame, as the live run does
    rep = ph.device(lambda: _cli(["replay", rec_path,
                                  "--timeBetweenKeyframes", "250"]))
    gauges = rep["gauges"]
    ph.equal("loop_closed", gauges["loop_closed"], True)
    ph.equal("landmarks_vs_live", gauges["landmarks"], live["landmarks"])
    ph.note("poses_published", gauges["keyframes"])


# ---------------------------------------------------------- four-card phases
def _fleet_inputs(n):
    import jax.numpy as jnp
    from tpuslam.runtime.config import SlamConfig
    scens = [_scenario(SIM_SEED + s) for s in range(n)]
    t = min(len(sc.times) for sc in scens)
    pad = (-t) % BLOCK
    cfg = SlamConfig(capacity=_capacity())
    far = 2.0 * cfg.gps_outlier_bound + 1.0

    def stack(f, fill):
        return jnp.stack([jnp.concatenate([
            jnp.asarray(f(sc)[:t]),
            jnp.full((pad,) + f(sc).shape[1:], fill, f(sc).dtype)])
            for sc in scens])
    ob = stack(lambda sc: sc.obs.astype(np.float32), 0.0)
    vb = stack(lambda sc: sc.obs_valid, False)
    pb = stack(lambda sc: sc.odom_poses.astype(np.float32), far)
    return cfg, t, ob, vb, pb


def _fleet_summary(sts, outs, t):
    g = sts.graph
    return {"closed": np.asarray(sts.loop_closure_complete),
            "n_landmarks": np.asarray(g.n_landmarks),
            "n_obs": np.asarray(g.n_obs),
            "pose": np.asarray(outs.pose)[:, :t], "graph": g}


def _fuse_cfg(cfg):
    from tpuslam.backend import gauss_newton as gn
    return gn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info,
                       iterations=10, fix_first_poses=2,
                       fix_first_landmarks=2)


def phase_fleet(ph, cards):
    from tpuslam.frontend.blocked import blocked_core_batched
    from tpuslam.parallel.batch import initial_states
    from tpuslam.parallel.fleet import run_fleet_blocked
    from tpuslam.parallel.mesh import make_slam_mesh
    cfg, t, ob, vb, pb = _fleet_inputs(cards)
    cap = cfg.capacity
    mesh = make_slam_mesh(n_sessions=cards, n_edge_shards=1,
                          devices=jax.devices()[:cards])
    got = ph.device(lambda: _fleet_summary(*run_fleet_blocked(
        initial_states(cap, cards), ob, vb, pb, cfg, mesh,
        block=BLOCK)[:2], t))
    ref = ph.reference(lambda: _fleet_summary(*blocked_core_batched(
        initial_states(cap, cards), ob, vb, pb, cfg, BLOCK)[:2], t))
    ph.note("sessions", cards)
    for k in ("closed", "n_landmarks", "n_obs"):
        ph.equal(k, got[k], ref[k])
    ph.within("pose_vs_one_card", _pose_err(got["pose"], ref["pose"]), 1e-3)
    # the sessions' graphs from the one-card pass feed both solves below
    return ref["graph"], cfg


def phase_fleet_fuse(ph, cards, stacked, cfg):
    from tpuslam.parallel import fusion
    from tpuslam.parallel.mesh import make_slam_mesh

    def fuse(mesh):
        f, _ = fusion.fuse_sessions(stacked, cfg=_fuse_cfg(cfg),
                                    gate=cfg.same_cone_threshold, mesh=mesh,
                                    align=False)
        n_p = int(f.n_poses)
        return {"n_landmarks": int(f.n_landmarks),
                "poses": np.asarray(f.poses)[:n_p]}

    edge_mesh = make_slam_mesh(n_sessions=1, n_edge_shards=cards,
                               devices=jax.devices()[:cards])
    got = ph.device(lambda: fuse(edge_mesh))
    ref = ph.reference(lambda: fuse(None))
    ph.equal("n_landmarks", got["n_landmarks"], ref["n_landmarks"])
    ph.equal("n_poses", len(got["poses"]), len(ref["poses"]))
    if got["poses"].shape == ref["poses"].shape:
        ph.within("poses_vs_one_card", _pose_err(got["poses"], ref["poses"]),
                  1e-3)


def phase_chain_dd(ph, cards, stacked, cfg):
    from tpuslam.backend import gauss_newton as gn
    from tpuslam.parallel import fusion
    from tpuslam.parallel.chain import chain_optimize
    from tpuslam.parallel.mesh import make_chain_mesh
    unsolved, _ = fusion.fuse_sessions(stacked, cfg=None,
                                       gate=cfg.same_cone_threshold,
                                       align=False)
    n_p = int(unsolved.n_poses)
    mesh = make_chain_mesh(cards, devices=jax.devices()[:cards])
    got = ph.device(lambda: np.asarray(chain_optimize(
        unsolved, _fuse_cfg(cfg), mesh, solver="dd").poses)[:n_p])
    ref = ph.reference(lambda: np.asarray(
        gn.optimize(unsolved, _fuse_cfg(cfg)).poses)[:n_p])
    ph.note("poses", n_p)
    ph.within("poses_vs_gn_optimize", _pose_err(got, ref), 2e-3)


class _Phases(list):
    """The phases run so far; a phase that raises is reported as failed
    and the next one still runs."""

    def __init__(self, clock, ref_device):
        super().__init__()
        self.clock, self.ref_device = clock, ref_device

    def run(self, name, fn, *args):
        ph = Phase(name, self.clock, self.ref_device)
        self.append(ph)
        try:
            return fn(ph, *args)
        except Exception as e:  # noqa: BLE001 - report and go on
            traceback.print_exc()
            ph.error = f"{type(e).__name__}: {str(e)[:120]}"


def phases_four_cards(clock, cards):
    # the reference is the same work on one card
    phases = _Phases(clock, jax.devices()[0])
    fleet = phases.run("fleet", phase_fleet, cards)
    if fleet is not None:
        phases.run("fleet_fuse", phase_fleet_fuse, cards, *fleet)
        phases.run("chain_dd", phase_chain_dd, cards, *fleet)
    return phases


def phases_one_card(clock):
    phases = _Phases(clock, jax.devices("cpu")[0])
    scen = _scenario()
    phases.run("compat_lap", phase_compat_lap, scen)
    phases.run("improved", phase_improved, scen)
    phases.run("lidar", phase_lidar)
    phases.run("fusion", phase_fusion)
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "trackdrive.rec")
        live = phases.run("cli_sim", phase_cli_sim, rec)
        if live is not None:
            phases.run("served", phase_served, rec, live)
    return phases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=[1, FLEET_CARDS], default=1,
                    help="1: the one-card phases; 4: the four-card fleet "
                         "path and what it is compared with, nothing else")
    args = ap.parse_args(argv)
    require_gpu(args.cards)
    import_repo()
    from tpuslam.runtime.device import (device_record, enable_compile_cache,
                                        nvidia_smi)
    enable_compile_cache()
    device = device_record()
    print(f"device {json.dumps(device)} nvidia-smi: {nvidia_smi()}",
          flush=True)

    clock = _CompileClock()
    t0 = time.perf_counter()
    phases = (phases_one_card(clock) if args.cards == 1
              else phases_four_cards(clock, args.cards))
    for ph in phases:
        print(ph.line(), flush=True)
    ok = all(ph.ok for ph in phases)
    print(f"total_s={time.perf_counter() - t0:.1f} "
          f"compile_s={clock.total:.1f}", flush=True)
    if not ok:
        print(json.dumps({"ok": False, "failed": [
            ph.name for ph in phases if not ph.ok]}))
        return 1
    print(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
