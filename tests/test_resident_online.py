"""Online resident-map pipeline (parallel/resident_online.py) vs the dense
blocked pipeline, on the 8-device virtual CPU mesh.

The resident pass re-runs the exact blocked decision sequence with the
landmark arrays physically sharded (global id g on device g // Lb); every
pre-solve decision is bit-exact by construction (per-pair costs are
elementwise, winners via pmin with smallest-global-index ties), and the
sharded solves (closure GN, fixed-lag window GN) equal the dense ones up to
f32 reduction order in the psum'd reduced system.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.backend.graph import GraphCapacity
from tpuslam.frontend.blocked import run_pass_blocked
from tpuslam.frontend.state import initial_state
from tpuslam.parallel import resident_online as RO
from tpuslam.runtime.config import SlamConfig
from tpuslam.sim import SimConfig, simulate, trackdrive


def _scenario(seed=11, laps=1.4):
    track = trackdrive(seed=seed)
    scen = simulate(track, SimConfig(laps=laps, keyframe_dt=0.1, speed=8.0,
                                     max_range=20.0, seed=seed + 1))
    T = len(scen.times)
    cap = GraphCapacity(max_poses=max(64, 1 << (T - 1).bit_length()),
                        max_landmarks=256, max_obs=8192)
    return (jnp.asarray(scen.obs, jnp.float32),
            jnp.asarray(scen.obs_valid),
            jnp.asarray(scen.odom_poses, jnp.float32), cap)


def _mesh(n=8):
    return jax.make_mesh((n,), ("map",))


def _compare(s_d, o_d, s_r, o_r, atol, what):
    """Dense-vs-resident comparison: identical decision sequence (counts,
    flags, edges) exactly; estimates to the solve's f32 tolerance."""
    assert int(s_d.graph.n_landmarks) == int(s_r.graph.n_landmarks), what
    assert int(s_d.graph.n_obs) == int(s_r.graph.n_obs), what
    assert int(s_d.graph.n_poses) == int(s_r.graph.n_poses), what
    assert bool(s_d.loop_closure_complete) == bool(s_r.loop_closure_complete)
    assert int(s_d.current_cone_index) == int(s_r.current_cone_index), what
    n = int(s_d.graph.n_obs)
    np.testing.assert_array_equal(np.asarray(s_d.graph.obs_lm)[:n],
                                  np.asarray(s_r.graph.obs_lm)[:n],
                                  err_msg=f"{what} obs_lm")
    np.testing.assert_array_equal(np.asarray(s_d.graph.obs_pose)[:n],
                                  np.asarray(s_r.graph.obs_pose)[:n],
                                  err_msg=f"{what} obs_pose")
    nl = int(s_d.graph.n_landmarks)
    np.testing.assert_array_equal(np.asarray(s_d.graph.lm_type)[:nl],
                                  np.asarray(s_r.graph.lm_type)[:nl],
                                  err_msg=f"{what} lm_type")
    np.testing.assert_allclose(np.asarray(s_d.graph.lm_xy)[:nl],
                               np.asarray(s_r.graph.lm_xy)[:nl],
                               atol=atol, err_msg=f"{what} lm_xy")
    npp = int(s_d.graph.n_poses)
    np.testing.assert_allclose(np.asarray(s_d.graph.poses)[:npp],
                               np.asarray(s_r.graph.poses)[:npp],
                               atol=atol, err_msg=f"{what} poses")
    for f in ("pose", "cone_azimuth", "cone_distance"):
        np.testing.assert_allclose(np.asarray(getattr(o_d, f)),
                                   np.asarray(getattr(o_r, f)),
                                   atol=atol, err_msg=f"{what} out.{f}")
    for f in ("send", "loop_closed", "n_landmarks", "cone_type"):
        np.testing.assert_array_equal(np.asarray(getattr(o_d, f)),
                                      np.asarray(getattr(o_r, f)),
                                      err_msg=f"{what} out.{f}")


@pytest.mark.parametrize("association", ["first", "nearest"])
def test_resident_online_matches_blocked_compat(association):
    obs, valid, poses, cap = _scenario()
    cfg = SlamConfig(capacity=cap, association=association)
    s_d, o_d = run_pass_blocked(obs, valid, poses, cfg, block=16)
    assert bool(s_d.loop_closure_complete)
    s_r, o_r = RO.run_pass_resident_online(obs, valid, poses, cfg,
                                           _mesh(), block=16)
    # pre-closure decisions are bit-exact; post-closure estimates go
    # through the sharded solve (different f32 reduction tree)
    _compare(s_d, o_d, s_r, o_r, atol=2e-3, what=association)


def test_resident_online_improved_full():
    """Flagship improved mode: GPS priors + fixed-lag periodic GN with the
    free map — the sharded window solve refreshes the sharded landmarks."""
    obs, valid, poses, cap = _scenario()
    cfg = SlamConfig.improved(capacity=cap, periodic_gn_every=16)
    s_d, o_d = run_pass_blocked(obs, valid, poses, cfg, block=16)
    s_r, o_r = RO.run_pass_resident_online(obs, valid, poses, cfg,
                                           _mesh(), block=16)
    assert bool(s_d.loop_closure_complete) and \
        bool(s_r.loop_closure_complete)
    # periodic refinement feeds refined maps back into later association,
    # so tiny solve differences can compound; require equal decision
    # STRUCTURE and close estimates
    assert int(s_d.graph.n_landmarks) == int(s_r.graph.n_landmarks)
    assert abs(int(s_d.graph.n_obs) - int(s_r.graph.n_obs)) <= 2
    nl = int(s_d.graph.n_landmarks)
    np.testing.assert_allclose(np.asarray(s_d.graph.lm_xy)[:nl],
                               np.asarray(s_r.graph.lm_xy)[:nl], atol=5e-2)
    np.testing.assert_allclose(np.asarray(o_d.pose), np.asarray(o_r.pose),
                               atol=5e-2)


def test_resident_online_mahalanobis():
    obs, valid, poses, cap = _scenario()
    cfg = SlamConfig.improved(capacity=cap, association="mahalanobis",
                              periodic_gn_every=0)
    s_d, o_d = run_pass_blocked(obs, valid, poses, cfg, block=16)
    s_r, o_r = RO.run_pass_resident_online(obs, valid, poses, cfg,
                                           _mesh(), block=16)
    _compare(s_d, o_d, s_r, o_r, atol=2e-3, what="mahalanobis")


def test_resident_online_map_is_physically_sharded():
    """The load-bearing claim: inside the pass no device holds a full
    landmark array. The returned shards carry NamedSharding over 'map';
    each addressable shard holds exactly L/D rows."""
    obs, valid, poses, cap = _scenario()
    cfg = SlamConfig(capacity=cap)
    mesh = _mesh()
    from tpuslam.frontend.blocked import _pad_inputs
    obs_p, valid_p, pose_p, _ = _pad_inputs(obs, valid, poses, cfg, 16)
    state = initial_state(cap)
    lm_xy, lm_type, lm_info = RO.initial_shards(cap.max_landmarks)
    state, lm_xy, lm_type, lm_info, outs, done = RO.resident_online_core(
        state, lm_xy, lm_type, lm_info, obs_p, valid_p, pose_p, cfg, mesh,
        16)
    assert int(done) == obs_p.shape[0]
    shards = lm_xy.addressable_shards
    assert len(shards) == 8
    for sh in shards:
        assert sh.data.shape == (cap.max_landmarks // 8, 2)
    # and the shard_map body never saw more than L/D rows (by in_specs);
    # outputs replicated
    assert outs.pose.sharding.is_fully_replicated


def test_resident_online_rejects_unsupported():
    obs, valid, poses, cap = _scenario()
    # full-batch periodic GN (no window) is a dense-map construct
    cfg2 = SlamConfig.improved(capacity=cap, periodic_gn_every=16,
                               periodic_gn_window=0)
    with pytest.raises(ValueError):
        RO.run_pass_resident_online(obs, valid, poses, cfg2, _mesh())


def test_resident_online_midblock_gn_matches_blocked():
    """Mid-block multi-fire (VERDICT r4 next #3) through the SHARDED online
    pass: same firing anchors and one-gather publish re-refine as the dense
    blocked path — structure equal, estimates to solve tolerance."""
    obs, valid, poses, cap = _scenario()
    for every in (8, 16):
        cfg = SlamConfig.improved(capacity=cap, periodic_gn_every=every)
        s_d, o_d = run_pass_blocked(obs, valid, poses, cfg, block=32)
        s_r, o_r = RO.run_pass_resident_online(obs, valid, poses, cfg,
                                               _mesh(), block=32)
        assert bool(s_d.loop_closure_complete) and \
            bool(s_r.loop_closure_complete)
        assert int(s_d.graph.n_landmarks) == int(s_r.graph.n_landmarks)
        assert abs(int(s_d.graph.n_obs) - int(s_r.graph.n_obs)) <= 2
        nl = int(s_d.graph.n_landmarks)
        np.testing.assert_allclose(np.asarray(s_d.graph.lm_xy)[:nl],
                                   np.asarray(s_r.graph.lm_xy)[:nl],
                                   atol=5e-2, err_msg=f"every={every}")
        np.testing.assert_allclose(np.asarray(o_d.pose),
                                   np.asarray(o_r.pose), atol=5e-2,
                                   err_msg=f"every={every}")
