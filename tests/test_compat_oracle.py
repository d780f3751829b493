"""Behavioral parity: the JAX engine (reference_compat) vs the NumPy golden
frontend that mirrors the reference C++ control flow line by line."""
import numpy as np

from tpuslam.backend.graph import GraphCapacity
from tpuslam.core.slam import Slam
from tpuslam.runtime.config import SlamConfig
from tpuslam.sim import SimConfig, simulate, skidpad
from tpuslam.sim.golden_frontend import GoldenSlam


def test_mapping_matches_reference_semantics():
    track = skidpad()
    scen = simulate(track, SimConfig(laps=1.3, seed=7))
    cap = GraphCapacity(max_poses=128, max_landmarks=64, max_obs=2048)
    cfg = SlamConfig(capacity=cap)

    slam = Slam(cfg)
    gold = GoldenSlam(same_cone_threshold=cfg.same_cone_threshold,
                      cone_mapping_threshold=cfg.cone_mapping_threshold,
                      loop_radius=cfg.loop_closure_radius,
                      loop_min_index=cfg.loop_closure_min_index,
                      gn_iterations=cfg.gn_iterations)

    for t in range(len(scen.times)):
        us = int(scen.times[t] * 1e6)
        slam._odometry[:] = scen.odom_poses[t]  # bypass WGS84 roundtrip: both
        slam.process_frame(scen.obs[t], scen.obs_valid[t], us)  # sides get the
        gold.process_frame(scen.obs[t], scen.obs_valid[t],     # same odometry
                           scen.odom_poses[t])

    assert slam.loop_closure_complete == gold.loop_closure_complete
    n_dev = int(slam.state.graph.n_landmarks)
    n_gold = len(gold.graph.landmarks)
    assert n_dev == n_gold, (n_dev, n_gold)

    lm_dev, type_dev = slam.draw_cones()
    lm_gold = gold.landmarks
    # identical association decisions => identical map ordering; positions
    # agree to f32-vs-f64 tolerance (both sides ran the same 10-iteration GN)
    np.testing.assert_allclose(lm_dev, lm_gold, atol=2e-2)
    np.testing.assert_array_equal(type_dev, np.array(gold.map_type))
    assert int(slam.state.current_cone_index) == gold.current_cone_index

    # trajectory: pose chains must match (odometry in, optimized at closure)
    poses_dev = slam.draw_poses()
    poses_gold = np.stack(gold.graph.poses)
    np.testing.assert_allclose(poses_dev[:, :2], poses_gold[:, :2], atol=2e-2)
