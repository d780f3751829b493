"""Reference-semantics CPU pipeline — behavioral oracle AND measured baseline.

A faithful Python/NumPy re-expression of the reference's per-keyframe control
flow (reference src/slam.cpp:298-414): sequential per-observation map scan
with first-match association, in-frame landmark growth, one-shot loop closure
with a full float64 Gauss-Newton (tpuslam.backend.golden), then frozen-map
localization. It deliberately mirrors the C++ loop structure instead of
vectorizing, because it serves two purposes:

1. Oracle: the JAX engine in reference_compat mode must produce the same map
   and trajectory on the same inputs (tested in tests/test_compat_oracle.py).
2. Baseline: BASELINE.md requires *measured* reference performance — this is
   the reference stand-in bench.py times on CPU (the original C++/g2o service
   is not runnable here; a per-frame Python/NumPy loop is a generous stand-in
   for its per-frame O(N*M) scan + g2o solve).
"""
from __future__ import annotations

import math

import numpy as np

from tpuslam import compat
from tpuslam.backend import golden


def _cog_transform(az_deg, dist, lever=1.5):
    """reference src/slam.cpp:513-523."""
    sign = 1.0 if az_deg >= 0 else -1.0
    a = compat.REF_PI - abs(az_deg * compat.REF_DEG2RAD)
    d_new = math.sqrt(lever * lever + dist * dist - 2 * lever * dist * math.cos(a))
    a_new = math.asin(min(1.0, max(-1.0, math.sin(a) * dist / max(d_new, 1e-12)))) \
        * compat.REF_RAD2DEG
    return a_new * sign, d_new


def _spherical_to_cartesian(az, zen, dist):
    """reference src/slam.cpp:637-654."""
    a, d = _cog_transform(az, dist)
    d2r = compat.REF_DEG2RAD
    return (d * math.cos(zen * d2r) * math.cos(a * d2r),
            d * math.cos(zen * d2r) * math.sin(a * d2r))


def _cone_to_global(pose, ob):
    x, y = _spherical_to_cartesian(ob[0], ob[1], ob[2])
    c, s = math.cos(pose[2]), math.sin(pose[2])
    return (x * c - y * s + pose[0], x * s + y * c + pose[1])


class GoldenSlam:
    """The reference SLAM service's observable behavior, in NumPy."""

    def __init__(self, same_cone_threshold=1.2, cone_mapping_threshold=50.0,
                 loop_radius=1.0, loop_min_index=20, gn_iterations=10):
        self.gate = same_cone_threshold
        self.map_range = cone_mapping_threshold
        self.loop_radius = loop_radius
        self.loop_min_index = loop_min_index
        self.gn_iterations = gn_iterations

        self.graph = golden.GoldenGraph()
        self.map_type: list[int] = []
        self.current_cone_index = 0
        self.loop_closing = False
        self.loop_closure_complete = False
        self.trajectory: list[np.ndarray] = []

    def process_frame(self, obs, valid, pose):
        """reference performSLAM (src/slam.cpp:298-338)."""
        pose = np.asarray(pose, dtype=np.float64)
        if abs(pose[0]) > 200 or abs(pose[1]) > 200:
            return pose
        self.graph.add_pose(pose)
        self.trajectory.append(pose.copy())
        obs = [obs[i] for i in range(len(obs)) if valid[i]]
        if not self.loop_closure_complete:
            self._add_cones_to_map(obs, pose)
        elif len(obs) > 1:
            self._localize(obs, pose)
        return pose

    def _add_cones_to_map(self, obs, pose):
        """reference addConesToMap (src/slam.cpp:552-635)."""
        g = self.graph
        pose_idx = len(g.poses) - 1
        if len(g.landmarks) == 0 and obs:
            gx, gy = _cone_to_global(pose, obs[0])
            j = g.add_landmark((gx, gy))
            self.map_type.append(int(obs[0][3]))
            g.add_observation(pose_idx, j, _spherical_to_cartesian(*obs[0][:3]))

        min_dist = 100.0
        for ob in obs:
            dist2car = ob[2]
            gx, gy = _cone_to_global(pose, ob)
            found = False
            for j in range(len(g.landmarks)):
                if self.loop_closing or found:
                    break
                if abs(self.map_type[j] - ob[3]) < 1e-4:
                    d = math.hypot(g.landmarks[j][0] - gx, g.landmarks[j][1] - gy)
                    if d < self.gate:
                        found = True
                        g.add_observation(pose_idx, j,
                                          _spherical_to_cartesian(*ob[:3]))
                        d0 = math.hypot(g.landmarks[j][0] - g.landmarks[0][0],
                                        g.landmarks[j][1] - g.landmarks[0][1])
                        if (d0 < self.loop_radius
                                and self.current_cone_index > self.loop_min_index
                                and dist2car < self.map_range
                                and not self.loop_closing):
                            self.loop_closing = True
                        if dist2car < min_dist:
                            self.current_cone_index = j
                            min_dist = dist2car
            if dist2car < self.map_range and not found and not self.loop_closing:
                j = g.add_landmark((gx, gy))
                self.map_type.append(int(ob[3]))
                g.add_observation(pose_idx, j, _spherical_to_cartesian(*ob[:3]))
            if self.loop_closing and not self.loop_closure_complete:
                golden.golden_optimize(g, iterations=self.gn_iterations)
                self.loop_closure_complete = True

    def _localize(self, obs, pose):
        """reference localizer (src/slam.cpp:340-414)."""
        g = self.graph
        min_dist = 100.0
        current = None
        for ob in obs:
            gx, gy = _cone_to_global(pose, ob)
            for j in range(len(g.landmarks)):
                # NOTE the reference's signed type compare (src/slam.cpp:360)
                if (self.map_type[j] - ob[3]) < 1e-4:
                    d = math.hypot(g.landmarks[j][0] - gx, g.landmarks[j][1] - gy)
                    if d < self.gate:
                        if ob[2] < min_dist:
                            current = j
                            min_dist = ob[2]
                        break
        if current is not None:
            self.current_cone_index = current

    @property
    def landmarks(self):
        return np.array(self.graph.landmarks) if self.graph.landmarks \
            else np.zeros((0, 2))

    def run_scenario(self, scenario):
        for t in range(len(scenario.times)):
            self.process_frame(scenario.obs[t], scenario.obs_valid[t],
                               scenario.odom_poses[t])
        return np.stack(self.trajectory) if self.trajectory else np.zeros((0, 3))
