"""Device-resident factor-graph state for 2D landmark GraphSLAM.

The reference builds its graph incrementally inside g2o (`VertexSE2` poses with
ids from 1000, `VertexPointXY` landmarks with ids from 0, `EdgeSE2` odometry
chain, `EdgeSE2PointXY` landmark observations — reference src/slam.cpp:433-550).

Accelerator-friendly redesign: instead of a pointer-graph, the whole problem lives in
fixed-capacity structure-of-arrays with validity masks (SURVEY.md §7 "Hard
parts": dynamic growth vs XLA static shapes). Every mutation is a functional
masked write, so the per-keyframe update jits into one fused XLA program and
never recompiles as counts change.

Graph layout
------------
- poses:        [P, 3]  (x, y, theta) estimates; pose k is keyframe k.
- odometry:     implicit chain — odo_meas[k] is the SE(2) measurement
                between(pose[k-1], pose[k]) frozen at insertion time
                (reference src/slam.cpp:445-458); odo_meas[0] is unused.
- landmarks:    [L, 2] xy + [L] integer type (1=yellow 2=blue 3/4=orange,
                reference viewerbuild/src/drawer.cpp:22-41).
- observations: flat edge list (obs_pose[e], obs_lm[e]) with body-frame
                Cartesian measurement obs_xy[e] (reference src/slam.cpp:537-550).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class GraphCapacity:
    """Static array capacities (shape constants baked into the jit)."""
    max_poses: int = 1024
    max_landmarks: int = 512
    max_obs: int = 8192


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FactorGraph:
    # poses
    poses: jax.Array        # [P, 3] f32
    n_poses: jax.Array      # i32 scalar
    odo_meas: jax.Array     # [P, 3] f32; odo_meas[k] = between(pose[k-1], pose[k])
    odo_w: jax.Array        # [P] f32 per-edge odometry weight multiplier on the
    # chain edge (pose k-1 -> k). 1.0 everywhere for a single session (the
    # reference's uniform I3*odo_info chain); 0.0 severs the edge — used by
    # cross-session map fusion (tpuslam/parallel/fusion.py) where the fused
    # graph concatenates S independent pose chains and the bogus edge between
    # session s's last pose and session s+1's first pose must carry no
    # information.
    # landmarks
    lm_xy: jax.Array        # [L, 2] f32
    lm_type: jax.Array      # [L] i32
    n_landmarks: jax.Array  # i32 scalar
    # landmark-observation edges
    obs_pose: jax.Array     # [E] i32
    obs_lm: jax.Array       # [E] i32
    obs_xy: jax.Array       # [E, 2] f32 body-frame measurement
    n_obs: jax.Array        # i32 scalar
    # absolute pose priors (improved mode: GPS/heading unary factors that
    # anchor the graph instead of the reference's hard gauge clamping —
    # src/slam.cpp:464-474 fixes the first two poses/landmarks instead).
    # info == 0 disables the prior for that pose.
    prior_pose: jax.Array   # [P, 3] f32 measured (x, y, theta)
    prior_info: jax.Array   # [P, 2] f32 (xy information, theta information)

    @property
    def pose_valid(self):
        return jnp.arange(self.poses.shape[0]) < self.n_poses

    @property
    def lm_valid(self):
        return jnp.arange(self.lm_xy.shape[0]) < self.n_landmarks

    @property
    def obs_valid(self):
        return jnp.arange(self.obs_pose.shape[0]) < self.n_obs

    @property
    def capacity(self) -> GraphCapacity:
        return GraphCapacity(self.poses.shape[0], self.lm_xy.shape[0],
                             self.obs_pose.shape[0])


def empty_graph(cap: GraphCapacity, dtype=jnp.float32) -> FactorGraph:
    return FactorGraph(
        poses=jnp.zeros((cap.max_poses, 3), dtype),
        n_poses=jnp.int32(0),
        odo_meas=jnp.zeros((cap.max_poses, 3), dtype),
        odo_w=jnp.ones((cap.max_poses,), dtype),
        lm_xy=jnp.zeros((cap.max_landmarks, 2), dtype),
        lm_type=jnp.zeros((cap.max_landmarks,), jnp.int32),
        n_landmarks=jnp.int32(0),
        obs_pose=jnp.zeros((cap.max_obs,), jnp.int32),
        obs_lm=jnp.zeros((cap.max_obs,), jnp.int32),
        obs_xy=jnp.zeros((cap.max_obs, 2), dtype),
        n_obs=jnp.int32(0),
        prior_pose=jnp.zeros((cap.max_poses, 3), dtype),
        prior_info=jnp.zeros((cap.max_poses, 2), dtype),
    )


def add_pose(g: FactorGraph, pose, odo_meas, prior_info=None) -> FactorGraph:
    """Append a pose vertex + odometry edge from its predecessor.

    `odo_meas` must be between(prev_pose_estimate, pose) evaluated by the
    caller at insertion time (the reference freezes the measurement from the
    *current estimates* the same way, src/slam.cpp:451-455). Saturates
    silently at capacity (caller checks n_poses beforehand).
    `prior_info` (xy_info, theta_info) attaches an absolute prior at `pose`.
    """
    k = jnp.minimum(g.n_poses, g.poses.shape[0] - 1)
    g = dataclasses.replace(
        g,
        poses=g.poses.at[k].set(pose),
        odo_meas=g.odo_meas.at[k].set(odo_meas),
        n_poses=jnp.minimum(g.n_poses + 1, g.poses.shape[0]),
    )
    if prior_info is not None:
        g = dataclasses.replace(
            g,
            prior_pose=g.prior_pose.at[k].set(pose),
            prior_info=g.prior_info.at[k].set(jnp.asarray(prior_info, g.poses.dtype)),
        )
    return g


def add_landmark(g: FactorGraph, xy, lm_type, enable=True) -> FactorGraph:
    """Masked append of one landmark; no-op when `enable` is False."""
    k = jnp.minimum(g.n_landmarks, g.lm_xy.shape[0] - 1)
    en = jnp.asarray(enable)
    return dataclasses.replace(
        g,
        lm_xy=g.lm_xy.at[k].set(jnp.where(en, xy, g.lm_xy[k])),
        lm_type=g.lm_type.at[k].set(jnp.where(en, lm_type, g.lm_type[k])),
        n_landmarks=jnp.minimum(g.n_landmarks + en.astype(jnp.int32),
                                g.lm_xy.shape[0]),
    )


def add_observation(g: FactorGraph, pose_idx, lm_idx, meas_xy, enable=True) -> FactorGraph:
    """Masked append of one landmark-observation edge."""
    k = jnp.minimum(g.n_obs, g.obs_pose.shape[0] - 1)
    en = jnp.asarray(enable)
    return dataclasses.replace(
        g,
        obs_pose=g.obs_pose.at[k].set(jnp.where(en, pose_idx, g.obs_pose[k])),
        obs_lm=g.obs_lm.at[k].set(jnp.where(en, lm_idx, g.obs_lm[k])),
        obs_xy=g.obs_xy.at[k].set(jnp.where(en, meas_xy, g.obs_xy[k])),
        n_obs=jnp.minimum(g.n_obs + en.astype(jnp.int32), g.obs_pose.shape[0]),
    )
