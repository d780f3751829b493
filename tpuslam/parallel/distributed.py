"""Distributed Gauss-Newton: edge-sharded assembly + psum Schur reduction.

The g2o solve the reference runs on one core (reference src/slam.cpp:461-484)
becomes: every device holds the (replicated, small) pose/landmark estimates
and a shard of the observation-edge list; each assembles partial Hessian
blocks with `tpuslam.backend.gauss_newton.landmark_edge_blocks`; a `psum`
over the 'edges' mesh axis reduces the blocks (this is the "distributed Schur"
of SURVEY.md §2.4 — the reduction rides ICI); the reduced pose system is then
solved identically on every device (it is tiny relative to assembly, and
replication avoids a broadcast of the result).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from tpuslam.backend import gauss_newton as gn
from tpuslam.backend.graph import FactorGraph
from tpuslam.geometry import se2

__all__ = ["distributed_gn_step", "distributed_optimize"]


def _sharded_blocks(mesh, g: FactorGraph, cfg: gn.GNConfig):
    """Assemble full normal-equation blocks with edges sharded over the mesh."""
    cap = g.capacity
    dtype = g.poses.dtype
    w_l = jnp.asarray(cfg.lm_info, dtype) * g.obs_valid.astype(dtype)

    spec_rep = P()
    spec_edge = P("edges")

    @partial(shard_map, mesh=mesh,
             in_specs=(spec_rep, spec_rep, spec_edge, spec_edge, spec_edge,
                       spec_edge),
             out_specs=spec_rep)
    def blocks_fn(poses, lm_xy, obs_pose, obs_lm, obs_xy, w):
        parts = gn.landmark_edge_blocks(poses, lm_xy, obs_pose, obs_lm,
                                        obs_xy, w, cap.max_landmarks)
        # psum over BOTH mesh axes: 'edges' carries the Schur reduction;
        # 'sessions' is size 1 in single-session meshes (no-op) — when >1 the
        # caller must use the multisession path instead.
        return jax.tree.map(lambda x: jax.lax.psum(x, "edges"), parts)

    h_diag_lm, w_mat, hll, gp_lm, gl = blocks_fn(
        g.poses, g.lm_xy, g.obs_pose, g.obs_lm, g.obs_xy, w_l)

    h_diag_o, h_off, gp_o = gn.assemble_odometry(g, cfg)
    hpp = gn.densify_hpp(h_diag_o + h_diag_lm, h_off)
    gp = (gp_o + gp_lm).reshape(-1)
    return hpp, w_mat, hll, gp, gl


def distributed_gn_step(g: FactorGraph, cfg: gn.GNConfig, mesh) -> FactorGraph:
    """One GN iteration with the landmark-edge work sharded over `mesh`.

    Numerically identical to `gauss_newton.gn_step` (psum order is the only
    difference; reductions are deterministic for a fixed mesh).
    """
    with jax.default_matmul_precision("highest"):
        blocks = _sharded_blocks(mesh, g, cfg)
        blocks = gn._apply_gauge(g, cfg, *blocks)
        dp, dl = gn.schur_solve(*blocks)
    poses = g.poses + dp.reshape(-1, 3)
    poses = poses.at[:, 2].set(se2.wrap_angle(poses[:, 2]))
    return dataclasses.replace(g, poses=poses, lm_xy=g.lm_xy + dl)


@lru_cache(maxsize=None)
def _build_optimize(cfg: gn.GNConfig, mesh):
    @jax.jit
    def run(g):
        def body(_, gg):
            return distributed_gn_step(gg, cfg, mesh)
        return jax.lax.fori_loop(0, cfg.iterations, body, g)

    return run


def distributed_optimize(g: FactorGraph, cfg: gn.GNConfig, mesh) -> FactorGraph:
    """`cfg.iterations` distributed GN iterations under one jit.

    The compiled program is cached per (cfg, mesh); repeat calls (the serving
    path re-optimizes per closure) don't re-trace.
    """
    return _build_optimize(cfg, mesh)(g)
