"""The per-keyframe SLAM update — one fused XLA program.

This is the JAX replacement for the reference's hot path
(`Slam::performSLAM` -> `addConesToMap`/`localizer` -> publishing,
reference src/slam.cpp:298-414). The whole update — GPS-outlier guard, pose
insertion, data association, landmark creation, loop-closure detection, the
one-shot full Gauss-Newton optimization, localization, and egress packet
construction — compiles into a single jit call with static shapes: no host
round-trips, no recompiles as the map grows.

Mapping mode keeps the reference's *sequential-within-frame* semantics (each
observation sees landmarks created by earlier observations in the same frame,
reference src/slam.cpp:570-623) via lax.scan over the observation axis, with
the landmark axis fully vectorized — the "sequential update -> batched
association" transformation named in BASELINE.json.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from tpuslam.backend import gauss_newton as gn
from tpuslam.backend import graph as G
from tpuslam.frontend.state import SlamState
from tpuslam.geometry import se2
from tpuslam.geometry.spherical import (
    cone_to_global, global_to_body_spherical, spherical_to_cartesian,
)
from tpuslam.runtime.config import SlamConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KeyframeOutputs:
    """What the service publishes after a localization update
    (reference src/slam.cpp:656-695)."""
    pose: jax.Array        # [3] published pose (local Cartesian + heading)
    cone_azimuth: jax.Array  # [K] degrees, car frame (reference quirk units)
    cone_distance: jax.Array  # [K] meters
    cone_type: jax.Array   # [K] int32
    send: jax.Array        # bool — whether this keyframe publishes
    loop_closed: jax.Array  # bool — closure optimization ran this keyframe
    n_landmarks: jax.Array  # i32 diagnostic


def _gn_config(cfg: SlamConfig) -> gn.GNConfig:
    if cfg.use_gps_prior:
        # absolute priors anchor the graph; no gauge clamping needed
        return gn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info,
                           iterations=cfg.gn_iterations,
                           fix_first_poses=0, fix_first_landmarks=0,
                           matmul_precision=cfg.gn_matmul_precision,
                           early_exit_tol=cfg.gn_early_exit_tol)
    return gn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info,
                       iterations=cfg.gn_iterations,
                       matmul_precision=cfg.gn_matmul_precision,
                       early_exit_tol=cfg.gn_early_exit_tol)


def _body_xy(ob, cfg: SlamConfig):
    """Observation spherical triple -> body-frame Cartesian measurement."""
    xyz = spherical_to_cartesian(ob[..., 0], ob[..., 1], ob[..., 2],
                                 cfg.lidar_to_cog, cfg.reference_compat)
    return xyz[..., :2]


def _obs_information(glob, pose, dist, cfg: SlamConfig):
    """Per-observation 2x2 measurement information in the global frame,
    packed (a, b, c): range noise along the pose->landmark ray, bearing
    noise (dist * sigma_az) tangentially. This is what accumulates into
    `SlamState.lm_info_xy` and drives the Mahalanobis gate — the
    generalization of the reference's Euclidean gate that BASELINE.json
    mandates."""
    d = glob[..., :2] - pose[:2]
    rng = jnp.maximum(jnp.linalg.norm(d, axis=-1), 1e-3)
    u = d / rng[..., None]                      # radial unit vector
    sig_r = jnp.asarray(cfg.obs_noise_std, glob.dtype)
    sig_t = jnp.maximum(rng * jnp.radians(
        jnp.asarray(cfg.obs_noise_az_deg, glob.dtype)), 1e-2)
    ir = 1.0 / (sig_r * sig_r)
    it = 1.0 / (sig_t * sig_t)
    ux, uy = u[..., 0], u[..., 1]
    # R^-1 = ir*u u^T + it*t t^T with t = (-uy, ux)
    a = ir * ux * ux + it * uy * uy
    b = (ir - it) * ux * uy
    c = ir * uy * uy + it * ux * ux
    return jnp.stack([a, b, c], axis=-1)        # [..., 3]


def _innovation_info(lm_info, cfg: SlamConfig):
    """Packed (a, b, c) posterior landmark information -> packed INNOVATION
    information (Sigma_lm + sigma_r^2 I)^-1.

    Gating a new observation against the landmark's raw posterior
    information is statistically wrong: the innovation covariance is the
    landmark covariance PLUS the observation's own noise. Without the noise
    term the gate shrinks without bound as observations accumulate (a
    50-observation landmark would reject genuine re-detections beyond
    ~0.13 m), over-creating duplicate landmarks and making any fixed-lag /
    blocked gating decision-unstable. With it, the gate tightens from the
    fresh-landmark radius toward the sensor-noise floor and no further."""
    a, b, c = lm_info[..., 0], lm_info[..., 1], lm_info[..., 2]
    det = jnp.maximum(a * c - b * b, 1e-12)
    s2 = jnp.asarray(cfg.obs_noise_std, lm_info.dtype) ** 2
    # Sigma = [[c, -b], [-b, a]] / det;  S = Sigma + s2*I;  return packed S^-1
    sa = c / det + s2
    sb = -b / det
    sc = a / det + s2
    dets = jnp.maximum(sa * sc - sb * sb, 1e-12)
    return jnp.stack([sc / dets, -sb / dets, sa / dets], axis=-1)


def _gate_cost(diff, d2, lm_info, cfg: SlamConfig):
    """(N x M) gating cost + threshold: squared Euclidean vs the reference
    threshold, or Mahalanobis d^T S^-1 d (S = innovation covariance, see
    `_innovation_info`) vs the chi-square bound. Landmarks with no
    accumulated information (zero rows) fall back to the Euclidean gate so
    brand-new maps behave identically."""
    if cfg.association != "mahalanobis":
        return d2, cfg.same_cone_threshold ** 2
    inno = _innovation_info(lm_info, cfg)
    a, b, c = inno[:, 0], inno[:, 1], inno[:, 2]
    dx, dy = diff[..., 0], diff[..., 1]
    mahal = a[None, :] * dx * dx + 2.0 * b[None, :] * dx * dy \
        + c[None, :] * dy * dy
    has_info = (lm_info[:, 0] + lm_info[:, 2])[None, :] > 0.0
    thresh2 = cfg.same_cone_threshold ** 2
    cost = jnp.where(has_info, mahal,
                     d2 * (cfg.mahalanobis_gate / thresh2))
    return cost, cfg.mahalanobis_gate


def _associate_shared(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig,
                      assoc_mesh=None):
    """The association work shared by mapping and localization: observations
    to global frame, body-frame measurements, and the association payload —
    the (N x M) gating cost matrix (squared Euclidean, or Mahalanobis under
    cfg.association='mahalanobis'); or, with `assoc_mesh`, the
    (match_idx, matched) pair from the mesh-sharded map-block provider, with
    no (N x M) materialized (tpuslam/parallel/map_blocks.py) — association runs shard-local
    over the landmark axis and one pmin lattice reduction picks the global
    winner (the pod-scale map layout). Hoisted out of the
    mapping/localization cond so a vmapped step (which executes both
    branches) pays for it once."""
    glob_all = jax.vmap(lambda ob: cone_to_global(
        pose, ob[0], ob[1], ob[2], cfg.lidar_to_cog, cfg.reference_compat))(obs)
    body_all = _body_xy(obs, cfg)
    if assoc_mesh is not None:
        j, matched = _associate_map_sharded(state, glob_all, obs, obs_valid,
                                            cfg, assoc_mesh)
        return glob_all, body_all, j, matched
    diff = glob_all[:, None, :] - state.graph.lm_xy[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    cost, gate = _gate_cost(diff, d2, state.lm_info_xy, cfg)
    return glob_all, body_all, cost, gate


def _associate_map_sharded(state: SlamState, glob_all, obs, obs_valid,
                           cfg: SlamConfig, mesh):
    """Association against the landmark-sharded map
    (tpuslam.parallel.map_blocks.associate_sharded): every policy including
    the reference's 'first' (global first = smallest landmark index).
    Exact vs the dense path on match decisions; it does not reproduce the localizer signed-type quirk (clean type
    equality), so use it with localizer_type_bug=False configs."""
    g = state.graph
    j, matched, _ = _provider_associate(
        glob_all, obs[:, 3].astype(jnp.int32), obs_valid, g.lm_xy,
        g.lm_type, g.lm_valid, state.lm_info_xy, cfg, assoc_mesh=mesh)
    return j, matched


def _mahal_packed(lm_info, cfg: SlamConfig):
    """Packed innovation information with the zero-information scaled-
    Euclidean fallback — the per-landmark payload the sharded map-block
    provider gates with under 'mahalanobis'."""
    thresh2 = cfg.same_cone_threshold ** 2
    fallback = cfg.mahalanobis_gate / thresh2
    has = (lm_info[:, 0] + lm_info[:, 2]) > 0.0
    return jnp.where(has[:, None], _innovation_info(lm_info, cfg),
                     jnp.asarray([fallback, 0.0, fallback], lm_info.dtype))


def _provider_associate(glob, otype, valid, lm_xy, lm_type, lm_valid,
                        lm_info, cfg: SlamConfig, assoc_mesh):
    """(match_idx, matched, cost) for a flat observation batch from the
    mesh-sharded map-block provider over `assoc_mesh`. Shared by the
    per-frame and blocked pipelines."""
    from tpuslam.parallel.map_blocks import associate_sharded
    if cfg.association == "mahalanobis":
        p = _mahal_packed(lm_info, cfg)
        a, b, c = p[:, 0], p[:, 1], p[:, 2]
        cov_inv = jnp.stack(
            [jnp.stack([a, b], -1), jnp.stack([b, c], -1)], -2)
        j, matched, cost = associate_sharded(
            glob, otype, valid, lm_xy, lm_type, lm_valid,
            cfg.mahalanobis_gate, assoc_mesh, mode="mahalanobis",
            lm_cov_inv=cov_inv)
    else:
        j, matched, cost = associate_sharded(
            glob, otype, valid, lm_xy, lm_type, lm_valid,
            cfg.same_cone_threshold, assoc_mesh, mode=cfg.association)
    return j.astype(jnp.int32), matched, cost


def _prefix_argmin_exclusive(vals, idxs):
    """Running (min, argmin) over k < i, ties keeping the earliest — the
    vectorized form of the reference's `if (d < minDistance)` loop carry."""
    def op(a, b):
        va, ia = a
        vb, ib = b
        take_b = vb < va
        return (jnp.where(take_b, vb, va), jnp.where(take_b, ib, ia))

    mv, mi = jax.lax.associative_scan(op, (vals, idxs))
    big = jnp.full((1,), jnp.inf, vals.dtype)
    neg = jnp.full((1,), -1, idxs.dtype)
    return (jnp.concatenate([big, mv[:-1]]), jnp.concatenate([neg, mi[:-1]]))


def _mapping_step_vectorized(state: SlamState, obs, obs_valid, pose, pose_idx,
                             cfg: SlamConfig, defer_gn: bool = False,
                             pre=None, indexed: bool = False):
    """Batched mapping-mode update — exactly the reference's sequential
    semantics (src/slam.cpp:552-635) re-expressed as vector ops.

    The per-observation while-loop becomes one (N x M) gated cost matrix; the
    in-frame running state (currentConeIndex, loop-closure trigger, map
    growth) becomes prefix scans over the observation axis:
    - currentConeIndex evolution  -> exclusive prefix-argmin of ranges,
    - loop-closure suppression    -> exclusive prefix-or of closure hits,
    - in-frame duplicate merging  -> first-representative fixpoint over the
      (N x N) same-frame gate matrix (depth-8; physical cone layouts have
      depth <= 1),
    and the edge list grows by one contiguous block write instead of N
    scatters. See `_mapping_step` for the scan-based form this is verified
    against (tests/test_vectorized_equivalence.py).
    """
    g = state.graph
    thresh2 = cfg.same_cone_threshold * cfg.same_cone_threshold
    n = obs.shape[0]
    cap_l = g.lm_xy.shape[0]
    cap_e = g.obs_pose.shape[0]

    # Bootstrap (reference src/slam.cpp:554-567), as in the sequential path.
    glob_all, body_all, pay_a, pay_b = pre if pre is not None else \
        _associate_shared(state, obs, obs_valid, pose, cfg)
    boot = (g.n_landmarks == 0) & obs_valid[0]
    g = G.add_landmark(g, glob_all[0], obs[0, 3].astype(jnp.int32), enable=boot)
    g = G.add_observation(g, pose_idx, jnp.int32(0), body_all[0], enable=boot)

    otype = obs[:, 3].astype(jnp.int32)
    d2car = obs[:, 2]

    # --- phase A: association against the pre-frame map. The payload was
    # computed against the pre-bootstrap map; the bootstrap only writes
    # landmark slot 0 when the map was empty, so patch its matches (a fresh
    # landmark carries no information yet -> Euclidean gate).
    diff0 = glob_all - g.lm_xy[0][None, :]
    d2_col0 = jnp.sum(diff0 * diff0, axis=-1)
    if indexed:
        j, matched0 = pay_a, pay_b
        # boot: the map was empty pre-association, so every hit goes to slot 0
        hit0 = (boot & (d2_col0 < thresh2) & (g.lm_type[0] == otype)
                & obs_valid)
        j = jnp.where(hit0, 0, j)
        matched0 = matched0 | hit0
    else:
        cost_pre, gate = pay_a, pay_b
        cost_col0 = d2_col0 * (gate / thresh2)
        cost = jnp.where(boot, cost_pre.at[:, 0].set(cost_col0), cost_pre)
        ok = ((g.lm_type[None, :] == otype[:, None]) & g.lm_valid[None, :]
              & (cost < gate) & obs_valid[:, None])
        if cfg.association == "first":
            j = jnp.argmax(ok, axis=1).astype(jnp.int32)
        else:
            j = jnp.argmin(jnp.where(ok, cost, 1e30), axis=1).astype(jnp.int32)
        matched0 = jnp.any(ok, axis=1)

    # --- in-frame sequential state as prefix scans
    vals = jnp.where(matched0, d2car, jnp.inf)
    pm, pi = _prefix_argmin_exclusive(vals, jnp.arange(n, dtype=jnp.int32))
    cur_before = jnp.where(pm < 100.0, j[jnp.maximum(pi, 0)],
                           state.current_cone_index)

    dfirst2 = jnp.sum((g.lm_xy[j] - g.lm_xy[0]) ** 2, axis=-1)
    closure0 = (matched0 & (dfirst2 < cfg.loop_closure_radius ** 2)
                & (cur_before > cfg.loop_closure_min_index)
                & (d2car < cfg.cone_mapping_threshold))
    closed_before = state.loop_closing | \
        ((jnp.cumsum(closure0) - closure0.astype(jnp.int32)) > 0)
    closing = state.loop_closing | jnp.any(closure0)

    matched = matched0 & ~closed_before

    # --- phase B: new landmarks with in-frame duplicate merging
    cand = obs_valid & ~matched0 & ~closed_before & \
        (d2car < cfg.cone_mapping_threshold)
    gd = glob_all[:, None, :] - glob_all[None, :, :]
    gd2 = jnp.sum(gd * gd, axis=-1)
    lower = jnp.arange(n)[:, None] > jnp.arange(n)[None, :]   # k < i
    gsame = (otype[:, None] == otype[None, :]) & (gd2 < thresh2) & lower
    is_new = cand
    for _ in range(cfg.in_frame_dup_depth):
        # first-representative fixpoint; physical layouts have chain depth
        # <= 1 (duplicates of duplicates need cones packed within the gate)
        dup_of_new = jnp.any(gsame & is_new[None, :], axis=1)
        is_new = cand & ~dup_of_new
    rep_ok = gsame & is_new[None, :]
    rep = jnp.argmax(rep_ok, axis=1).astype(jnp.int32)
    is_dup = cand & jnp.any(rep_ok, axis=1)

    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - is_new.astype(jnp.int32)
    slot_self = g.n_landmarks + new_rank
    slot = jnp.where(is_new, slot_self, slot_self[rep])      # dup -> rep's slot
    slot_ok = slot < cap_l

    # landmark writes (disjoint slots; OOB dropped)
    scatter_to = jnp.where(is_new & slot_ok, slot, cap_l)
    g = dataclasses.replace(
        g,
        lm_xy=g.lm_xy.at[scatter_to].set(glob_all, mode="drop"),
        lm_type=g.lm_type.at[scatter_to].set(otype, mode="drop"),
        n_landmarks=jnp.minimum(g.n_landmarks + jnp.sum(is_new), cap_l),
    )

    # currentConeIndex: in the reference only *matches* update it; new-cone
    # insertions do not. Duplicate observations (two detections of one cone
    # in one frame) run the match branch sequentially, so fold them in.
    target = jnp.where(matched, j, slot)
    cur_cand = matched | (is_dup & slot_ok)
    vals_f = jnp.where(cur_cand, d2car, jnp.inf)
    best = jnp.argmin(vals_f)
    cur = jnp.where(vals_f[best] < 100.0, target[best], state.current_cone_index)

    # --- contiguous edge-block append (keeps reference insertion order)
    keep = matched | ((is_new | is_dup) & slot_ok)
    # stable keep-first permutation via rank arithmetic (a sort network for
    # this is ~10x the ops): pos[i] = destination of element i, perm = pos^-1
    keep_i = keep.astype(jnp.int32)
    n_keep = jnp.sum(keep_i)
    rank_keep = jnp.cumsum(keep_i) - keep_i
    rank_drop = jnp.cumsum(1 - keep_i) - (1 - keep_i)
    pos = jnp.where(keep, rank_keep, n_keep + rank_drop)
    perm = jnp.zeros((n,), jnp.int32).at[pos].set(jnp.arange(n, dtype=jnp.int32))
    base = jnp.minimum(g.n_obs, cap_e - n)
    g = dataclasses.replace(
        g,
        obs_pose=jax.lax.dynamic_update_slice(
            g.obs_pose, jnp.full((n,), pose_idx, jnp.int32), (base,)),
        obs_lm=jax.lax.dynamic_update_slice(g.obs_lm, target[perm], (base,)),
        obs_xy=jax.lax.dynamic_update_slice(g.obs_xy, body_all[perm], (base, 0)),
        n_obs=jnp.minimum(g.n_obs + jnp.sum(keep), cap_e),
    )

    do_opt = closing & ~state.loop_closure_complete
    if not defer_gn:
        # enable-gated (zero-trip) rather than lax.cond: a conditional
        # carrying the graph forces per-iteration copies inside scans
        g = gn.optimize(g, _gn_config(cfg), enable=do_opt)

    # accumulate per-landmark measurement information (Mahalanobis policy):
    # matched/duplicate observations add their R^-1 to the landmark's row;
    # new landmarks start with their first observation's information
    lm_info = state.lm_info_xy
    if cfg.association == "mahalanobis":
        # (the bootstrap landmark is re-matched by phase A, so its first
        # observation contributes through the `matched` term)
        info_obs = _obs_information(glob_all, pose, d2car, cfg)
        contributes = matched | ((is_new | is_dup) & slot_ok)
        idx = jnp.where(contributes, target, cap_l)
        lm_info = lm_info.at[idx].add(info_obs, mode="drop")

    pub_pose = pose
    if cfg.mapping_publish_refine:
        # published-pose MAP refine against the committed landmark rows
        # (matched rows only carry weight; creations would contribute
        # exactly-zero residuals). g.lm_xy[j] post-write equals the blocked
        # path's target_xy for the same rows. Gated until the FIRST periodic
        # refresh has run: refining against a never-optimized (odometry-
        # drifted) map measures worse than the raw publish (MIGRATION r4).
        ready = pose_idx >= cfg.periodic_gn_every
        ref = _publish_refine(pose, g.lm_xy[jnp.where(matched, j, 0)],
                              matched, body_all, cfg)
        pub_pose = jnp.where(ready, ref, pose)

    return dataclasses.replace(
        state, graph=g, current_cone_index=cur, loop_closing=closing,
        loop_closure_complete=state.loop_closure_complete | closing,
        lm_info_xy=lm_info,
    ), do_opt, pub_pose


def _mapping_step(state: SlamState, obs, obs_valid, pose, pose_idx,
                  cfg: SlamConfig, defer_gn: bool = False):
    """Reference-faithful mapping-mode update (src/slam.cpp:552-635)."""
    g = state.graph
    thresh2 = cfg.same_cone_threshold * cfg.same_cone_threshold

    # Bootstrap: empty map seeds landmark 0 from observation 0 *before* the
    # scan (src/slam.cpp:554-567) — the scan then re-matches it, giving the
    # first observation two edges exactly like the reference.
    glob0 = cone_to_global(pose, obs[0, 0], obs[0, 1], obs[0, 2],
                           cfg.lidar_to_cog, cfg.reference_compat)
    boot = (g.n_landmarks == 0) & obs_valid[0]
    g = G.add_landmark(g, glob0, obs[0, 3].astype(jnp.int32), enable=boot)
    g = G.add_observation(g, pose_idx, jnp.int32(0), _body_xy(obs[0], cfg), enable=boot)

    def body(carry, inp):
        g, cur_idx, min_dist, closing = carry
        ob, valid = inp
        glob = cone_to_global(pose, ob[0], ob[1], ob[2],
                              cfg.lidar_to_cog, cfg.reference_compat)
        dist2car = ob[2]
        ob_type = ob[3].astype(jnp.int32)

        d = g.lm_xy - glob
        d2 = jnp.sum(d * d, axis=-1)
        ok = ((g.lm_type == ob_type) & g.lm_valid & (d2 < thresh2)
              & valid & ~closing)
        if cfg.association == "first":
            j = jnp.argmax(ok).astype(jnp.int32)  # first index within gate
        else:
            j = jnp.argmin(jnp.where(ok, d2, 1e30)).astype(jnp.int32)
        matched = jnp.any(ok)

        meas = _body_xy(ob, cfg)
        g = G.add_observation(g, pose_idx, j, meas, enable=matched)

        # Loop-closure test BEFORE the current-index update, using the
        # pre-update index — reference src/slam.cpp:593 runs before :598.
        d_first = jnp.sum((g.lm_xy[j] - g.lm_xy[0]) ** 2)
        closure = (matched
                   & (d_first < cfg.loop_closure_radius ** 2)
                   & (cur_idx > cfg.loop_closure_min_index)
                   & (dist2car < cfg.cone_mapping_threshold))
        closing_next = closing | closure

        upd = matched & (dist2car < min_dist)
        cur_next = jnp.where(upd, j, cur_idx)
        min_next = jnp.where(upd, dist2car, min_dist)

        new_cone = (valid & ~matched & ~closing
                    & (dist2car < cfg.cone_mapping_threshold))
        slot = g.n_landmarks
        g = G.add_landmark(g, glob, ob_type, enable=new_cone)
        g = G.add_observation(g, pose_idx, slot, meas, enable=new_cone)
        return (g, cur_next, min_next, closing_next), None

    init = (g, state.current_cone_index, jnp.float32(100.0), state.loop_closing)
    (g, cur, _, closing), _ = jax.lax.scan(body, init, (obs, obs_valid))

    # One-shot closure: full GN re-optimization + map refresh, then freeze
    # (reference src/slam.cpp:625-633; it redundantly re-optimizes once per
    # remaining observation — converged after the first, so we run it once).
    do_opt = closing & ~state.loop_closure_complete
    if not defer_gn:
        g = gn.optimize(g, _gn_config(cfg), enable=do_opt)
    return dataclasses.replace(
        state, graph=g, current_cone_index=cur, loop_closing=closing,
        loop_closure_complete=state.loop_closure_complete | closing,
    ), do_opt


def _pose_refine(pose, g: G.FactorGraph, idx, matched, meas_xy, iters=3):
    """Pose-only GN against the frozen map (improvement over the reference,
    whose localization-mode optimize is disabled — src/slam.cpp:403)."""
    return _pose_refine_rows(pose, g.lm_xy[idx], matched, meas_xy, iters)


def _publish_refine(pose_meas, lm, matched, meas_xy, cfg: SlamConfig,
                    iters=3):
    """MAP estimate of the PUBLISHED pose (cfg.mapping_publish_refine):
    landmark-fixed GN over this frame's matched cone measurements plus the
    GPS/heading prior anchored at the measured pose. Output-only — graph
    state never sees it. The prior keeps the 3x3 system nonsingular, so no
    match-count branch is needed (zero matches = the measured pose back,
    exactly). This is what breaks the accuracy/cadence coupling: the
    periodic window GN refreshes the MAP on its own schedule while every
    frame's published pose is refined against it (r4; the alternative —
    firing the window GN every 8 frames — pays a fixed-lag solve per 8
    frames for the same online ATE mechanism)."""
    from tpuslam.backend.residuals import landmark_residuals
    dtype = pose_meas.dtype
    w = matched.astype(dtype) * jnp.asarray(cfg.publish_refine_obs_info,
                                            dtype)
    ixy = 1.0 / cfg.gps_prior_std ** 2
    ith = 1.0 / cfg.heading_prior_std ** 2
    prior_d = jnp.asarray([ixy, ixy, ith], dtype)

    def step(_, p):
        with jax.default_matmul_precision("highest"):
            pb = jnp.broadcast_to(p, lm.shape[:1] + (3,))
            r, j_p, _ = landmark_residuals(pb, lm, meas_xy)
            h = jnp.einsum("e,eki,ekj->ij", w, j_p, j_p) + jnp.diag(prior_d)
            dp = p - pose_meas
            dp = dp.at[2].set(se2.wrap_angle(dp[2]))
            b = jnp.einsum("e,eki,ek->i", w, j_p, r) + prior_d * dp
            delta = jnp.linalg.solve(h, -b)
        newp = p + delta
        return newp.at[2].set(se2.wrap_angle(newp[2]))

    return jax.lax.fori_loop(0, iters, step, pose_meas)


def _pose_refine_rows(pose, lm, matched, meas_xy, iters=3):
    """`_pose_refine` on pre-gathered landmark rows — the resident-map
    pipeline gathers its rows from the shards (parallel/resident_online.py)
    and must run the identical solve for bit-parity."""
    w = matched.astype(pose.dtype)

    def step(_, p):
        from tpuslam.backend.residuals import landmark_residuals
        with jax.default_matmul_precision("highest"):
            pb = jnp.broadcast_to(p, lm.shape[:1] + (3,))
            r, j_p, _ = landmark_residuals(pb, lm, meas_xy)
            h = jnp.einsum("e,eki,ekj->ij", w, j_p, j_p) + jnp.eye(3, dtype=pose.dtype) * 1e-6
            b = jnp.einsum("e,eki,ek->i", w, j_p, r)
            delta = jnp.linalg.solve(h, -b)
        newp = p + delta
        return newp.at[2].set(se2.wrap_angle(newp[2]))

    return jax.lax.cond(jnp.sum(w) >= 2, lambda p: jax.lax.fori_loop(0, iters, step, p),
                        lambda p: p, pose)


def _localization_step(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig,
                       pre=None, indexed: bool = False):
    """Localization mode against the frozen map (reference src/slam.cpp:340-414).

    Vectorized: the reference's first-match-in-index-order per observation and
    min-range current-cone tracking reproduce exactly without the scan.
    The reference's graph edges added here use a corrupted measurement (it
    passes the *pose* as the spherical measurement, src/slam.cpp:373) and its
    re-optimization is disabled, so those edges are dead weight — we do not
    add them; published results are identical.
    """
    g = state.graph
    _glob, body_all, pay_a, pay_b = pre if pre is not None else \
        _associate_shared(state, obs, obs_valid, pose, cfg)
    if indexed:
        j, matched = pay_a, pay_b   # sharded-provider semantics
    else:
        cost, gate = pay_a, pay_b
        if cfg.reference_compat and cfg.localizer_type_bug:
            type_ok = (g.lm_type[None, :].astype(jnp.float32)
                       - obs[:, 3][:, None]) < 1e-4  # signed compare, src/slam.cpp:360
        else:
            type_ok = g.lm_type[None, :] == obs[:, 3].astype(jnp.int32)[:, None]
        ok = type_ok & g.lm_valid[None, :] & obs_valid[:, None] & (cost < gate)
        j = jnp.argmax(ok, axis=1).astype(jnp.int32)   # first match per obs
        matched = jnp.any(ok, axis=1)

    dist2car = jnp.where(matched, obs[:, 2], 1e30)
    best = jnp.argmin(dist2car)
    any_match = jnp.any(matched)
    cur_new = jnp.where(any_match, j[best], state.current_cone_index)
    send_cones = cur_new != state.current_cone_index

    if cfg.localizer_refine:
        out_pose = _pose_refine(pose, g, j, matched, body_all)
    else:
        # reference publishes the latest vertex estimate, which is the
        # odometry pose just added (optimize disabled, src/slam.cpp:403-421)
        out_pose = pose
    return dataclasses.replace(state, current_cone_index=cur_new,
                               send_cone_data=send_cones), out_pose


def _cone_packet(state: SlamState, out_pose, cfg: SlamConfig):
    """Upcoming-cone egress (reference src/slam.cpp:656-679): the
    `cones_per_packet` map cones from current_cone_index, ring-wrapped."""
    g = state.graph
    k = jnp.arange(cfg.cones_per_packet)
    idx = state.current_cone_index + k
    n = jnp.maximum(g.n_landmarks, 1)
    idx = jnp.where(idx < n, idx, idx - n)     # single-wrap, as the reference
    idx = jnp.clip(idx, 0, n - 1)              # (guard the reference's OOB when n < packet)
    az, dist = global_to_body_spherical(out_pose, g.lm_xy[idx], cfg.reference_compat)
    return az, dist, g.lm_type[idx]


@partial(jax.jit, static_argnames=("cfg", "defer_gn", "assoc_mesh"),
         donate_argnames="state")
def perform_keyframe(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig,
                     defer_gn: bool = False, assoc_mesh=None):
    """Full keyframe update. obs [N,4] = (az_deg, zen_deg, dist, type).

    defer_gn=True skips the in-step GN conds and returns `wants_gn` in the
    outputs instead — for vmapped multi-session execution, where a batched
    lax.cond would otherwise run the optimizer's *both* branches every frame
    for every session. The caller triggers one batched GN on the (rare)
    frames where any session wants it (see tpuslam/parallel/batch.py).

    assoc_mesh (static, a jax.sharding.Mesh with an 'edges' axis): route
    data association through the landmark-sharded map-block provider — each
    device gates its map shard locally and a pmin reduction picks the global
    winner (tpuslam/parallel/map_blocks.py). Match decisions are exact vs
    the dense path; requires the landmark capacity to be a multiple of the
    axis size.
    """
    if cfg.association == "mahalanobis" and not cfg.vectorized_mapping:
        raise ValueError("mahalanobis association requires "
                         "vectorized_mapping=True (the scan-form mapping "
                         "step is the reference-faithful Euclidean path)")
    # GPS outlier guard (reference src/slam.cpp:300-303)
    ok_pose = (jnp.abs(pose[0]) <= cfg.gps_outlier_bound) & \
              (jnp.abs(pose[1]) <= cfg.gps_outlier_bound)
    n_valid = jnp.sum(obs_valid)

    def run(state):
        g = state.graph
        prev = g.poses[jnp.maximum(g.n_poses - 1, 0)]
        odo = jnp.where(g.n_poses > 0, se2.between(prev, pose), jnp.zeros(3, pose.dtype))
        prior = None
        if cfg.use_gps_prior:
            prior = (1.0 / cfg.gps_prior_std ** 2,
                     1.0 / cfg.heading_prior_std ** 2)
        g = G.add_pose(g, pose, odo, prior_info=prior)
        pose_idx = g.n_poses - 1
        state = dataclasses.replace(state, graph=g,
                                    keyframe_count=state.keyframe_count + 1)
        # association work shared by both branches (a vmapped cond runs both)
        pre = _associate_shared(state, obs, obs_valid, pose, cfg, assoc_mesh)
        indexed = assoc_mesh is not None

        def mapping(state):
            if cfg.vectorized_mapping:
                st, closed, pub = _mapping_step_vectorized(
                    state, obs, obs_valid, pose, pose_idx, cfg, defer_gn,
                    pre, indexed)
            else:
                if cfg.mapping_publish_refine:
                    raise ValueError("mapping_publish_refine requires "
                                     "vectorized_mapping=True")
                st, closed = _mapping_step(state, obs, obs_valid, pose,
                                           pose_idx, cfg, defer_gn)
                pub = pose
            out = pub if cfg.mapping_publish_refine else pose
            return st, out, closed, jnp.asarray(False)

        def localization(state):
            # reference requires >1 cones for a localization update
            # (src/slam.cpp:332)
            def loc(st):
                st2, out_pose = _localization_step(st, obs, obs_valid, pose,
                                                   cfg, pre, indexed)
                return st2, out_pose, jnp.asarray(False), jnp.asarray(True)

            def skip(st):
                return st, pose, jnp.asarray(False), jnp.asarray(False)

            return jax.lax.cond(n_valid > 1, loc, skip, state)

        state, out_pose, closed, send = jax.lax.cond(
            state.loop_closure_complete, localization, mapping, state)

        # Optional periodic re-optimization (improvement; off in compat):
        # fixed-lag pose refinement when periodic_gn_window > 0 (cheap,
        # scan/vmap-safe, so it runs inline even in defer mode), else the
        # full-batch re-optimize.
        wants_periodic = jnp.asarray(False)
        if cfg.periodic_gn_every > 0:
            do = (state.keyframe_count % cfg.periodic_gn_every == 0) & \
                 (state.graph.n_landmarks > 4)
            periodic_cfg = dataclasses.replace(
                _gn_config(cfg), iterations=cfg.periodic_gn_iterations)
            if cfg.periodic_gn_window > 0:
                new_g = gn.optimize_window(
                    state.graph, periodic_cfg, cfg.periodic_gn_window,
                    cfg.periodic_gn_edge_window, enable=do,
                    landmarks=cfg.periodic_gn_window_landmarks)
                state = dataclasses.replace(state, graph=new_g)
            elif defer_gn:
                wants_periodic = do
            else:
                new_g = gn.optimize(state.graph, periodic_cfg, enable=do)
                state = dataclasses.replace(state, graph=new_g)
        if cfg.use_gps_prior and not cfg.mapping_publish_refine:
            # mapping mode: publish the graph's latest pose (refreshed by the
            # periodic GN) instead of raw odometry. Localization mode keeps
            # the localizer-refined pose, which is strictly better. With
            # mapping_publish_refine the per-frame MAP refine already owns
            # the mapping-mode publication.
            use_graph = ~state.loop_closure_complete & (state.graph.n_landmarks > 4)
            out_pose = jnp.where(use_graph, state.graph.poses[pose_idx], out_pose)
        return state, out_pose, closed, send, wants_periodic

    def skip(state):
        return (state, pose, jnp.asarray(False), jnp.asarray(False),
                jnp.asarray(False))

    state, out_pose, closed, send, wants_periodic = jax.lax.cond(
        ok_pose, run, skip, state)
    az, dist, ctype = _cone_packet(state, out_pose, cfg)
    outputs = KeyframeOutputs(pose=out_pose, cone_azimuth=az, cone_distance=dist,
                              cone_type=ctype, send=send, loop_closed=closed,
                              n_landmarks=state.graph.n_landmarks)
    if defer_gn:
        # deferred mode: `closed` means the closure GN is WANTED, not run
        return state, outputs, closed, wants_periodic
    return state, outputs
