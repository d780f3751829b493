"""ONLINE pipeline with the landmark map physically sharded across a mesh.

VERDICT r3 missing #1 / next #3: `parallel/resident.py` made the *solver*
map-resident, but the live mapping state (`SlamState`) still carried full
`lm_xy/lm_type/lm_info` arrays on one device, so the flagship pipeline's map
capacity was bounded by one chip's HBM. This module removes that wall for
the blocked online pass itself:

- **Layout**: global landmark id g lives on device g // Lb, local slot
  g % Lb (contiguous blocks, so storage order == global creation order and
  every index-based reference semantic — the ring cone packet, the closure
  `currentConeIndex > 20` test, landmark-0 closure anchor, first-match
  tie-breaks — is untouched; reference src/slam.cpp:552-635, 656-679).
  Landmark balance across shards is by CAPACITY, not occupancy: the
  association cost block is computed on every slot (masked), so compute is
  balanced even while creation fills shard 0 first.
- **Association** runs shard-local ([BN, Lb] per device instead of
  [BN, D*Lb]) with a pmin winner reduction (min cost, ties to the smallest
  global index — exactly `jnp.argmin`'s first-minimum, the same lattice as
  parallel/map_blocks.py). Per-obs costs are elementwise, so shard-local
  values are bit-identical to the dense pipeline's.
- **Creation** keeps global creation order: each device scatter-writes the
  new landmarks whose global slot falls in its range. The per-obs decision
  logic (in-block duplicates, representatives, closure prefixes) is [BN]-
  sized and replicated — identical code to the dense pass
  (`frontend/blocked._inblock_duplicates` is imported, not copied).
- **Solves**: the one-shot closure GN and the fixed-lag periodic window GN
  run with landmark blocks eliminated shard-locally (each landmark's edges
  are weighted only on its owner, Hll/W columns [.., Lb] local) and one
  psum'd reduced pose system — nothing O(L) on the wire, no device ever
  materializes a full landmark array inside the pass.

Per-device landmark memory: O(L/D) for lm_xy/lm_type/lm_info; pose/edge
arrays stay replicated (they are O(P + E), independent of map size — the
thing that outgrows a chip at pod scale is the fused multi-session MAP).

Equivalence: bit-parity of all published outputs and the final map with
`frontend.blocked.blocked_core` on supported configs, up to f32 reduction
order inside the solves (tests/test_resident_online.py). Capacity/bootstrap
fallbacks report `done_upto` exactly like the dense core; the host wrapper
finishes per-frame on the gathered map (correctness escape hatch — never
taken on a healthy lap).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tpuslam.backend import gauss_newton as gn
from tpuslam.backend import graph as G
from tpuslam.frontend.blocked import (
    _compact_observations, _exclusive_from_inclusive, _inblock_duplicates,
    _last_valid_inclusive, _pose_insert_plan, _scatter_poses, _select_state,
)
from tpuslam.frontend.blocked import _midblock_gn
from tpuslam.frontend.keyframe import (
    KeyframeOutputs, _body_xy, _gate_cost, _gn_config, _obs_information,
    _pose_refine_rows, _prefix_argmin_exclusive, _publish_refine,
)
from tpuslam.frontend.state import SlamState, initial_state
from tpuslam.geometry import se2
from tpuslam.geometry.spherical import cone_to_global, global_to_body_spherical
from tpuslam.runtime.config import SlamConfig

__all__ = ["resident_online_supported", "run_pass_resident_online",
           "resident_online_core", "initial_shards"]

_BIG = 1e30
_IMAX = jnp.iinfo(jnp.int32).max


def resident_online_supported(cfg: SlamConfig, block: int = 16) -> bool:
    """Configs the resident online pass reproduces: the blocked contract
    (frontend.blocked.blocked_supported), plus periodic GN must be
    fixed-lag (the full-batch periodic re-optimize is a dense-map
    construct)."""
    return (cfg.association in ("first", "nearest", "mahalanobis")
            and cfg.vectorized_mapping
            and (cfg.periodic_gn_every == 0
                 or ((cfg.periodic_gn_every % block == 0
                      or _midblock_gn(cfg, block))
                     and cfg.periodic_gn_window > 0
                     and cfg.periodic_gn_window_landmarks)))


def initial_shards(L_global: int):
    """Fresh (lm_xy [L,2], lm_type [L], lm_info [L,3]) global arrays; shard
    with NamedSharding(mesh, P('map')) or let shard_map split them."""
    return (jnp.zeros((L_global, 2), jnp.float32),
            jnp.zeros((L_global,), jnp.int32),
            jnp.zeros((L_global, 3), jnp.float32))


def _gather_lm(gidx, base, Lb, axis, *arrs):
    """Replicated global-id gather from the local shard: rows owned by this
    device contribute, ONE tupled psum sums the one-hot parts of every
    array at once (the pass is collective-LATENCY bound at scale —
    SCALING_r04 online_frontend — so k arrays must not cost k launches).
    Integer arrays are carried as f32 through the psum (values are landmark
    types/ids, exact far below 2^24): XLA's all-reduce combiner only merges
    all-reduces with an IDENTICAL reduction computation, so an s32 add next
    to an f32 add would stay TWO launches (measured in the compiled HLO,
    r5). gidx values >= L or < 0 return zero rows."""
    loc = gidx - base
    own = (loc >= 0) & (loc < Lb)
    locc = jnp.clip(loc, 0, Lb - 1)
    dtypes = [a.dtype for a in arrs]
    parts = tuple(
        jnp.where(own.reshape(own.shape + (1,) * (a.ndim - 1)),
                  a[locc], jnp.zeros((), a.dtype)).astype(jnp.float32)
        for a in arrs)
    summed = jax.lax.psum(parts, axis)
    return [s.astype(dt) for s, dt in zip(summed, dtypes)]


def _local_scatter_to(gidx, enable, base, Lb):
    """Global scatter targets -> local slots (drop rows not owned here)."""
    loc = gidx - base
    sel = enable & (loc >= 0) & (loc < Lb)
    return jnp.where(sel, loc, Lb)


def _associate_resident(glob_k, otype_k, valid_k, lm_xy_l, lm_type_l,
                        lm_info_l, n_landmarks, base, Lb, cfg: SlamConfig,
                        axis, type_signed_bug=False, force_first=False,
                        need_cost=True):
    """Phase-A association against the sharded map: shard-local [BN, Lb]
    gating + pmin winner. Returns (j_snap global, snap_match, cost, gate);
    cost is in gate units (inf where unmatched). Bit-identical winners to
    the dense [BN, L] argmin/argmax (per-pair costs are elementwise; ties
    resolve to the smallest global index). `force_first` selects the
    first-match policy regardless of cfg.association (the localizer's
    semantics, reference src/slam.cpp:350-383)."""
    gid = base + jnp.arange(Lb)
    lm_valid = gid < n_landmarks
    diff = glob_k[:, None, :] - lm_xy_l[None, :, :]
    d2m = jnp.sum(diff * diff, axis=-1)
    cost, gate = _gate_cost(diff, d2m, lm_info_l, cfg)
    if type_signed_bug:
        type_ok = (lm_type_l[None, :].astype(jnp.float32)
                   - otype_k[:, None].astype(jnp.float32)) < 1e-4
    else:
        type_ok = lm_type_l[None, :] == otype_k[:, None]
    ok = type_ok & lm_valid[None, :] & (cost < gate) & valid_k[:, None]
    if cfg.association == "first" or force_first:
        # global FIRST hit = smallest global index with a hit
        key = jnp.where(jnp.any(ok, axis=1),
                        base + jnp.argmax(ok, axis=1), _IMAX)
        sel = jax.lax.pmin(key, axis)
        matched = sel < _IMAX
        if not need_cost:
            # both first-policy callers (mapping with association='first',
            # the localizer) discard the cost — skip its collective (the
            # pass is latency-bound at scale, SCALING_r04 online_frontend)
            return (sel.astype(jnp.int32), matched,
                    jnp.where(matched, 0.0, jnp.inf), gate)
        cost_sel = jax.lax.pmin(
            jnp.where((key == sel) & matched,
                      jnp.take_along_axis(
                          cost, jnp.argmax(ok, axis=1)[:, None], 1)[:, 0],
                      _BIG), axis)
        cost_out = jnp.where(matched, cost_sel, jnp.inf)
        return sel.astype(jnp.int32), matched, cost_out, gate
    cloc = jnp.where(ok, cost, _BIG)
    lmin = jnp.min(cloc, axis=1)
    gmin = jax.lax.pmin(lmin, axis)
    matched = gmin < _BIG
    cand = jnp.where(ok & (cloc == gmin[:, None]),
                     jnp.broadcast_to(gid[None, :], cloc.shape), _IMAX)
    sel = jax.lax.pmin(jnp.min(cand, axis=1), axis)
    j = jnp.where(matched, sel, 0).astype(jnp.int32)
    return j, matched, jnp.where(matched, gmin, jnp.inf), gate


def _ring_idx(n_lm_after, cur_after, cones: int):
    """Ring-packet global landmark ids [B, cones] (reference ring wrap
    src/slam.cpp:667 on GLOBAL ids)."""
    k = jnp.arange(cones)
    idx = cur_after[:, None] + k[None, :]
    n = jnp.maximum(n_lm_after, 1)[:, None]
    idx = jnp.where(idx < n, idx, idx - n)
    return jnp.clip(idx, 0, n - 1)


def _packet_gather_resident(lm_xy_l, lm_type_l, base, Lb, axis, n_lm_after,
                            cur_after, cfg: SlamConfig, extra_xy_idx=None):
    """Ring-packet rows gathered from the shards. `extra_xy_idx` [M]: extra
    global landmark ids whose xy rows ride the SAME psum launch (the
    localizer-refine rows — the pass is collective-latency bound at scale,
    SCALING_r04 online_frontend — one launch instead of two); returned as
    a third output [M, 2]."""
    idx = _ring_idx(n_lm_after, cur_after, cfg.cones_per_packet)
    if extra_xy_idx is not None:
        flat = jnp.concatenate([idx.reshape(-1), extra_xy_idx])
        xy_all, ty_all = _gather_lm(flat, base, Lb, axis, lm_xy_l,
                                    lm_type_l)
        m = idx.size
        return (xy_all[:m].reshape(idx.shape + (2,)),
                ty_all[:m].reshape(idx.shape), xy_all[m:])
    xy, ty = _gather_lm(idx, base, Lb, axis, lm_xy_l, lm_type_l)
    return xy, ty, None


def _packet_series_resident(lm_xy_l, lm_type_l, base, Lb, axis, n_lm_after,
                            cur_after, out_pose, cfg: SlamConfig):
    """`frontend.blocked._packet_series` against the sharded map."""
    xy, ty, _ = _packet_gather_resident(lm_xy_l, lm_type_l, base, Lb, axis,
                                        n_lm_after, cur_after, cfg)
    az, dist = global_to_body_spherical(out_pose[:, None, :], xy,
                                        cfg.reference_compat)
    return az, dist, ty


def _mapping_block_resident(state: SlamState, lm_xy_l, lm_type_l, lm_info_l,
                            obs, valid, poses, okp, cfg: SlamConfig,
                            L_glob: int, axis: str, boot_ok=None,
                            overflow=None, defer_packets: bool = False):
    """`frontend.blocked._mapping_block` with the landmark state sharded
    (state.graph carries the REPLICATED pose/edge arrays + global counters;
    lm shards are explicit). Same per-obs decision sequence — the [BN]
    machinery is shared code, only the [L]-touching steps go through the
    shard helpers. Returns (new_state, lm shards, outputs [B], aux).

    `defer_packets` (static; only sound when NO in-scan GN moves landmark
    positions, i.e. periodic_gn_every == 0): skip the per-block ring-packet
    gather launch and return the ring ids in aux['pkt_idx'] instead — the
    caller gathers ALL mapping frames' rows in ONE post-scan launch against
    the (immutable through scan-1) positions. Values are identical; the
    per-lap collective-launch count drops by one per block (the pass is
    latency-bound at scale — VERDICT r4 next #5)."""
    g0 = state.graph
    B, N = valid.shape
    BN = B * N
    Lb = lm_xy_l.shape[0]
    base = jax.lax.axis_index(axis) * Lb
    cap_e = g0.obs_pose.shape[0]
    cap_p = g0.poses.shape[0]
    thresh2 = cfg.same_cone_threshold * cfg.same_cone_threshold
    n_poses0, n_obs0, n_lm0 = g0.n_poses, g0.n_obs, g0.n_landmarks

    pose_idx_f, n_pose_after, odo_f = _pose_insert_plan(g0, poses, okp)
    g = g0

    frame_of = jnp.repeat(jnp.arange(B, dtype=jnp.int32), N)
    fidx = jnp.arange(B, dtype=jnp.int32)
    valid_k = (valid & okp[:, None]).reshape(BN)
    obs_k = obs.reshape(BN, 4)
    glob_k = jax.vmap(lambda p, ob: cone_to_global(
        p, ob[..., 0], ob[..., 1], ob[..., 2], cfg.lidar_to_cog,
        cfg.reference_compat))(poses, obs).reshape(BN, 2)
    body_k = _body_xy(obs, cfg).reshape(BN, 2)
    otype_k = obs_k[:, 3].astype(jnp.int32)
    d2car_k = obs_k[:, 2]

    # ---- bootstrap (src/slam.cpp:554-567): global slot 0 lives on shard 0
    boot0 = valid[0, 0] if boot_ok is None else boot_ok[0]
    boot = (n_lm0 == 0) & boot0 & okp[0]
    bto = _local_scatter_to(jnp.zeros((1,), jnp.int32), boot[None], base, Lb)
    lm_xy_l = lm_xy_l.at[bto].set(glob_k[0][None], mode="drop")
    lm_type_l = lm_type_l.at[bto].set(otype_k[0][None], mode="drop")
    g = dataclasses.replace(
        g, n_landmarks=n_lm0 + boot.astype(jnp.int32))
    g = G.add_observation(g, pose_idx_f[0], jnp.int32(0), body_k[0],
                          enable=boot)

    # ---- phase A against the block-start (post-boot) sharded map
    j_snap, snap_match, cost_snap, gate = _associate_resident(
        glob_k, otype_k, valid_k, lm_xy_l, lm_type_l, lm_info_l,
        g.n_landmarks, base, Lb, cfg, axis,
        need_cost=cfg.association != "first")
    # one launch gathers both the snap rows and the closure anchor
    # (global slot 0) — both read the same post-boot shard state
    (snap_and_0,) = _gather_lm(
        jnp.concatenate([j_snap, jnp.zeros((1,), jnp.int32)]), base, Lb,
        axis, lm_xy_l)
    snap_xy, lm0 = snap_and_0[:BN], snap_and_0[BN:]

    # ---- in-block creations + duplicate representatives (replicated [BN]
    # machinery — the exact dense-pass code)
    cand = valid_k & ~snap_match & (d2car_k < cfg.cone_mapping_threshold)
    is_new, use_ib, dup_same, rep_prev, rep_same, prev_any, matched_pf = \
        _inblock_duplicates(glob_k, otype_k, frame_of, cand, snap_match,
                            cost_snap if cfg.association != "first"
                            else None, thresh2, gate, cfg, N)

    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - is_new.astype(jnp.int32)
    slot_self = g.n_landmarks + new_rank
    row_rep = jnp.where(use_ib, rep_prev,
                        jnp.where(dup_same, rep_same,
                                  jnp.arange(BN, dtype=jnp.int32)))
    slot = jnp.where(is_new, slot_self, slot_self[row_rep])
    slot_ok = slot < L_glob
    target = jnp.where(matched_pf & ~use_ib, j_snap, slot)
    target_xy = jnp.where((matched_pf & ~use_ib)[:, None],
                          snap_xy, glob_k[row_rep])

    # ---- exact loop-closure detection (src/slam.cpp:593-596); landmark 0
    # is the closure anchor — gathered once from shard 0
    target_f = target.reshape(B, N)
    vals_cl = jnp.where(matched_pf, d2car_k, jnp.inf).reshape(B, N)
    pm_cl, pi_cl = jax.vmap(_prefix_argmin_exclusive, in_axes=(0, None))(
        vals_cl, jnp.arange(N, dtype=jnp.int32))
    cur_cand_uns = matched_pf | (dup_same & slot_ok)
    vals_uns = jnp.where(cur_cand_uns, d2car_k, jnp.inf).reshape(B, N)
    fsel_uns = target_f[jnp.arange(B), jnp.argmin(vals_uns, axis=1)]
    cur_after_uns = _last_valid_inclusive(
        state.current_cone_index, jnp.min(vals_uns, axis=1) < 100.0, fsel_uns)
    cur_start_uns = _exclusive_from_inclusive(cur_after_uns,
                                              state.current_cone_index)
    in_frame_tgt = target_f[frame_of, jnp.maximum(pi_cl.reshape(BN), 0)]
    cur_before = jnp.where(pm_cl.reshape(BN) < 100.0, in_frame_tgt,
                           cur_start_uns[frame_of])
    dfirst2 = jnp.sum((target_xy - lm0[0]) ** 2, axis=-1)
    closure0 = (matched_pf & (dfirst2 < cfg.loop_closure_radius ** 2)
                & (cur_before > cfg.loop_closure_min_index)
                & (d2car_k < cfg.cone_mapping_threshold))
    closure_any = jnp.any(closure0)
    kc_obs = jnp.argmax(closure0).astype(jnp.int32)
    kc_frame = jnp.where(closure_any, frame_of[kc_obs], jnp.int32(B))
    closed_before = closure_any & (jnp.arange(BN) > kc_obs)

    matched = matched_pf & ~closed_before
    is_new_s = is_new & ~closed_before
    dup_same_s = dup_same & ~closed_before

    ins = okp & (fidx <= kc_frame)
    g = _scatter_poses(g, poses, odo_f, pose_idx_f, ins, cfg)

    # ---- landmark writes: disjoint GLOBAL slots, each shard takes its own
    lto = _local_scatter_to(slot, is_new_s & slot_ok, base, Lb)
    n_new_per_frame = jnp.sum(is_new_s.reshape(B, N), axis=1)
    n_lm_after = jnp.minimum(g.n_landmarks + jnp.cumsum(n_new_per_frame),
                             L_glob)
    n_new_total = jnp.sum(is_new_s)
    lm_xy_l = lm_xy_l.at[lto].set(glob_k, mode="drop")
    lm_type_l = lm_type_l.at[lto].set(otype_k, mode="drop")
    g = dataclasses.replace(
        g, n_landmarks=jnp.minimum(g.n_landmarks + n_new_total, L_glob))

    # ---- contiguous edge append (edge arrays replicated, global lm ids);
    # kept-first stable argsort = the permutation (see frontend/blocked.py)
    keep = matched | ((is_new_s | dup_same_s) & slot_ok)
    n_keep = jnp.sum(keep.astype(jnp.int32))
    perm = jnp.argsort(~keep, stable=True).astype(jnp.int32)
    base_e = jnp.minimum(g.n_obs, cap_e - BN)
    pose_idx_k = pose_idx_f[frame_of]
    g = dataclasses.replace(
        g,
        obs_pose=jax.lax.dynamic_update_slice(g.obs_pose, pose_idx_k[perm],
                                              (base_e,)),
        obs_lm=jax.lax.dynamic_update_slice(g.obs_lm, target[perm],
                                            (base_e,)),
        obs_xy=jax.lax.dynamic_update_slice(g.obs_xy, body_k[perm],
                                            (base_e, 0)),
        n_obs=jnp.minimum(g.n_obs + n_keep, cap_e),
    )

    # ---- per-landmark information accumulation (mahalanobis), shard-local
    if cfg.association == "mahalanobis":
        pose_bn = poses[frame_of]
        info_obs = jax.vmap(
            lambda gl_, po, di: _obs_information(gl_, po, di, cfg))(
            glob_k, pose_bn, d2car_k)
        ito = _local_scatter_to(target, keep, base, Lb)
        lm_info_l = lm_info_l.at[ito].add(info_obs, mode="drop")

    # ---- committed currentConeIndex series + packets
    cur_cand = matched | (dup_same_s & slot_ok)
    vals_cur = jnp.where(cur_cand, d2car_k, jnp.inf).reshape(B, N)
    fsel = target_f[jnp.arange(B), jnp.argmin(vals_cur, axis=1)]
    cur_after = _last_valid_inclusive(state.current_cone_index,
                                      jnp.min(vals_cur, axis=1) < 100.0, fsel)
    out_pose = poses
    if cfg.mapping_publish_refine:
        # published-pose MAP refine (keyframe._publish_refine) — target_xy
        # was already assembled from the shards, so the refine itself is
        # shard-free replicated compute
        ref = jax.vmap(
            lambda p, l, mm, z: _publish_refine(p, l, mm, z, cfg))(
            poses, target_xy.reshape(B, N, 2), matched.reshape(B, N),
            body_k.reshape(B, N, 2))
        ready = pose_idx_f >= cfg.periodic_gn_every   # first refresh ran
        out_pose = jnp.where(ready[:, None], ref, poses)
    pkt_idx = None
    if defer_packets:
        pkt_idx = _ring_idx(n_lm_after, cur_after, cfg.cones_per_packet)
        az = dist = jnp.zeros((B, cfg.cones_per_packet))
        ctype = jnp.zeros((B, cfg.cones_per_packet), jnp.int32)
    else:
        az, dist, ctype = _packet_series_resident(
            lm_xy_l, lm_type_l, base, Lb, axis, n_lm_after, cur_after,
            out_pose, cfg)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype,
        send=jnp.zeros((B,), bool),
        loop_closed=closure_any & (fidx == kc_frame),
        n_landmarks=n_lm_after.astype(jnp.int32),
    )
    new_state = dataclasses.replace(
        state, graph=g,
        current_cone_index=cur_after[-1],
        loop_closing=state.loop_closing | closure_any,
        loop_closure_complete=state.loop_closure_complete | closure_any,
        keyframe_count=state.keyframe_count + jnp.sum(ins.astype(jnp.int32)),
    )

    any_act = jnp.any(okp)
    fallback = (((n_lm0 == 0) & ~boot & jnp.any(valid_k))
                | ((n_poses0 + B > cap_p) & any_act)
                | ((n_obs0 + 1 + BN > cap_e) & any_act)
                | (n_lm0 + boot.astype(jnp.int32) + n_new_total > L_glob))
    if overflow is not None:
        fallback = fallback | jnp.any(overflow & okp)
    # per-frame committed pose / edge counts (mid-block window-GN firings —
    # see frontend.blocked._midblock_gn)
    n_pose_series = n_poses0 + jnp.cumsum(ins.astype(jnp.int32))
    keep_pf = jnp.sum(keep.reshape(B, N).astype(jnp.int32), axis=1)
    n_obs_series = jnp.minimum(
        n_obs0 + boot.astype(jnp.int32) + jnp.cumsum(keep_pf), cap_e)
    aux = dict(closure_any=closure_any, kc_frame=kc_frame, fallback=fallback,
               cur_series=cur_after, n_lm_series=n_lm_after, ins=ins,
               n_pose_series=n_pose_series, n_obs_series=n_obs_series,
               pkt_idx=pkt_idx,
               pub_rows=((target_f, matched.reshape(B, N))
                         if cfg.mapping_publish_refine else None))
    return new_state, lm_xy_l, lm_type_l, lm_info_l, outputs, aux


def _loc_block_resident(state: SlamState, lm_xy_l, lm_type_l, lm_info_l,
                        obs, valid, poses, okp, cfg: SlamConfig,
                        L_glob: int, axis: str, overflow=None,
                        defer_packets: bool = False):
    """`frontend.blocked._loc_block` against the frozen sharded map.

    `defer_packets` (static; sound when the map is frozen through scan-2:
    periodic_gn_every == 0, and localizer refine off — the refine needs
    its rows in-block): skip the ring gather, return ids in
    aux['pkt_idx'] (see _mapping_block_resident)."""
    g0 = state.graph
    B, N = valid.shape
    BN = B * N
    Lb = lm_xy_l.shape[0]
    base = jax.lax.axis_index(axis) * Lb

    pose_idx_f, _, odo_f = _pose_insert_plan(g0, poses, okp)
    g = _scatter_poses(g0, poses, odo_f, pose_idx_f, okp, cfg)

    n_valid_f = jnp.sum(valid & okp[:, None], axis=1)
    ran = okp & (n_valid_f > 1)                  # src/slam.cpp:332

    glob_k = jax.vmap(lambda p, ob: cone_to_global(
        p, ob[..., 0], ob[..., 1], ob[..., 2], cfg.lidar_to_cog,
        cfg.reference_compat))(poses, obs).reshape(BN, 2)
    body_k = _body_xy(obs, cfg).reshape(BN, 2)
    obs_k = obs.reshape(BN, 4)
    vloc_k = (valid & ran[:, None]).reshape(BN)

    # localization mode is ALWAYS first-match-in-index-order (the dense
    # _loc_block's argmax over the gate mask, reference src/slam.cpp:350-383)
    bug = cfg.reference_compat and cfg.localizer_type_bug
    j, matched, _c, _gate = _associate_resident(
        glob_k, obs_k[:, 3].astype(jnp.int32), vloc_k, lm_xy_l, lm_type_l,
        lm_info_l, g.n_landmarks, base, Lb, cfg, axis, type_signed_bug=bug,
        force_first=True, need_cost=False)

    d2 = jnp.where(matched, obs_k[:, 2], _BIG).reshape(B, N)
    best = jnp.argmin(d2, axis=1)
    any_m = jnp.any(matched.reshape(B, N), axis=1)
    j_best = j.reshape(B, N)[jnp.arange(B), best]

    cur_after = _last_valid_inclusive(state.current_cone_index, ran & any_m,
                                      j_best)
    cur_start = _exclusive_from_inclusive(cur_after,
                                          state.current_cone_index)
    cur_changed = ran & (cur_after != cur_start)
    send_state = _last_valid_inclusive(state.send_cone_data, ran,
                                       cur_changed)[-1]

    # ONE gather launch serves both the ring packets and (when enabled)
    # the localizer-refine rows — the frozen map doesn't change in between
    n_lm = jnp.broadcast_to(g.n_landmarks, (B,))
    pkt_idx = None
    if defer_packets:
        assert not cfg.localizer_refine, \
            "defer_packets needs the refine rows deferred too"
        pkt_idx = _ring_idx(n_lm, cur_after, cfg.cones_per_packet)
        ring_xy = jnp.zeros((B, cfg.cones_per_packet, 2))
        ctype = jnp.zeros((B, cfg.cones_per_packet), jnp.int32)
        out_pose = poses
    else:
        ring_xy, ctype, lm_rows = _packet_gather_resident(
            lm_xy_l, lm_type_l, base, Lb, axis, n_lm, cur_after, cfg,
            extra_xy_idx=j if cfg.localizer_refine else None)
        if cfg.localizer_refine:
            out_pose = jax.lax.map(
                lambda a: _pose_refine_rows(a[0], a[1], a[2], a[3]),
                (poses, lm_rows.reshape(B, N, 2), matched.reshape(B, N),
                 body_k.reshape(B, N, 2)))
            out_pose = jnp.where(ran[:, None], out_pose, poses)
        else:
            out_pose = poses

    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[-1],
        send_cone_data=send_state,
        keyframe_count=state.keyframe_count + jnp.sum(okp.astype(jnp.int32)),
    )
    az, dist = global_to_body_spherical(out_pose[:, None, :], ring_xy,
                                        cfg.reference_compat)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype,
        send=ran, loop_closed=jnp.zeros((B,), bool),
        n_landmarks=n_lm.astype(jnp.int32),
    )
    fallback = (g0.n_poses + B > g0.poses.shape[0]) & jnp.any(okp)
    if overflow is not None:
        fallback = fallback | jnp.any(overflow & okp)
    aux = dict(fallback=fallback, cur_series=cur_after, okp=okp,
               pkt_idx=pkt_idx)
    return new_state, outputs, aux


# ---------------------------------------------------------------------------
# sharded-landmark Gauss-Newton (closure + fixed-lag window)
# ---------------------------------------------------------------------------

def _gn_step_sharded(g: G.FactorGraph, lm_xy_l, cfg: gn.GNConfig,
                     L_glob: int, base, axis: str):
    """One GN iteration with landmark blocks eliminated shard-locally:
    mirrors `gn.gn_step` (same gauge, same Schur algebra) with W/Hll/gl
    restricted to the shard's columns and ONE [3P, 3P] + [P-sized] psum.
    Landmark updates stay local. f32-reduction-order equal to the dense
    solve."""
    Lb = lm_xy_l.shape[0]
    P_ = g.poses.shape[0]
    dtype = g.poses.dtype
    with jax.default_matmul_precision(cfg.matmul_precision):
        h_diag, h_off, gp = gn.assemble_odometry(g, cfg)
        own = (g.obs_lm >= base) & (g.obs_lm < base + Lb)
        w_l = (jnp.asarray(cfg.lm_info, dtype)
               * g.obs_valid.astype(dtype) * own.astype(dtype))
        local_ol = jnp.clip(g.obs_lm - base, 0, Lb - 1)
        h_diag_lm, w0, w1, hll, gp_lm, gl = gn._landmark_edge_blocks_split(
            g.poses, lm_xy_l, g.obs_pose, local_ol, g.obs_xy, w_l, Lb)

        # gauge (mirror _apply_gauge_blocked; landmark side by GLOBAL id).
        # The landmark-side masks and the elimination below use only
        # shard-LOCAL data, so the Hpp-row contributions and the eliminated
        # reduced system ride ONE tupled psum launch (the pass is
        # collective-latency bound — VERDICT r4 next #5); the pose-side
        # gauge applies after the sum (elementwise mask, order-identical).
        kp = jnp.arange(P_)
        free_pose = (kp >= cfg.fix_first_poses) & (kp < g.n_poses)
        gid = base + jnp.arange(Lb)
        free_lm = (gid >= cfg.fix_first_landmarks) & (gid < g.n_landmarks)
        fpb = free_pose.astype(dtype)[:, None, None]
        eye3 = jnp.eye(3, dtype=dtype)
        pair = free_pose & jnp.roll(free_pose, 1)
        pair = pair.at[0].set(False)
        h_off = h_off * pair.astype(dtype)[:, None, None]
        fp = jnp.repeat(free_pose.astype(dtype), 3)
        fl = free_lm.astype(dtype)
        w0 = w0 * fp[:, None] * fl[None, :]
        w1 = w1 * fp[:, None] * fl[None, :]
        eye2 = jnp.eye(2, dtype=dtype)
        flb = fl[:, None, None]
        hll = hll * flb + eye2 * (1.0 - flb)
        gl = gl * fl[:, None]
        if cfg.damping:
            hll = hll + eye2 * jnp.asarray(cfg.damping, dtype) * flb

        # Schur: local landmark elimination. The clamped rows' identity
        # Hll blocks would each contribute -wa@w^T = 0 (w columns are
        # zeroed), so locality is exact.
        hll_inv = gn._inv2x2(hll)
        ia, ib, ic = hll_inv[:, 0, 0], hll_inv[:, 0, 1], hll_inv[:, 1, 1]
        wa0 = w0 * ia[None, :] + w1 * ib[None, :]
        wa1 = w0 * ib[None, :] + w1 * ic[None, :]
        gl0, gl1 = gl[:, 0], gl[:, 1]
        s_part = wa0 @ w0.T + wa1 @ w1.T                 # [3P, 3P]
        r_part = wa0 @ gl0 + wa1 @ gl1                   # [3P]
        h_diag_lm, gp_lm, s_red, r_red = jax.lax.psum(
            (h_diag_lm, gp_lm, s_part, r_part), axis)
        h_diag = h_diag + h_diag_lm
        gp = gp + gp_lm
        h_diag = h_diag * fpb + eye3 * (1.0 - fpb)
        gp = gp * free_pose.astype(dtype)[:, None]
        if cfg.damping:
            h_diag = h_diag + eye3 * jnp.asarray(cfg.damping, dtype) * fpb
        hpp = gn.densify_hpp(h_diag, h_off)
        s = hpp - s_red
        rhs = -gp.reshape(-1) + r_red
        c = jnp.linalg.cholesky(s)
        dp = jax.scipy.linalg.cho_solve((c, True), rhs)
        r0 = gl0 + w0.T @ dp
        r1 = gl1 + w1.T @ dp
        dl = -jnp.stack([ia * r0 + ib * r1, ib * r0 + ic * r1], axis=-1)
    d_pose = dp.reshape(-1, 3)
    poses = g.poses + d_pose
    act = jnp.arange(poses.shape[0]) < g.n_poses
    poses = poses.at[:, 2].set(
        jnp.where(act, se2.wrap_angle(poses[:, 2]), poses[:, 2]))
    return dataclasses.replace(g, poses=poses), lm_xy_l + dl


def _optimize_sharded(g: G.FactorGraph, lm_xy_l, cfg: gn.GNConfig,
                      L_glob: int, base, axis: str, enable=None):
    """`gn.optimize`'s loop shell around `_gn_step_sharded` (early exit on
    the GLOBAL max |update| via pmax, so all shards agree on trip count).

    The convergence check runs every SECOND iteration (pairs of gated GN
    steps per while trip): the pmax is a separate scalar all-reduce launch
    next to the step's tupled psum (different reduction computation — the
    combiner can't merge them), and the pass is collective-latency bound
    (VERDICT r4 next #5). Pair-stepping halves the pmax count; exit is
    still conservative (never skips a needed iteration — it can only run
    one extra step past convergence, which by the early-exit contract
    moves the estimate by less than the tolerance). The second step of a
    pair is gated on the remaining iteration budget so odd caps run
    exactly `iterations` steps."""
    iters = jnp.int32(cfg.iterations)
    if enable is not None:
        iters = jnp.where(enable, iters, 0)
    tol = jnp.asarray(cfg.early_exit_tol, g.poses.dtype) \
        if cfg.early_exit_tol > 0.0 else jnp.asarray(-jnp.inf, g.poses.dtype)

    def cond(carry):
        _, _, i, delta = carry
        return (i < iters) & (delta > tol)

    def body(carry):
        gg, lml, i, _ = carry
        g2, lm2 = _gn_step_sharded(gg, lml, cfg, L_glob, base, axis)
        steps = jnp.int32(1)
        if cfg.iterations > 1:      # pair-step (static): see docstring
            second = (i + 1) < iters
            g3, lm3 = _gn_step_sharded(g2, lm2, cfg, L_glob, base, axis)
            g2 = jax.tree.map(lambda a, b: jnp.where(second, a, b), g3, g2)
            lm2 = jnp.where(second, lm3, lm2)
            steps = steps + second.astype(jnp.int32)
        delta = jnp.maximum(jnp.max(jnp.abs(g2.poses - gg.poses)),
                            jax.lax.pmax(jnp.max(jnp.abs(lm2 - lml)), axis))
        return g2, lm2, i + steps, delta

    g_out, lm_out, _, _ = jax.lax.while_loop(
        cond, body, (g, lm_xy_l, jnp.int32(0),
                     jnp.asarray(jnp.inf, g.poses.dtype)))
    return g_out, lm_out


def _window_gn_step_sharded(g: G.FactorGraph, lm_xy_l, cfg: gn.GNConfig,
                            window: int, edge_window: int, base, axis: str,
                            lm_prior_l, end=None, end_obs=None):
    """`gn.window_gn_step(landmarks=True)` with the map sharded: landmark
    columns [.., Lb] local, ONE [3W+..] psum for the window's reduced
    system. Same marginalized-information prior (restoring gradient at the
    firing-entry shard — backend/gauss_newton.py r4 fix). `end`/`end_obs`
    re-anchor the window at a past pose/edge count (mid-block firings —
    same contract as the dense window_gn_step)."""
    W, EW = window, edge_window
    dtype = g.poses.dtype
    n = g.n_poses if end is None else end
    e_stop = g.n_obs if end_obs is None else end_obs
    Lb = lm_xy_l.shape[0]
    w0_ = jnp.maximum(n - W, 0)
    poses_w = jax.lax.dynamic_slice(g.poses, (w0_, 0), (W, 3))
    odo_meas_w = jax.lax.dynamic_slice(g.odo_meas, (w0_, 0), (W, 3))
    odo_ww = jax.lax.dynamic_slice(g.odo_w, (w0_,), (W,))
    prior_pose_w = jax.lax.dynamic_slice(g.prior_pose, (w0_, 0), (W, 3))
    prior_info_w = jax.lax.dynamic_slice(g.prior_info, (w0_, 0), (W, 2))
    kg = w0_ + jnp.arange(W)

    from tpuslam.backend.residuals import (landmark_residuals,
                                           odometry_residuals)
    prev0 = g.poses[jnp.maximum(w0_ - 1, 0)]
    p_prev = jnp.concatenate([prev0[None, :], poses_w[:-1]], axis=0)
    odo_valid = (kg >= 1) & (kg < n)
    r_o, j_oi, j_oj = odometry_residuals(p_prev, poses_w, odo_meas_w)
    w_o = jnp.asarray(cfg.odo_info, dtype) * odo_valid.astype(dtype) * odo_ww
    w3 = w_o[:, None, None]
    jti = jnp.swapaxes(j_oi, -1, -2)
    jtj = jnp.swapaxes(j_oj, -1, -2)
    a_ii = w3 * (jti @ j_oi)
    a_jj = w3 * (jtj @ j_oj)
    h_off = w3 * (jti @ j_oj)
    g_i = w_o[:, None] * (jti @ r_o[..., None])[..., 0]
    g_j = w_o[:, None] * (jtj @ r_o[..., None])[..., 0]
    h_diag = a_jj.at[:-1].add(a_ii[1:])
    h_off = h_off.at[0].set(0.0)
    gp = g_j.at[:-1].add(g_i[1:])

    pose_valid = (kg < n).astype(dtype)
    ixy = prior_info_w[:, 0] * pose_valid
    ith = prior_info_w[:, 1] * pose_valid
    eye_xy = jnp.zeros((3, 3), dtype).at[0, 0].set(1.0).at[1, 1].set(1.0)
    eye_th = jnp.zeros((3, 3), dtype).at[2, 2].set(1.0)
    h_diag = h_diag + ixy[:, None, None] * eye_xy + ith[:, None, None] * eye_th
    r_pr = poses_w - prior_pose_w
    r_pr = r_pr.at[:, 2].set(se2.wrap_angle(r_pr[:, 2]))
    gp = gp + r_pr * jnp.stack([ixy, ixy, ith], axis=-1)

    # trailing landmark edges, weighted only on the owner shard
    e0 = jnp.maximum(e_stop - EW, 0)
    op = jax.lax.dynamic_slice(g.obs_pose, (e0,), (EW,))
    ol = jax.lax.dynamic_slice(g.obs_lm, (e0,), (EW,))
    oxy = jax.lax.dynamic_slice(g.obs_xy, (e0, 0), (EW, 2))
    ke = e0 + jnp.arange(EW)
    own_e = (ol >= base) & (ol < base + Lb)
    in_w = (ke < e_stop) & (op >= w0_)
    w_le = jnp.asarray(cfg.lm_info, dtype) * \
        (in_w & own_e).astype(dtype)
    local = jnp.clip(op - w0_, 0, W - 1)
    lol = jnp.clip(ol - base, 0, Lb - 1)
    r_l, j_lp, j_ll = landmark_residuals(poses_w[local], lm_xy_l[lol], oxy)
    wl3 = w_le[:, None, None]
    jtp = jnp.swapaxes(j_lp, -1, -2)
    onehot_p = (local[None, :] == jnp.arange(W)[:, None]).astype(dtype)
    hpp_e = (wl3 * (jtp @ j_lp)).reshape(EW, 9)
    # one-hot sums outside the precision scope below: pinned to full f32
    hi = jax.lax.Precision.HIGHEST
    hd_lm = jnp.matmul(onehot_p, hpp_e, precision=hi).reshape(W, 3, 3)
    gp_lm = jnp.matmul(onehot_p, w_le[:, None]
                       * (jtp @ r_l[..., None])[..., 0], precision=hi)
    # hd_lm/gp_lm ride the SAME psum launch as the eliminated reduced
    # system below (the elimination side is shard-local — VERDICT r4 next
    # #5); the pose-side gauge applies after the sum (elementwise mask)

    free = (kg >= cfg.fix_first_poses) & (kg < n)
    fpb = free.astype(dtype)[:, None, None]
    eye3 = jnp.eye(3, dtype=dtype)
    prev_free = jnp.concatenate([jnp.zeros((1,), bool), free[:-1]])
    pair = (free & prev_free).astype(dtype)
    h_off = h_off * pair[:, None, None]

    with jax.default_matmul_precision(cfg.matmul_precision):
        # Hll from TOTAL per-landmark counts (all edges, owner-masked)
        e_all = g.obs_pose.shape[0]
        ve = ((jnp.arange(e_all) < e_stop)
              & (g.obs_lm >= base) & (g.obs_lm < base + Lb)).astype(dtype)
        lol_all = jnp.clip(g.obs_lm - base, 0, Lb - 1)
        onehot_tot = (lol_all[None, :]
                      == jnp.arange(Lb)[:, None]).astype(dtype)
        n_tot = onehot_tot @ ve
        gid = base + jnp.arange(Lb)
        free_lm = (gid >= cfg.fix_first_landmarks) & (gid < g.n_landmarks)
        flm = free_lm.astype(dtype)
        eye2 = jnp.eye(2, dtype=dtype)
        hll_d = jnp.asarray(cfg.lm_info, dtype) * n_tot * flm
        hll = jnp.where(hll_d > 0, hll_d, 1.0)[:, None, None] * eye2
        if cfg.damping:
            hll = hll + eye2 * jnp.asarray(cfg.damping, dtype) \
                * flm[:, None, None]
        onehot_l = (lol[None, :] == jnp.arange(Lb)[:, None]).astype(dtype) \
            * own_e[None, :].astype(dtype)
        w_e = wl3 * (jtp @ j_ll)
        fp3 = free.astype(dtype).repeat(3)
        w0c = jnp.einsum("we,ei,le->wil", onehot_p, w_e[..., 0],
                         onehot_l).reshape(3 * W, Lb) \
            * fp3[:, None] * flm[None, :]
        w1c = jnp.einsum("we,ei,le->wil", onehot_p, w_e[..., 1],
                         onehot_l).reshape(3 * W, Lb) \
            * fp3[:, None] * flm[None, :]
        jtl = jnp.swapaxes(j_ll, -1, -2)
        gl = (onehot_l @ (w_le[:, None] * (jtl @ r_l[..., None])[..., 0])) \
            * flm[:, None]
        # marginalized-information prior, anchored at the firing entry
        ve_in = (in_w & own_e).astype(dtype)
        n_out = jnp.maximum(n_tot - onehot_l @ ve_in, 0.0)
        gl = gl + (jnp.asarray(cfg.lm_info, dtype) * n_out
                   * flm)[:, None] * (lm_xy_l - lm_prior_l)

        # local landmark elimination + ONE tupled psum for the whole
        # window system (Hpp-row contributions + eliminated reduced parts)
        hll_inv = gn._inv2x2(hll)
        ia, ib, ic = hll_inv[:, 0, 0], hll_inv[:, 0, 1], hll_inv[:, 1, 1]
        wa0 = w0c * ia[None, :] + w1c * ib[None, :]
        wa1 = w0c * ib[None, :] + w1c * ic[None, :]
        gl0, gl1 = gl[:, 0], gl[:, 1]
        s_part = wa0 @ w0c.T + wa1 @ w1c.T
        r_part = wa0 @ gl0 + wa1 @ gl1
        hd_lm, gp_lm, s_red, r_red = jax.lax.psum(
            (hd_lm, gp_lm, s_part, r_part), axis)
        h_diag = h_diag + hd_lm
        gp = gp + gp_lm
        h_diag = h_diag * fpb + eye3 * (1.0 - fpb)
        gp = gp * free.astype(dtype)[:, None]
        if cfg.damping:
            h_diag = h_diag + eye3 * jnp.asarray(cfg.damping, dtype) * fpb
        hpp = gn.densify_hpp(h_diag, h_off)
        s = hpp - s_red
        rhs = -gp.reshape(-1) + r_red
        c = jnp.linalg.cholesky(s)
        dp = jax.scipy.linalg.cho_solve((c, True), rhs)
        r0 = gl0 + w0c.T @ dp
        r1 = gl1 + w1c.T @ dp
        dl = -jnp.stack([ia * r0 + ib * r1, ib * r0 + ic * r1], axis=-1)
        new_lm = lm_xy_l + dl
    new_w = poses_w + dp.reshape(W, 3)
    new_w = new_w.at[:, 2].set(
        jnp.where(free, se2.wrap_angle(new_w[:, 2]), new_w[:, 2]))
    return dataclasses.replace(
        g, poses=jax.lax.dynamic_update_slice(g.poses, new_w, (w0_, 0))), \
        new_lm


def _optimize_window_sharded(g: G.FactorGraph, lm_xy_l, cfg: gn.GNConfig,
                             window: int, edge_window: int, base, axis: str,
                             enable=None, end=None, end_obs=None):
    iters = jnp.int32(cfg.iterations)
    if enable is not None:
        iters = jnp.where(enable, iters, 0)
    tol = jnp.asarray(cfg.early_exit_tol, g.poses.dtype) \
        if cfg.early_exit_tol > 0.0 else jnp.asarray(-jnp.inf, g.poses.dtype)
    lm_prior_l = lm_xy_l

    def cond(carry):
        _, _, i, delta = carry
        return (i < iters) & (delta > tol)

    def body(carry):
        gg, lml, i, _ = carry
        g2, lm2 = _window_gn_step_sharded(gg, lml, cfg, window, edge_window,
                                          base, axis, lm_prior_l,
                                          end=end, end_obs=end_obs)
        delta = jnp.maximum(jnp.max(jnp.abs(g2.poses - gg.poses)),
                            jax.lax.pmax(jnp.max(jnp.abs(lm2 - lml)), axis))
        return g2, lm2, i + 1, delta

    g_out, lm_out, _, _ = jax.lax.while_loop(
        cond, body, (g, lm_xy_l, jnp.int32(0),
                     jnp.asarray(jnp.inf, g.poses.dtype)))
    return g_out, lm_out


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def _pass_body(state: SlamState, lm_xy_l, lm_type_l, lm_info_l,
               obs_b, valid_b, pose_b, fv_b, ov_b,
               cfg: SlamConfig, block: int, L_glob: int, axis: str):
    """shard_map body: the whole blocked pass (scan-1 mapping, top-level
    closure GN, scan-2 localization) with the map sharded. Mirrors
    `frontend.blocked.blocked_core`'s control flow exactly."""
    B = block
    nb = obs_b.shape[0]
    Tp = nb * B
    Lb = lm_xy_l.shape[0]
    base = jax.lax.axis_index(axis) * Lb
    closed0 = state.loop_closure_complete
    fidx = jnp.arange(B, dtype=jnp.int32)
    # frozen-map packet deferral (VERDICT r4 next #5): with no in-scan GN
    # the ring rows can be gathered ONCE per scan instead of once per block
    defer1 = cfg.periodic_gn_every == 0
    defer2 = cfg.periodic_gn_every == 0 and not cfg.localizer_refine

    if cfg.periodic_gn_every > 0:
        pcfg = dataclasses.replace(_gn_config(cfg),
                                   iterations=cfg.periodic_gn_iterations)

        def periodic_fires(count0, ins, n_lm_series):
            counts = count0 + jnp.cumsum(ins.astype(jnp.int32))
            return (ins & (counts % cfg.periodic_gn_every == 0)
                    & (n_lm_series > 4))

    def patch_last_packet(outs, lm_xy2, lm_ty2, n_lm_last, cur_last, do_p):
        azp, dp_, tp_ = _packet_series_resident(
            lm_xy2, lm_ty2, base, Lb, axis, n_lm_last[None], cur_last[None],
            outs.pose[-1][None], cfg)
        return dataclasses.replace(
            outs,
            cone_azimuth=outs.cone_azimuth.at[-1].set(
                jnp.where(do_p, azp[0], outs.cone_azimuth[-1])),
            cone_distance=outs.cone_distance.at[-1].set(
                jnp.where(do_p, dp_[0], outs.cone_distance[-1])),
            cone_type=outs.cone_type.at[-1].set(
                jnp.where(do_p, tp_[0], outs.cone_type[-1])),
        )

    # ---- scan-1: mapping blocks
    def body1(carry, blk):
        st, lmx, lmt, lmi, stopped = carry
        o, v, p, fv, ov = blk
        active = ~stopped & ~st.loop_closure_complete
        okp = ((jnp.abs(p[:, 0]) <= cfg.gps_outlier_bound)
               & (jnp.abs(p[:, 1]) <= cfg.gps_outlier_bound) & active)
        ns, lmx2, lmt2, lmi2, outs, aux = _mapping_block_resident(
            st, lmx, lmt, lmi, o, v, p, okp, cfg, L_glob, axis,
            boot_ok=fv, overflow=ov, defer_packets=defer1)
        fb = aux["fallback"] & active
        if cfg.periodic_gn_every > 0:
            fires = periodic_fires(st.keyframe_count, aux["ins"],
                                   aux["n_lm_series"])
            if _midblock_gn(cfg, B):
                # mid-block multi-fire — mirrors frontend.blocked body1
                # (same firing anchors, same one-gather publish re-refine,
                # same fires-on-closure-frame fallback rule)
                fire_on_kc = aux["closure_any"] & \
                    fires[jnp.clip(aux["kc_frame"], 0, B - 1)]
                fb = fb | (active & fire_on_kc)
                gate = active & ~fb
                order = jnp.argsort(~fires, stable=True).astype(jnp.int32)
                g2, lmx3 = ns.graph, lmx2
                for jj in range(B // cfg.periodic_gn_every):
                    fj = order[jj]
                    g2, lmx3 = _optimize_window_sharded(
                        g2, lmx3, pcfg, cfg.periodic_gn_window,
                        cfg.periodic_gn_edge_window, base, axis,
                        enable=fires[fj] & gate,
                        end=aux["n_pose_series"][fj],
                        end_obs=aux["n_obs_series"][fj])
                do_p = fires[-1] & gate
                if cfg.mapping_publish_refine:
                    tgt_b, mat_b = aux["pub_rows"]
                    (rows_b,) = _gather_lm(tgt_b.reshape(-1), base,
                                           lmx3.shape[0], axis, lmx3)
                    ref_f = jax.vmap(
                        lambda pp, ll, mm, zz:
                        _publish_refine(pp, ll, mm, zz, cfg))(
                        p, rows_b.reshape(B, -1, 2), mat_b,
                        _body_xy(o, cfg))
                    fired_before = (jnp.cumsum(fires.astype(jnp.int32))
                                    - fires.astype(jnp.int32)) > 0
                    ready_b = (aux["n_pose_series"] - 1) \
                        >= cfg.periodic_gn_every
                    upd = gate & fired_before & ready_b
                    outs = dataclasses.replace(
                        outs, pose=jnp.where(upd[:, None], ref_f,
                                             outs.pose))
            else:
                fb = fb | (active & (jnp.any(fires[:-1])
                                     | (fires[-1] & aux["closure_any"])))
                do_p = fires[-1] & ~aux["closure_any"] & active & ~fb
                g2, lmx3 = _optimize_window_sharded(
                    ns.graph, lmx2, pcfg, cfg.periodic_gn_window,
                    cfg.periodic_gn_edge_window, base, axis, enable=do_p)
            ns = dataclasses.replace(ns, graph=g2)
            if cfg.use_gps_prior and not cfg.mapping_publish_refine:
                pl = g2.poses[jnp.maximum(g2.n_poses - 1, 0)]
                outs = dataclasses.replace(
                    outs, pose=outs.pose.at[-1].set(
                        jnp.where(do_p, pl, outs.pose[-1])))
            outs = patch_last_packet(outs, lmx3, lmt2,
                                     aux["n_lm_series"][-1],
                                     aux["cur_series"][-1], do_p)
            lmx2 = lmx3
        st2 = _select_state(fb, st, ns)
        lmx2 = jnp.where(fb, lmx, lmx2)
        lmt2 = jnp.where(fb, lmt, lmt2)
        lmi2 = jnp.where(fb, lmi, lmi2)
        committed = active & ~fb
        m1 = committed & (~aux["closure_any"] | (fidx <= aux["kc_frame"]))
        prows = aux["pub_rows"] if cfg.mapping_publish_refine \
            else jnp.zeros((), jnp.int32)
        pk = aux["pkt_idx"] if defer1 else jnp.zeros((), jnp.int32)
        ys = (outs, m1, fb & active, aux["closure_any"] & committed,
              aux["kc_frame"], aux["cur_series"], aux["n_lm_series"], prows,
              pk)
        return (st2, lmx2, lmt2, lmi2,
                stopped | fb | (aux["closure_any"] & committed)), ys

    (state, lm_xy_l, lm_type_l, lm_info_l, _), \
        (outs1, m1, fb1, cls1, kcf1, cur1, nlm1, prows1, pkt1) = \
        jax.lax.scan(
            body1, (state, lm_xy_l, lm_type_l, lm_info_l, closed0),
            (obs_b, valid_b, pose_b, fv_b, ov_b))

    if defer1:
        # deferred mapping-phase packets: ONE gather for the whole scan
        # against the scan-1-end positions (immutable through scan-1 — the
        # closure GN below is the first thing that moves landmarks)
        C = cfg.cones_per_packet
        xy_all, ty_all = _gather_lm(pkt1.reshape(-1), base, Lb, axis,
                                    lm_xy_l, lm_type_l)
        az1, d1 = global_to_body_spherical(
            outs1.pose.reshape(Tp, 1, 3), xy_all.reshape(Tp, C, 2),
            cfg.reference_compat)
        outs1 = dataclasses.replace(
            outs1, cone_azimuth=az1.reshape(nb, B, C),
            cone_distance=d1.reshape(nb, B, C),
            cone_type=ty_all.reshape(nb, B, C))

    closure_found = jnp.any(cls1)
    i_c = jnp.argmax(cls1).astype(jnp.int32)
    kc_global = jnp.where(
        closure_found, i_c * B + kcf1[i_c],
        jnp.where(closed0, jnp.int32(-1), jnp.int32(Tp)))

    # ---- top-level one-shot closure GN (sharded landmark elimination)
    gcfg = _gn_config(cfg)
    g, lm_xy_l = _optimize_sharded(state.graph, lm_xy_l, gcfg, L_glob, base,
                                   axis, enable=closure_found)
    state = dataclasses.replace(state, graph=g)

    # patch the closure frame's cone packet to the post-GN map
    t_kc = jnp.clip(kc_global, 0, Tp - 1)
    kc_local = jnp.clip(kcf1[i_c], 0, B - 1)
    cur_kc = cur1[i_c, kc_local]
    nlm_kc = nlm1[i_c, kc_local]
    pose_kc = pose_b.reshape(Tp, 3)[t_kc]
    if cfg.mapping_publish_refine:
        # re-run the closure frame's publish refine against the POST-GN
        # shards (mirrors frontend.blocked's patch; rows gathered globally)
        tgt_kc = prows1[0][i_c, kc_local]
        mat_kc = prows1[1][i_c, kc_local]
        (rows_kc,) = _gather_lm(tgt_kc, base, Lb, axis, lm_xy_l)
        obs_kc = obs_b.reshape(Tp, *obs_b.shape[2:])[t_kc]
        pub_kc = _publish_refine(pose_kc, rows_kc, mat_kc,
                                 _body_xy(obs_kc, cfg), cfg)
        pose_kc = jnp.where(closure_found, pub_kc, pose_kc)
        outs1 = dataclasses.replace(
            outs1, pose=outs1.pose.at[i_c, kc_local].set(
                jnp.where(closure_found, pose_kc,
                          outs1.pose[i_c, kc_local])))
    azk, dk, tk = _packet_series_resident(
        lm_xy_l, lm_type_l, base, Lb, axis, nlm_kc[None], cur_kc[None],
        pose_kc[None], cfg)
    outs1 = jax.tree.map(lambda x: x.reshape((Tp,) + x.shape[2:]), outs1)
    pk = closure_found
    outs1 = dataclasses.replace(
        outs1,
        cone_azimuth=outs1.cone_azimuth.at[t_kc].set(
            jnp.where(pk, azk[0], outs1.cone_azimuth[t_kc])),
        cone_distance=outs1.cone_distance.at[t_kc].set(
            jnp.where(pk, dk[0], outs1.cone_distance[t_kc])),
        cone_type=outs1.cone_type.at[t_kc].set(
            jnp.where(pk, tk[0], outs1.cone_type[t_kc])),
    )

    # ---- scan-2: localization blocks
    def body2(carry, xs):
        st, lmx, lmt, lmi, stopped = carry
        ib, (o, v, p, ov) = xs
        frames = ib * B + fidx
        active = ~stopped & st.loop_closure_complete
        okp = ((jnp.abs(p[:, 0]) <= cfg.gps_outlier_bound)
               & (jnp.abs(p[:, 1]) <= cfg.gps_outlier_bound)
               & (frames > kc_global) & active)
        ns, outs, aux2 = _loc_block_resident(
            st, lmx, lmt, lmi, o, v, p, okp, cfg, L_glob, axis, overflow=ov,
            defer_packets=defer2)
        fb = aux2["fallback"]
        lmx2 = lmx
        if cfg.periodic_gn_every > 0:
            n_lm_b = jnp.broadcast_to(ns.graph.n_landmarks, (B,))
            fires = periodic_fires(st.keyframe_count, aux2["okp"], n_lm_b)
            if _midblock_gn(cfg, B):
                # mid-block multi-fire (see body1); localization inserts
                # poses only, so the edge anchor stays at the graph head
                gate = active & ~fb
                npose_s = st.graph.n_poses + jnp.cumsum(
                    aux2["okp"].astype(jnp.int32))
                order = jnp.argsort(~fires, stable=True).astype(jnp.int32)
                g2, lmx2 = ns.graph, lmx
                for jj in range(B // cfg.periodic_gn_every):
                    fj = order[jj]
                    g2, lmx2 = _optimize_window_sharded(
                        g2, lmx2, pcfg, cfg.periodic_gn_window,
                        cfg.periodic_gn_edge_window, base, axis,
                        enable=fires[fj] & gate, end=npose_s[fj])
                do_p = fires[-1] & gate
            else:
                fb = fb | (active & jnp.any(fires[:-1]))
                do_p = fires[-1] & active & ~fb
                g2, lmx2 = _optimize_window_sharded(
                    ns.graph, lmx, pcfg, cfg.periodic_gn_window,
                    cfg.periodic_gn_edge_window, base, axis, enable=do_p)
            ns = dataclasses.replace(ns, graph=g2)
            outs = patch_last_packet(outs, lmx2, lmt, n_lm_b[-1],
                                     aux2["cur_series"][-1], do_p)
        st2 = _select_state(fb, st, ns)
        lmx2 = jnp.where(fb, lmx, lmx2)
        m2 = active & ~fb & (frames > kc_global)
        pk = aux2["pkt_idx"] if defer2 else jnp.zeros((), jnp.int32)
        return (st2, lmx2, lmt, lmi, stopped | fb), (outs, m2, fb, pk)

    (state, lm_xy_l, lm_type_l, lm_info_l, _), (outs2, m2, fb2, pkt2) = \
        jax.lax.scan(
            body2, (state, lm_xy_l, lm_type_l, lm_info_l,
                    jnp.asarray(False)),
            (jnp.arange(nb, dtype=jnp.int32), (obs_b, valid_b, pose_b, ov_b)))

    if defer2:
        # deferred localization packets: the map is frozen through scan-2
        C = cfg.cones_per_packet
        xy_all, ty_all = _gather_lm(pkt2.reshape(-1), base, Lb, axis,
                                    lm_xy_l, lm_type_l)
        az2, d2_ = global_to_body_spherical(
            outs2.pose.reshape(Tp, 1, 3), xy_all.reshape(Tp, C, 2),
            cfg.reference_compat)
        outs2 = dataclasses.replace(
            outs2, cone_azimuth=az2.reshape(nb, B, C),
            cone_distance=d2_.reshape(nb, B, C),
            cone_type=ty_all.reshape(nb, B, C))

    m2f = m2.reshape(Tp)
    outs2 = jax.tree.map(lambda x: x.reshape((Tp,) + x.shape[2:]), outs2)
    outs = jax.tree.map(
        lambda a, b: jnp.where(m2f.reshape((Tp,) + (1,) * (a.ndim - 1)), a, b),
        outs2, outs1)
    fb1_start = jnp.where(jnp.any(fb1),
                          jnp.argmax(fb1).astype(jnp.int32) * B, jnp.int32(Tp))
    fb2_start = jnp.where(jnp.any(fb2),
                          jnp.argmax(fb2).astype(jnp.int32) * B, jnp.int32(Tp))
    done_upto = jnp.minimum(fb1_start, fb2_start)
    return state, lm_xy_l, lm_type_l, lm_info_l, outs, done_upto


@lru_cache(maxsize=16)
def _core_fn(cfg: SlamConfig, block: int, L_glob: int, mesh, axis: str):
    body = partial(_pass_body, cfg=cfg, block=block, L_glob=L_glob,
                   axis=axis)
    sharded = P(axis)
    rep = P()
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(rep, sharded, sharded, sharded, rep, rep, rep, rep, rep),
        out_specs=(rep, sharded, sharded, sharded, rep, rep),
        # replicated outputs are products of replicated compute + psums —
        # identical on every device by construction
        check_vma=False)
    return jax.jit(fn)


def resident_online_core(state: SlamState, lm_xy, lm_type, lm_info,
                         obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                         mesh, block: int = 16, axis: str = "map",
                         compact_obs: int = 32):
    """The compiled resident pass. `state` carries the replicated pose/edge
    graph + counters (its own lm arrays are IGNORED — pass a state built
    with a dummy 1-landmark capacity, or any state: only non-lm leaves are
    read); lm_xy [L,2] / lm_type [L] / lm_info [L,3] are the global map
    arrays, sharded over `mesh[axis]` (L must be a multiple of the axis
    size). Inputs must be pre-padded to a multiple of `block`.

    Returns (state, lm_xy, lm_type, lm_info, outputs [Tp], done_upto)."""
    Tp = obs_seq.shape[0]
    nb = Tp // block
    L_glob = lm_xy.shape[0]
    if 0 < compact_obs < valid_seq.shape[-1]:
        obs_c, valid_c, first_valid, overflow = _compact_observations(
            obs_seq, valid_seq, compact_obs)
    else:
        obs_c, valid_c = obs_seq, valid_seq
        first_valid = valid_seq[:, 0]
        overflow = jnp.zeros((Tp,), bool)
    obs_b = obs_c.reshape(nb, block, *obs_c.shape[1:])
    valid_b = valid_c.reshape(nb, block, *valid_c.shape[1:])
    pose_b = pose_seq.reshape(nb, block, 3)
    fv_b = first_valid.reshape(nb, block)
    ov_b = overflow.reshape(nb, block)
    fn = _core_fn(cfg, block, L_glob, mesh, axis)
    return fn(state, lm_xy, lm_type, lm_info, obs_b, valid_b, pose_b,
              fv_b, ov_b)


def run_pass_resident_online(obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                             mesh, block: int = 16, axis: str = "map",
                             lm_per_device: int | None = None):
    """One whole session from a fresh state with the map sharded over
    `mesh[axis]`. Host wrapper: pads inputs, builds the sharded initial
    map, and — only if the core reports a bootstrap/capacity fallback
    (never on a healthy lap) — gathers the map and finishes the remaining
    frames with the dense per-frame path.

    Returns (state: SlamState with the GATHERED map folded back in,
    outputs [T]) — same contract as `frontend.blocked.run_pass_blocked`.
    """
    from tpuslam.frontend.blocked import (_pad_inputs, _per_frame_completion,
                                          _pick_compact)
    if not resident_online_supported(cfg, block):
        raise ValueError(
            "run_pass_resident_online: unsupported config (needs the "
            "blocked contract; periodic GN "
            "must be fixed-lag with boundaries on block ends)")
    D = mesh.shape[axis]
    L = cfg.capacity.max_landmarks
    if lm_per_device is None:
        if L % D:
            raise ValueError(f"max_landmarks {L} not divisible by {D} "
                             "(pass lm_per_device)")
        lm_per_device = L // D
    L_glob = lm_per_device * D
    obs_p, valid_p, pose_p, T = _pad_inputs(obs_seq, valid_seq, pose_seq,
                                            cfg, block)
    state = initial_state(cfg.capacity)
    lm_xy, lm_type, lm_info = initial_shards(L_glob)
    state, lm_xy, lm_type, lm_info, outs, done_upto = resident_online_core(
        state, lm_xy, lm_type, lm_info, obs_p, valid_p, pose_p, cfg, mesh,
        block, axis, compact_obs=_pick_compact(valid_p))
    # fold the map back into the dense state for callers — REPLICATED:
    # the arrays come out of the core still sharded over mesh[axis], and
    # both the per-frame completion below and dense downstream consumers
    # index them with data-dependent gathers that a sharded operand rejects
    from jax.sharding import NamedSharding
    rep = NamedSharding(mesh, P())
    lm_xy, lm_type, lm_info = (jax.device_put(a, rep)
                               for a in (lm_xy, lm_type, lm_info))
    Lc = cfg.capacity.max_landmarks
    state = dataclasses.replace(
        state,
        graph=dataclasses.replace(state.graph, lm_xy=lm_xy[:Lc],
                                  lm_type=lm_type[:Lc]),
        lm_info_xy=lm_info[:Lc])
    Tp = obs_p.shape[0]
    if int(done_upto) < Tp:
        state, outs_net = _per_frame_completion(state, obs_p, valid_p,
                                                pose_p, cfg, done_upto)
        fmask = jnp.arange(Tp) >= done_upto
        outs = jax.tree.map(
            lambda a, b: jnp.where(
                fmask.reshape((Tp,) + (1,) * (a.ndim - 1)), a, b),
            outs_net, outs)
    return state, jax.tree.map(lambda x: x[:T], outs)
