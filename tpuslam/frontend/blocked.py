"""Frame-blocked device pipeline: B keyframes per scan step, GN-free loops.

`run_sequence` (tpuslam/frontend/pipeline.py) executes one keyframe per
lax.scan iteration; a whole-lap pass is dominated by per-iteration loop costs,
not FLOPs or memory traffic. Two rules, set when the code targeted its first
accelerator and not yet measured again on a GPU, shape this module's design:

1. A `lax.cond` branch inside a scan can cost a copy of its operands per
   scan iteration *even when never taken* (branch operand copies defeat the
   loop's buffer aliasing), so the block scan bodies are straight-line
   programs — mode handling and commit/abort decisions are elementwise
   `jnp.where` selects, never conditionals.
2. A loop that merely *contains* the Gauss-Newton solver (its ~30 MB of
   dense-blocked temporaries) pays for them on every iteration, even behind
   a zero-trip while_loop. So no loop in this module contains GN at all: the
   one-shot closure optimization (reference src/slam.cpp:625-633) is hoisted
   to the top level of the pass, between two GN-free scans.

Structure of a pass:

- **scan-1 (mapping)**: blocks run the batched mapping update — the same
  machinery `_mapping_step_vectorized` uses within one frame, extended
  across the block. Cross-frame matches to landmarks created earlier in the
  block become duplicate-representative assignments over the flattened
  (B*N) observation axis; the reference's ``currentConeIndex/minDistance``
  carry (reset per frame, carried across frames — src/slam.cpp:385-387) is
  a within-frame exclusive prefix-argmin plus a frame-level "last-valid"
  associative carry; the bootstrap (src/slam.cpp:554-567) seeds in-body.
  Loop closure (src/slam.cpp:593-596) is detected exactly from the
  prefixes; the closure block commits its frames up to and including the
  closure frame (observations after the closure obs are suppressed exactly
  like ``closed_before``), marks the map complete, and the scan stops
  committing (later blocks become exact no-ops via their commit mask).
- **top level**: one `gn.optimize` (enable-gated: zero-trip when the lap
  has not closed), operating on exactly the graph run_sequence's per-frame
  GN saw — scan-1 inserted no poses/edges past the closure frame. The
  closure frame's outgoing cone packet is then patched to the post-GN map
  (run_sequence computes it after its in-frame GN).
- **scan-2 (localization)**: blocks run the frozen-map localizer
  (src/slam.cpp:340-414) for every frame after the closure, fully parallel
  except the B-long last-valid carry of ``currentConeIndex``. The first
  post-closure pose inserts against the post-GN estimate of the closure
  pose — the same odometry measurement the per-frame path computes.

Blocks neither scan can commit exactly — empty-map blocks whose first
observation is invalid, and pose/edge/landmark capacity saturation — stop
the scans; `_blocked_core` reports `done_upto` and the **host-side** wrapper
`run_sequence_blocked` finishes the remainder with the per-frame scan in a
separate dispatch (keeping the taxed construct out of the compiled hot
program entirely). On a normal lap no fallback fires and the wrapper costs
one scalar readback.

Equivalence to `run_sequence` is bit-exact for association policies 'first'
(the reference's) and 'nearest' — enforced by
tests/test_blocked_equivalence.py; the improved mode's GPS/heading priors
are supported (the closure frame's published pose/packet are patched to the
post-GN graph). The full improved mode is also blocked:

- **Periodic GN** (cfg.periodic_gn_every = k > 0): supported in TWO
  regimes. (a) k a whole number of blocks (k % block == 0): every firing
  boundary lands on a block's LAST committed frame — the scan body runs
  one enable-gated `gn.optimize` per block (zero-trip on non-boundary
  blocks) and execution is bit-exact vs the per-frame path: non-firing
  frames see exactly the map the per-frame path showed them (GN only ever
  ran at block boundaries), and the firing frame's published pose/packet
  are patched to the post-GN graph in-body. Boundaries that land mid-block
  at runtime (GPS-outlier frames shift keyframe_count, or a boundary
  coincides with the closure frame) raise the block's fallback flag and
  the per-frame path finishes the lap — never on a healthy lap.
  (b) **Mid-block firing** (block % k == 0, fixed-lag window configured):
  each block runs up to block/k enable-gated `gn.optimize_window` solves
  AFTER its mapping, in chronological firing order, each anchored at its
  firing frame's committed pose/edge counts (`window_gn_step` end/end_obs)
  — the window refined is exactly the one the per-frame path refined at
  that boundary. This decouples the GN cadence from the block size
  (VERDICT r4 next #3): the throughput-optimal block keeps its batched
  association while accuracy keeps the tight cadence. The documented
  approximation: frames between a mid-block firing and the end of its
  block associate/publish against the pre-firing map (refinement becomes
  visible next block — the same <= block-1 frame lag the mahalanobis info
  contract accepts), so equivalence vs per-frame is structural + close
  estimates, not bit-exact (tests/test_blocked_equivalence.py midblock
  tests). A firing inside the closure block falls back, as in (a).
- **Mahalanobis association** (cfg.association = 'mahalanobis'): the
  phase-A gate uses the block-START `lm_info_xy` (per-frame semantics
  accumulate within the frame stream, so blocked gating lags by at most
  block-1 frames — bit-exact at block=1, enforced in tests); in-block
  creations compete under the zero-information scaled-Euclidean gate
  (exactly `_gate_cost`'s fresh-landmark branch); committed observations
  scatter-add their information once per block, totalling exactly what the
  per-frame path accumulates for identical association decisions.
  Localization-mode gating is exact at any block size (information is
  frozen after closure).

Association provider: the block's phase-A gating can run through the
landmark-sharded map-block provider (blocked_core(assoc_mesh=...)) — the
[B*N] flattened observation axis is handed to the provider in place of the
dense [B*N, L] cost matrix; everything else (in-block creations, duplicate
representatives, closure prefixes) is provider-agnostic. Blocked results
match the per-frame path exactly like the dense configs do, because the
per-frame path uses the same provider (tests/test_blocked_equivalence.py).

Still unsupported (raise — use `run_sequence`): scan-form (non-vectorized)
mapping.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from tpuslam.backend import gauss_newton as gn
from tpuslam.backend import graph as G
from tpuslam.frontend.keyframe import (
    KeyframeOutputs, _body_xy, _gate_cost, _gn_config, _obs_information,
    _pose_refine, _prefix_argmin_exclusive, _publish_refine, perform_keyframe,
)
from tpuslam.frontend.state import SlamState
from tpuslam.geometry import se2
from tpuslam.geometry.spherical import cone_to_global, global_to_body_spherical
from tpuslam.runtime.config import SlamConfig

__all__ = ["run_sequence_blocked", "run_pass_blocked", "blocked_supported",
           "blocked_core"]


def _midblock_gn(cfg: SlamConfig, block: int) -> bool:
    """True when periodic GN fires at SUB-boundaries inside a block: the
    firing cadence divides the block size, so each block runs up to
    block/periodic_gn_every enable-gated fixed-lag solves, each anchored at
    its firing frame's committed pose/edge counts (window_gn_step
    end/end_obs). Decouples the accuracy cadence from the throughput block
    size (VERDICT r4 next #3) at the documented approximation: frames after
    a mid-block firing associate/publish against the pre-firing map (the
    refinement becomes visible at the next block — the same <= block-1
    frame lag the mahalanobis info contract already accepts)."""
    return (0 < cfg.periodic_gn_every < block
            and block % cfg.periodic_gn_every == 0
            and cfg.periodic_gn_window > 0)


def blocked_supported(cfg: SlamConfig, block: int = 8) -> bool:
    """Configs the block-fast path reproduces (module docstring has the
    mahalanobis lag contract and the mid-block firing contract; everything
    else is bit-exact)."""
    return (cfg.association in ("first", "nearest", "mahalanobis")
            and cfg.vectorized_mapping
            and (cfg.periodic_gn_every == 0
                 or cfg.periodic_gn_every % block == 0
                 or _midblock_gn(cfg, block)))


def _last_valid_inclusive(init, has, val):
    """s[f] = val[f] if has[f] else s[f-1], with s[-1] = init."""
    def op(a, b):
        ha, va = a
        hb, vb = b
        return (ha | hb, jnp.where(hb, vb, va))

    h, v = jax.lax.associative_scan(op, (has, val))
    return jnp.where(h, v, init)


def _exclusive_from_inclusive(series, init):
    return jnp.concatenate([jnp.asarray(init, series.dtype)[None],
                            series[:-1]])


def _pose_insert_plan(g, poses, ok_pose):
    """Per-frame pose indices + odometry measurements (no writes).

    Replicates the per-frame `G.add_pose` sequence (reference
    src/slam.cpp:433-459): the session's first pose gets a zero odometry
    measurement (run_sequence's ``n_poses > 0`` gate); every other insertion
    measures against the previous inserted pose's *estimate* — the graph
    entry for the block's first frame, the raw input pose for later frames
    (estimates == inputs inside a block; no GN runs inside scans here).
    """
    B = poses.shape[0]
    ins_i = ok_pose.astype(jnp.int32)
    n_after = g.n_poses + jnp.cumsum(ins_i)
    pose_idx = n_after - 1                                   # valid where ins

    fidx = jnp.arange(B)
    prev_f = _exclusive_from_inclusive(
        _last_valid_inclusive(jnp.int32(-1), ok_pose, fidx.astype(jnp.int32)),
        jnp.int32(-1))
    prev0 = g.poses[jnp.maximum(g.n_poses - 1, 0)]
    prev = jnp.where((prev_f >= 0)[:, None],
                     poses[jnp.maximum(prev_f, 0)], prev0[None, :])
    odo = jnp.where((pose_idx == 0)[:, None],
                    jnp.zeros((), poses.dtype), se2.between(prev, poses))
    return pose_idx, n_after, odo


def _scatter_poses(g, poses, odo, pose_idx, ins, cfg=None):
    """Masked block pose insertion; with cfg.use_gps_prior the inserted rows
    also get absolute GPS/heading priors (run_sequence's G.add_pose
    prior_info path, improved mode)."""
    cap_p = g.poses.shape[0]
    to = jnp.where(ins, pose_idx, cap_p)
    g = dataclasses.replace(
        g,
        poses=g.poses.at[to].set(poses, mode="drop"),
        odo_meas=g.odo_meas.at[to].set(odo, mode="drop"),
        n_poses=g.n_poses + jnp.sum(ins.astype(jnp.int32)),
    )
    if cfg is not None and cfg.use_gps_prior:
        info = jnp.broadcast_to(jnp.asarray(
            [1.0 / cfg.gps_prior_std ** 2, 1.0 / cfg.heading_prior_std ** 2],
            g.poses.dtype), (poses.shape[0], 2))
        g = dataclasses.replace(
            g,
            prior_pose=g.prior_pose.at[to].set(poses, mode="drop"),
            prior_info=g.prior_info.at[to].set(info, mode="drop"),
        )
    return g


def _compact_observations(obs_seq, valid_seq, nc: int):
    """Per-frame stable compaction of valid observations to the first `nc`
    slots: [T, N, 4] -> [T, nc, 4].

    Every consumer of the observation axis is validity-gated and depends
    only on the *relative order* of valid observations (association, edge
    append, currentConeIndex prefixes, duplicate representatives), so
    dropping padding slots is exact — except the bootstrap, which tests the
    ORIGINAL first slot (reference src/slam.cpp:554 uses cone column 0):
    the returned `first_valid` flag preserves that test. Frames with more
    than `nc` valid observations would lose data; `overflow` marks them for
    the fallback path.

    Shrinking N is quadratic leverage: the in-block duplicate machinery is
    O((B*N)^2) and real frames carry ~10-30 cones in 64 padded slots.
    """
    order = jnp.argsort(~valid_seq, axis=-1, stable=True)[..., :nc]
    obs_c = jnp.take_along_axis(obs_seq, order[..., None], axis=-2)
    valid_c = jnp.take_along_axis(valid_seq, order, axis=-1)
    counts = jnp.sum(valid_seq, axis=-1)
    return obs_c, valid_c, valid_seq[..., 0], counts > nc


def _packet_series(lm_xy, lm_type, n_lm_after, cur_after, out_pose,
                   cfg: SlamConfig):
    """Per-frame upcoming-cone packets (see `_cone_packet`) from given
    landmark arrays with per-frame (currentConeIndex, n_landmarks)."""
    k = jnp.arange(cfg.cones_per_packet)
    idx = cur_after[:, None] + k[None, :]
    n = jnp.maximum(n_lm_after, 1)[:, None]
    idx = jnp.where(idx < n, idx, idx - n)
    idx = jnp.clip(idx, 0, n - 1)
    az, dist = global_to_body_spherical(out_pose[:, None, :], lm_xy[idx],
                                        cfg.reference_compat)
    return az, dist, lm_type[idx]


DUP_PACKED = False  # module switch for the pair-machinery implementation
# (both bit-identical). The packed form's 32x-smaller fixpoint working set
# lost to its packing multiplies and per-row first-bit gathers at
# compact=16/32 on the code's first accelerator; the naive [BN, BN] masks
# fuse into their reductions at these sizes. Not measured on a GPU yet.


def _inblock_duplicates_naive(glob_k, otype_k, frame_of, cand, snap_match,
                              cost_snap, thresh2, gate, cfg: SlamConfig,
                              n_slots: int):
    """Reference implementation of `_inblock_duplicates`: materialized
    [BN, BN] bool pair mask, fixpoint re-reads it per round."""
    BN = glob_k.shape[0]
    gd = glob_k[:, None, :] - glob_k[None, :, :]
    gd2 = jnp.sum(gd * gd, axis=-1)
    lower = jnp.arange(BN)[:, None] > jnp.arange(BN)[None, :]
    gsame = (otype_k[:, None] == otype_k[None, :]) & (gd2 < thresh2) & lower
    is_new = cand
    for _ in range(cfg.in_frame_dup_depth + 4):
        dup_of_new = jnp.any(gsame & is_new[None, :], axis=1)
        is_new = cand & ~dup_of_new
    rep_ok = gsame & is_new[None, :]
    prev_ok = rep_ok & (frame_of[None, :] < frame_of[:, None])
    same_ok = rep_ok & (frame_of[None, :] == frame_of[:, None])
    prev_any = jnp.any(prev_ok, axis=1)
    if cfg.association in ("nearest", "mahalanobis"):
        gd2_prev = jnp.where(prev_ok, gd2, jnp.inf)
        rep_prev = jnp.argmin(gd2_prev, axis=1).astype(jnp.int32)
        d2_ib = jnp.min(gd2_prev, axis=1)
        ib_cost = d2_ib * (gate / thresh2) \
            if cfg.association == "mahalanobis" else d2_ib
        use_ib = prev_any & (ib_cost < cost_snap)
    else:
        rep_prev = jnp.argmax(prev_ok, axis=1).astype(jnp.int32)
        use_ib = prev_any & ~snap_match
    matched_pf = snap_match | prev_any
    rep_same = jnp.argmax(same_ok, axis=1).astype(jnp.int32)
    dup_same = cand & ~matched_pf & jnp.any(same_ok, axis=1)
    return is_new, use_ib, dup_same, rep_prev, rep_same, prev_any, matched_pf


def _inblock_duplicates(glob_k, otype_k, frame_of, cand, snap_match,
                        cost_snap, thresh2, gate, cfg: SlamConfig,
                        n_slots: int):
    """In-block creations + duplicate representatives over the flattened
    [BN] observation axis (the blocked form of run_sequence's per-frame
    phase-B — see `_mapping_block`'s docstring). `n_slots` is the (static)
    observation-slot count per frame: the caller lays rows out as
    frame_of = repeat(arange(B), n_slots).

    Candidates are pre-suppression; closure suppression is applied post-hoc
    by the caller (the first closure obs precedes everything it suppresses,
    so representatives of surviving duplicates always survive too).

    Bit-packed (r4): the naive form materialized the [BN, BN] bool pair
    mask and re-read it once per fixpoint round plus once per
    representative reduction, a large share of the batched pass's bytes.
    The pair mask packs into [BN, BN/32] uint32 words (32x smaller
    fixpoint working set); first-match representatives come from
    lowest-set-bit extraction, and the frame-order masks are packed
    prefix/band lookups with only B distinct rows. The nearest/mahalanobis representative distance argmin recomputes
    the pair predicates in one fused pass (glob_k/otype_k are a few KB).
    Results are bit-identical to the naive form
    (tests/test_blocked_equivalence.py).

    `cost_snap` is the phase-A matched cost in gate units (None for the
    'first' policy). Returns (is_new, use_ib, dup_same, rep_prev, rep_same,
    prev_any, matched_pf).
    """
    if not DUP_PACKED:
        return _inblock_duplicates_naive(glob_k, otype_k, frame_of, cand,
                                         snap_match, cost_snap, thresh2,
                                         gate, cfg, n_slots)
    BN = glob_k.shape[0]
    N = n_slots
    Bf = BN // N
    nw = (BN + 31) // 32
    pad = nw * 32 - BN
    wts = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)

    def pack(bits):                               # [.., BN] bool -> uint32
        if pad:
            bits = jnp.concatenate(
                [bits, jnp.zeros(bits.shape[:-1] + (pad,), bool)], -1)
        return jnp.sum(bits.reshape(bits.shape[:-1] + (nw, 32))
                       .astype(jnp.uint32) * wts, axis=-1, dtype=jnp.uint32)

    def pair_bool():                              # fused per consumer
        gd = glob_k[:, None, :] - glob_k[None, :, :]
        gd2 = jnp.sum(gd * gd, axis=-1)
        lower = jnp.arange(BN)[:, None] > jnp.arange(BN)[None, :]
        same = (otype_k[:, None] == otype_k[None, :]) & (gd2 < thresh2) \
            & lower
        return same, gd2

    gbits = pack(pair_bool()[0])                  # [BN, nw], built once

    is_new = cand
    for _ in range(cfg.in_frame_dup_depth + 4):
        nbits = pack(is_new)                      # [nw]
        dup_of_new = jnp.any((gbits & nbits[None, :]) != 0, axis=1)
        is_new = cand & ~dup_of_new

    # frame-order masks: packed prefix (earlier frames) / band (same frame)
    # tables with one row per frame
    kk = jnp.arange(nw * 32, dtype=jnp.int32)[:BN]
    lim = jnp.arange(Bf, dtype=jnp.int32)[:, None] * N
    pre_tab = pack(kk[None, :] < lim)             # [Bf, nw]
    band_tab = pack((kk[None, :] >= lim) & (kk[None, :] < lim + N))
    nbits = pack(is_new)
    rep_base = gbits & nbits[None, :]
    m_prev = rep_base & pre_tab[frame_of]
    m_same = rep_base & band_tab[frame_of]
    prev_any = jnp.any(m_prev != 0, axis=1)
    same_any = jnp.any(m_same != 0, axis=1)

    def first_bit(m):
        """Smallest set global bit index per row (= argmax over the bool
        mask, i.e. the FIRST match in index order); rows with no set bit
        return a clamped in-range value (callers gate on the any-flag)."""
        w = jnp.argmax(m != 0, axis=1).astype(jnp.int32)
        word = jnp.take_along_axis(m, w[:, None], axis=1)[:, 0]
        lsb = word & (~word + jnp.uint32(1))
        b = jax.lax.population_count(lsb - jnp.uint32(1)).astype(jnp.int32)
        return jnp.minimum(w * 32 + b, BN - 1)

    if cfg.association in ("nearest", "mahalanobis"):
        # nearest in-block representative: masked distance argmin in one
        # fused recompute pass
        gsame2, gd2 = pair_bool()
        prev_ok = gsame2 & is_new[None, :] \
            & (frame_of[None, :] < frame_of[:, None])
        gd2_prev = jnp.where(prev_ok, gd2, jnp.inf)
        rep_prev = jnp.argmin(gd2_prev, axis=1).astype(jnp.int32)
        d2_ib = jnp.min(gd2_prev, axis=1)
        # in-block creations carry no block-start information, so under
        # mahalanobis they compete at _gate_cost's zero-info scaled-
        # Euclidean cost (gate units match cost_snap's)
        ib_cost = d2_ib * (gate / thresh2) \
            if cfg.association == "mahalanobis" else d2_ib
        # strict <: ties go to the snapshot landmark (lower vertex index)
        use_ib = prev_any & (ib_cost < cost_snap)
    else:
        rep_prev = first_bit(m_prev)
        use_ib = prev_any & ~snap_match
    matched_pf = snap_match | prev_any           # run_sequence's "matched0"
    rep_same = first_bit(m_same)
    dup_same = cand & ~matched_pf & same_any
    return is_new, use_ib, dup_same, rep_prev, rep_same, prev_any, matched_pf


def _mapping_block(state: SlamState, obs, valid, poses, okp,
                   cfg: SlamConfig, boot_ok=None, overflow=None,
                   assoc_mesh=None, ablate: frozenset = frozenset(),
                   emit_edges: bool = False):
    """Straight-line mapping-mode block (reference src/slam.cpp:552-635),
    GN-free: on closure, frames up to the closure frame commit and
    `loop_closure_complete` is set; the caller's top-level GN finishes the
    job. An all-False okp makes the body an exact no-op.

    `ablate` (measurement-only, bench.py's byte budget) disables a
    subsystem to attribute its HBM traffic/FLOPs via XLA cost-analysis
    deltas: 'dup' (in-block duplicate pair machinery), 'assoc' (phase-A
    gating), 'packet' (cone-packet series), 'edges' (edge append),
    'transforms' (global/body coordinate transforms), 'closure' (loop-
    closure detection prefix machinery). Results are WRONG under ablation
    — never set it in production paths.

    Returns (new_state, outputs [B], aux dict).
    """
    g0 = state.graph
    B, N = valid.shape
    BN = B * N
    cap_l = g0.lm_xy.shape[0]
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
    if "transforms" in ablate:   # measurement-only: global/body transforms
        glob_k = jnp.zeros((BN, 2), obs.dtype)
        body_k = jnp.zeros((BN, 2), obs.dtype)
    else:
        glob_k = jax.vmap(lambda p, ob: cone_to_global(
            p, ob[..., 0], ob[..., 1], ob[..., 2], cfg.lidar_to_cog,
            cfg.reference_compat))(poses, obs).reshape(BN, 2)
        body_k = _body_xy(obs, cfg).reshape(BN, 2)
    otype_k = obs_k[:, 3].astype(jnp.int32)
    d2car_k = obs_k[:, 2]

    # ---- bootstrap (reference src/slam.cpp:554-567): empty map + valid
    # first observation seeds landmark 0 with an extra edge; it joins the
    # phase-A snapshot so obs (0,0) re-matches it (the double edge).
    boot0 = valid[0, 0] if boot_ok is None else boot_ok[0]
    boot = (n_lm0 == 0) & boot0 & okp[0]
    g = G.add_landmark(g, glob_k[0], otype_k[0], enable=boot)
    if emit_edges:
        # the boot edge becomes emitted row 0; only the counter advances
        g = dataclasses.replace(g, n_obs=g.n_obs + boot.astype(jnp.int32))
    else:
        g = G.add_observation(g, pose_idx_f[0], jnp.int32(0), body_k[0],
                              enable=boot)

    # ---- phase A: association against the block-start (post-boot) map.
    # Mahalanobis configs gate with the block-start lm_info_xy (the boot
    # landmark's zero info row reproduces the per-frame scaled-Euclidean
    # bootstrap patch exactly); Euclidean configs get (d2, thresh2) back
    # unchanged from _gate_cost. With the sharded map-block provider the
    # [BN, L] matrix is never materialized: the provider returns
    # (j, matched, cost) and `gate` is set directly.
    lm_valid1 = jnp.arange(cap_l) < g.n_landmarks
    if "assoc" in ablate:
        j_snap = jnp.zeros((BN,), jnp.int32)
        snap_match = jnp.zeros((BN,), bool)
        cost_snap = jnp.full((BN,), jnp.inf)
        gate = thresh2
    elif assoc_mesh is not None:
        from tpuslam.frontend.keyframe import _provider_associate
        j_snap, snap_match, cost_prov = _provider_associate(
            glob_k, otype_k, valid_k, g.lm_xy, g.lm_type, lm_valid1,
            state.lm_info_xy, cfg, assoc_mesh)
        gate = cfg.mahalanobis_gate \
            if cfg.association == "mahalanobis" else thresh2
        cost_snap = jnp.where(snap_match, cost_prov, jnp.inf)
    else:
        diff = glob_k[:, None, :] - g.lm_xy[None, :, :]
        d2m = jnp.sum(diff * diff, axis=-1)
        cost, gate = _gate_cost(diff, d2m, state.lm_info_xy, cfg)
        ok = ((g.lm_type[None, :] == otype_k[:, None]) & lm_valid1[None, :]
              & (cost < gate) & valid_k[:, None])
        if cfg.association == "first":
            j_snap = jnp.argmax(ok, axis=1).astype(jnp.int32)
        else:
            j_snap = jnp.argmin(jnp.where(ok, cost, 1e30),
                                axis=1).astype(jnp.int32)
        snap_match = jnp.any(ok, axis=1)
        if cfg.association != "first":
            cost_snap = jnp.where(
                snap_match,
                jnp.take_along_axis(cost, j_snap[:, None], axis=1)[:, 0],
                jnp.inf)

    # ---- in-block creations + duplicate representatives. Candidates are
    # pre-suppression; closure suppression is applied post-hoc (the first
    # closure obs precedes everything it suppresses, so representatives of
    # surviving duplicates always survive too).
    cand = valid_k & ~snap_match & (d2car_k < cfg.cone_mapping_threshold)
    if "dup" in ablate:    # measurement-only: no in-block merging at all
        is_new = cand
        matched_pf = snap_match
        use_ib = jnp.zeros((BN,), bool)
        dup_same = jnp.zeros((BN,), bool)
        rep_prev = rep_same = jnp.zeros((BN,), jnp.int32)
        prev_any = jnp.zeros((BN,), bool)
    else:
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
    slot_ok = slot < cap_l
    target = jnp.where(matched_pf & ~use_ib, j_snap, slot)
    target_xy = jnp.where((matched_pf & ~use_ib)[:, None],
                          g.lm_xy[j_snap], glob_k[row_rep])

    # ---- exact loop-closure detection (reference src/slam.cpp:593-596).
    # cur_before evolves from *unsuppressed* phase-A matches within the
    # frame (run_sequence uses matched0 there), carried across frames; the
    # unsuppressed carry is identical to the committed one up to and
    # including the first closure obs, which is all detection needs.
    target_f = target.reshape(B, N)
    if "closure" in ablate:   # measurement-only: detection prefix machinery
        closure0 = jnp.zeros((BN,), bool)
    else:
        vals_cl = jnp.where(matched_pf, d2car_k, jnp.inf).reshape(B, N)
        pm_cl, pi_cl = jax.vmap(_prefix_argmin_exclusive, in_axes=(0, None))(
            vals_cl, jnp.arange(N, dtype=jnp.int32))
        cur_cand_uns = matched_pf | (dup_same & slot_ok)
        vals_uns = jnp.where(cur_cand_uns, d2car_k, jnp.inf).reshape(B, N)
        fsel_uns = target_f[jnp.arange(B), jnp.argmin(vals_uns, axis=1)]
        cur_after_uns = _last_valid_inclusive(
            state.current_cone_index, jnp.min(vals_uns, axis=1) < 100.0,
            fsel_uns)
        cur_start_uns = _exclusive_from_inclusive(cur_after_uns,
                                                  state.current_cone_index)
        in_frame_tgt = target_f[frame_of, jnp.maximum(pi_cl.reshape(BN), 0)]
        cur_before = jnp.where(pm_cl.reshape(BN) < 100.0, in_frame_tgt,
                               cur_start_uns[frame_of])
        dfirst2 = jnp.sum((target_xy - g.lm_xy[0]) ** 2, axis=-1)
        closure0 = (matched_pf & (dfirst2 < cfg.loop_closure_radius ** 2)
                    & (cur_before > cfg.loop_closure_min_index)
                    & (d2car_k < cfg.cone_mapping_threshold))
    closure_any = jnp.any(closure0)
    kc_obs = jnp.argmax(closure0).astype(jnp.int32)          # first closure obs
    kc_frame = jnp.where(closure_any, frame_of[kc_obs], jnp.int32(B))
    closed_before = closure_any & (jnp.arange(BN) > kc_obs)

    # ---- suppression (run_sequence's closed_before) + tail cut: frames
    # after the closure frame belong to scan-2, so nothing of theirs commits
    matched = matched_pf & ~closed_before
    is_new_s = is_new & ~closed_before
    dup_same_s = dup_same & ~closed_before

    # ---- pose writes, cut at the closure frame (scan-2 re-inserts the
    # tail against the post-GN estimates, exactly like the per-frame path)
    ins = okp & (fidx <= kc_frame)
    g = _scatter_poses(g, poses, odo_f, pose_idx_f, ins, cfg)

    # ---- landmark writes (disjoint slots, OOB dropped)
    scatter_to = jnp.where(is_new_s & slot_ok, slot, cap_l)
    n_new_per_frame = jnp.sum(is_new_s.reshape(B, N), axis=1)
    n_lm_after = jnp.minimum(g.n_landmarks + jnp.cumsum(n_new_per_frame),
                             cap_l)
    n_new_total = jnp.sum(is_new_s)
    g = dataclasses.replace(
        g,
        lm_xy=g.lm_xy.at[scatter_to].set(glob_k, mode="drop"),
        lm_type=g.lm_type.at[scatter_to].set(otype_k, mode="drop"),
        n_landmarks=jnp.minimum(g.n_landmarks + n_new_total, cap_l),
    )

    # ---- edge append. Kept edges must land contiguously in global
    # observation order. Two forms:
    # - emit_edges (periodic-GN-free configs — nothing reads the edge
    #   arrays inside the scan): the block EMITS its [BN+1] candidate rows
    #   (boot row first) as scan outputs; the caller stacks them via the
    #   scan's native static ys layout and compacts ONCE per pass. This
    #   removes the per-block dynamic-base updates entirely — under vmap
    #   those lower to scatters, a large share of the batched pass.
    # - in-place (periodic window GN reads trailing edges in-body): three
    #   dynamic_update_slices per block, kept-first via one stable argsort
    #   (the old cumsum-rank + [BN] scatter lowered to a sort anyway).
    keep = matched | ((is_new_s | dup_same_s) & slot_ok)
    n_keep = jnp.sum(keep.astype(jnp.int32))
    pose_idx_k = pose_idx_f[frame_of]
    edge_rows = None
    if emit_edges:
        edge_rows = (
            jnp.concatenate([pose_idx_f[0][None], pose_idx_k]),
            jnp.concatenate([jnp.zeros((1,), jnp.int32), target]),
            jnp.concatenate([body_k[0][None], body_k]),
            jnp.concatenate([boot[None], keep]),
        )
        g = dataclasses.replace(
            g, n_obs=jnp.minimum(g.n_obs + n_keep, cap_e))
    elif "edges" not in ablate:
        perm = jnp.argsort(~keep, stable=True).astype(jnp.int32)
        base = jnp.minimum(g.n_obs, cap_e - BN)
        g = dataclasses.replace(
            g,
            obs_pose=jax.lax.dynamic_update_slice(g.obs_pose,
                                                  pose_idx_k[perm], (base,)),
            obs_lm=jax.lax.dynamic_update_slice(g.obs_lm, target[perm],
                                                (base,)),
            obs_xy=jax.lax.dynamic_update_slice(g.obs_xy, body_k[perm],
                                                (base, 0)),
            n_obs=jnp.minimum(g.n_obs + n_keep, cap_e),
        )

    # ---- per-landmark information accumulation (mahalanobis): every
    # committed observation adds its R^-1; one scatter-add for the block,
    # totals identical to the per-frame path for identical decisions
    lm_info = state.lm_info_xy
    if cfg.association == "mahalanobis":
        pose_bn = poses[frame_of]
        info_obs = jax.vmap(
            lambda gl, po, di: _obs_information(gl, po, di, cfg))(
            glob_k, pose_bn, d2car_k)
        info_to = jnp.where(keep, target, cap_l)
        lm_info = lm_info.at[info_to].add(info_obs, mode="drop")

    # ---- committed currentConeIndex series
    cur_cand = matched | (dup_same_s & slot_ok)
    vals_cur = jnp.where(cur_cand, d2car_k, jnp.inf).reshape(B, N)
    fsel = target_f[jnp.arange(B), jnp.argmin(vals_cur, axis=1)]
    cur_after = _last_valid_inclusive(state.current_cone_index,
                                      jnp.min(vals_cur, axis=1) < 100.0, fsel)

    out_pose = poses
    if cfg.mapping_publish_refine:
        # published-pose MAP refine (see keyframe._publish_refine);
        # target_xy rows are the committed landmark positions for exactly
        # the rows `matched` weights. vmapped across the block (the batched
        # 3x3 solves lower differently from the per-frame singles — the
        # flag's cross-path contract is f32-solve tolerance, not bit
        # equality; tests/test_blocked_equivalence.py::...publish_refine)
        ref = jax.vmap(
            lambda p, l, mm, z: _publish_refine(p, l, mm, z, cfg))(
            poses, target_xy.reshape(B, N, 2), matched.reshape(B, N),
            body_k.reshape(B, N, 2))
        ready = pose_idx_f >= cfg.periodic_gn_every   # first refresh ran
        out_pose = jnp.where(ready[:, None], ref, poses)
    if "packet" in ablate:
        az = dist = jnp.zeros((B, cfg.cones_per_packet))
        ctype = jnp.zeros((B, cfg.cones_per_packet), jnp.int32)
    else:
        az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, n_lm_after,
                                         cur_after, out_pose, cfg)
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
        lm_info_xy=lm_info,
    )

    any_act = jnp.any(okp)
    fallback = (((n_lm0 == 0) & ~boot & jnp.any(valid_k))
                | ((n_poses0 + B > cap_p) & any_act)
                | ((n_obs0 + 1 + BN > cap_e) & any_act)
                | (n_lm0 + boot.astype(jnp.int32) + n_new_total > cap_l))
    if overflow is not None:   # compaction dropped valid observations
        fallback = fallback | jnp.any(overflow & okp)
    # per-frame committed pose / edge counts (mid-block window-GN firings
    # anchor their windows at these — gauss_newton.window_gn_step end/end_obs)
    n_pose_series = n_poses0 + jnp.cumsum(ins.astype(jnp.int32))
    keep_pf = jnp.sum(keep.reshape(B, N).astype(jnp.int32), axis=1)
    n_obs_series = jnp.minimum(
        n_obs0 + boot.astype(jnp.int32) + jnp.cumsum(keep_pf), cap_e)
    aux = dict(closure_any=closure_any, kc_frame=kc_frame, fallback=fallback,
               cur_series=cur_after, n_lm_series=n_lm_after, ins=ins,
               n_pose_series=n_pose_series, n_obs_series=n_obs_series,
               edge_rows=edge_rows,
               pub_rows=((target_f, matched.reshape(B, N))
                         if cfg.mapping_publish_refine else None))
    return new_state, outputs, aux


def _loc_block(state: SlamState, obs, valid, poses, okp, cfg: SlamConfig,
               overflow=None, assoc_mesh=None,
               ablate: frozenset = frozenset()):
    """Straight-line localization-mode block against the frozen map
    (reference src/slam.cpp:340-414). An all-False okp is an exact no-op.
    `ablate`: measurement-only cost attribution (see `_mapping_block`).
    Returns (new_state, outputs [B], fallback_flag)."""
    g0 = state.graph
    B, N = valid.shape
    BN = B * N
    cap_l = g0.lm_xy.shape[0]

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

    lm_valid = jnp.arange(cap_l) < g.n_landmarks
    if "assoc" in ablate:
        j = jnp.zeros((BN,), jnp.int32)
        matched = jnp.zeros((BN,), bool)
    elif assoc_mesh is not None:
        # index-provider path (provider semantics: clean type equality,
        # min-cost match — exactly what the per-frame provider path does)
        from tpuslam.frontend.keyframe import _provider_associate
        j, matched, _c = _provider_associate(
            glob_k, obs_k[:, 3].astype(jnp.int32), vloc_k, g.lm_xy,
            g.lm_type, lm_valid, state.lm_info_xy, cfg, assoc_mesh)
    else:
        diff = glob_k[:, None, :] - g.lm_xy[None, :, :]
        d2m = jnp.sum(diff * diff, axis=-1)
        # post-closure information is frozen, so the mahalanobis gate here
        # is exact at any block size (Euclidean configs get (d2, thresh2))
        cost, gate = _gate_cost(diff, d2m, state.lm_info_xy, cfg)
        if cfg.reference_compat and cfg.localizer_type_bug:
            type_ok = (g.lm_type[None, :].astype(jnp.float32)
                       - obs_k[:, 3][:, None]) < 1e-4     # src/slam.cpp:360
        else:
            type_ok = g.lm_type[None, :] == \
                obs_k[:, 3].astype(jnp.int32)[:, None]
        okm = (type_ok & lm_valid[None, :] & vloc_k[:, None] & (cost < gate))
        j = jnp.argmax(okm, axis=1).astype(jnp.int32)   # first match per obs
        matched = jnp.any(okm, axis=1)

    d2 = jnp.where(matched, obs_k[:, 2], 1e30).reshape(B, N)
    best = jnp.argmin(d2, axis=1)
    any_m = jnp.any(matched.reshape(B, N), axis=1)
    j_best = j.reshape(B, N)[jnp.arange(B), best]

    cur_after = _last_valid_inclusive(state.current_cone_index, ran & any_m,
                                      j_best)
    cur_start = _exclusive_from_inclusive(cur_after,
                                          state.current_cone_index)
    # state.send_cone_data is the reference's "currentConeIndex changed"
    # flag (src/slam.cpp:385); the per-frame `send` OUTPUT is "a
    # localization update ran, publish pose+cones"
    cur_changed = ran & (cur_after != cur_start)
    send_state = _last_valid_inclusive(state.send_cone_data, ran,
                                       cur_changed)[-1]

    if cfg.localizer_refine:
        # lax.map (not vmap): a batched 3x3 solve lowers differently from
        # the per-frame one, which would break bit-exactness vs run_sequence
        g_ref = g
        out_pose = jax.lax.map(
            lambda a: _pose_refine(a[0], g_ref, a[1], a[2], a[3]),
            (poses, j.reshape(B, N), matched.reshape(B, N),
             body_k.reshape(B, N, 2)))
        out_pose = jnp.where(ran[:, None], out_pose, poses)
    else:
        out_pose = poses

    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[-1],
        send_cone_data=send_state,
        keyframe_count=state.keyframe_count + jnp.sum(okp.astype(jnp.int32)),
    )
    n_lm = jnp.broadcast_to(g.n_landmarks, (B,))
    if "packet" in ablate:
        az = dist = jnp.zeros((B, cfg.cones_per_packet))
        ctype = jnp.zeros((B, cfg.cones_per_packet), jnp.int32)
    else:
        az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, n_lm, cur_after,
                                         out_pose, cfg)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype,
        send=ran, loop_closed=jnp.zeros((B,), bool),
        n_landmarks=n_lm.astype(jnp.int32),
    )
    fallback = (g0.n_poses + B > g0.poses.shape[0]) & jnp.any(okp)
    if overflow is not None:   # compaction dropped valid observations
        fallback = fallback | jnp.any(overflow & okp)
    aux = dict(fallback=fallback, cur_series=cur_after, okp=okp)
    return new_state, outputs, aux


def _select_state(pred, a: SlamState, b: SlamState) -> SlamState:
    """Elementwise state select (NOT lax.cond — see module docstring)."""
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


@partial(jax.jit, static_argnames=("cfg", "block", "vmap_safe_gn",
                                   "compact_obs", "assoc_mesh", "unroll",
                                   "ablate"),
         donate_argnames="state")
def blocked_core(state: SlamState, obs_seq, valid_seq, pose_seq,
                 cfg: SlamConfig, block: int = 8,
                 vmap_safe_gn: bool = False, compact_obs: int = 32,
                 assoc_mesh=None, unroll: int = 1,
                 ablate: frozenset = frozenset()):
    """The compiled heart of the blocked pipeline (GN-free scans + one
    top-level GN). Inputs must already be padded to a multiple of `block`.

    Returns (state, outputs [Tp], done_upto): frames >= done_upto were NOT
    processed (a bootstrap/capacity fallback fired) and must be finished by
    the per-frame path — `run_sequence_blocked` does this on the host.
    done_upto == Tp means the pass is complete (the normal case).

    `unroll` unrolls both scans' bodies (lax.scan unroll): semantics are
    identical at any value (same op sequence, bit-exact), but the XLA
    while-loop runs `unroll`x fewer iterations, amortizing the
    per-iteration loop bookkeeping. This DECOUPLES the periodic-GN cadence
    from throughput: every-8 refinement must run at block=8 (firing
    boundaries land on block ends), and unrolling recovers the larger
    block's loop amortization without changing which frames see which
    map.
    """
    B = block
    Tp = obs_seq.shape[0]
    nb = Tp // B
    if 0 < compact_obs < valid_seq.shape[-1]:
        obs_c, valid_c, first_valid, overflow = _compact_observations(
            obs_seq, valid_seq, compact_obs)
    else:
        obs_c, valid_c = obs_seq, valid_seq
        first_valid = valid_seq[:, 0]
        overflow = jnp.zeros((Tp,), bool)
    obs_b = obs_c.reshape(nb, B, *obs_c.shape[1:])
    valid_b = valid_c.reshape(nb, B, *valid_c.shape[1:])
    pose_b = pose_seq.reshape(nb, B, 3)
    fv_b = first_valid.reshape(nb, B)
    ov_b = overflow.reshape(nb, B)
    closed0 = state.loop_closure_complete
    fidx = jnp.arange(B, dtype=jnp.int32)
    # edges-as-ys: legal whenever nothing reads the edge arrays inside the
    # scans (the periodic window GN does); the one consumer left — the
    # top-level closure GN — sees the compacted arrays
    emit = cfg.periodic_gn_every == 0 and "edges" not in ablate
    n_obs0 = state.graph.n_obs

    # periodic GN (improved mode): one enable-gated optimize per block,
    # firing only when the keyframe-count boundary lands on the block's
    # LAST committed frame (exactness argument in the module docstring);
    # mid-block boundaries raise the block's fallback flag.
    if cfg.periodic_gn_every > 0:
        pcfg = dataclasses.replace(_gn_config(cfg),
                                   iterations=cfg.periodic_gn_iterations)
        if vmap_safe_gn:
            pcfg = dataclasses.replace(pcfg, solve_bucket_step=0,
                                       edge_bucket_step=0)

        def periodic_fires(count0, ins, n_lm_series):
            counts = count0 + jnp.cumsum(ins.astype(jnp.int32))
            return (ins & (counts % cfg.periodic_gn_every == 0)
                    & (n_lm_series > 4))

        def patch_last_packet(outs, g2, n_lm_last, cur_last, do_p):
            azp, dp_, tp_ = _packet_series(g2.lm_xy, g2.lm_type,
                                           n_lm_last[None], cur_last[None],
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

    # ---- scan-1: mapping blocks, stop at closure or fallback
    def body1(carry, blk):
        st, stopped = carry
        o, v, p, fv, ov = blk
        active = ~stopped & ~st.loop_closure_complete
        okp = ((jnp.abs(p[:, 0]) <= cfg.gps_outlier_bound)
               & (jnp.abs(p[:, 1]) <= cfg.gps_outlier_bound) & active)
        ns, outs, aux = _mapping_block(st, o, v, p, okp, cfg, boot_ok=fv,
                                       overflow=ov, assoc_mesh=assoc_mesh,
                                       ablate=ablate, emit_edges=emit)
        fb = aux["fallback"] & active
        if cfg.periodic_gn_every > 0:
            fires = periodic_fires(st.keyframe_count, aux["ins"],
                                   aux["n_lm_series"])
            if _midblock_gn(cfg, B):
                # mid-block multi-fire (VERDICT r4 next #3): up to
                # B/periodic_gn_every gated fixed-lag solves per block,
                # each anchored at its firing frame's committed counts.
                # Firings BEFORE the closure frame are chronologically
                # consistent in-body (they precede the hoisted top-level
                # closure GN; fires is cut at kc_frame via `ins`); only a
                # firing exactly ON the closure frame falls back (the
                # per-frame order runs the closure GN first there).
                fire_on_kc = aux["closure_any"] & \
                    fires[jnp.clip(aux["kc_frame"], 0, B - 1)]
                fb = fb | (active & fire_on_kc)
                gate = active & ~fb
                order = jnp.argsort(~fires, stable=True).astype(jnp.int32)
                g2 = ns.graph
                for jj in range(B // cfg.periodic_gn_every):
                    fj = order[jj]
                    g2 = gn.optimize_window(
                        g2, pcfg, cfg.periodic_gn_window,
                        cfg.periodic_gn_edge_window,
                        enable=fires[fj] & gate,
                        landmarks=cfg.periodic_gn_window_landmarks,
                        end=aux["n_pose_series"][fj],
                        end_obs=aux["n_obs_series"][fj])
                if cfg.mapping_publish_refine:
                    # frames after the block's FIRST firing re-refine their
                    # published pose against the block-final post-firing
                    # map (the per-frame path refines against the newest
                    # past firing; using the final map keeps this to ONE
                    # map read — load-bearing for the sharded twin, where
                    # the read is a collective gather). Cone packets keep
                    # the block-entry map (<= block-1 frame lag).
                    tgt_b, mat_b = aux["pub_rows"]
                    ref_f = jax.vmap(
                        lambda pp, ll, mm, zz:
                        _publish_refine(pp, ll, mm, zz, cfg))(
                        p, g2.lm_xy[tgt_b], mat_b, _body_xy(o, cfg))
                    fired_before = (jnp.cumsum(fires.astype(jnp.int32))
                                    - fires.astype(jnp.int32)) > 0
                    ready_b = (aux["n_pose_series"] - 1) \
                        >= cfg.periodic_gn_every
                    upd = gate & fired_before & ready_b
                    outs = dataclasses.replace(
                        outs, pose=jnp.where(upd[:, None], ref_f,
                                             outs.pose))
                do_p = fires[-1] & gate
            else:
                # a boundary mid-block, or coinciding with the closure
                # frame (per-frame order: closure GN then periodic GN),
                # -> fallback
                fb = fb | (active & (jnp.any(fires[:-1])
                                     | (fires[-1] & aux["closure_any"])))
                do_p = fires[-1] & ~aux["closure_any"] & active & ~fb
                if cfg.periodic_gn_window > 0:
                    # fixed-lag refinement: straight-line, scan-safe (a
                    # full optimize in-scan puts GN in the loop body)
                    g2 = gn.optimize_window(
                        ns.graph, pcfg, cfg.periodic_gn_window,
                        cfg.periodic_gn_edge_window, enable=do_p,
                        landmarks=cfg.periodic_gn_window_landmarks)
                else:
                    g2 = gn.optimize(ns.graph, pcfg, enable=do_p)
            ns = dataclasses.replace(ns, graph=g2)
            if cfg.use_gps_prior and not cfg.mapping_publish_refine:
                # the firing frame publishes its post-GN graph estimate
                # (perform_keyframe's use_graph path); under publish-refine
                # the per-frame MAP estimate owns publication everywhere
                pl = g2.poses[jnp.maximum(g2.n_poses - 1, 0)]
                outs = dataclasses.replace(
                    outs, pose=outs.pose.at[-1].set(
                        jnp.where(do_p, pl, outs.pose[-1])))
            outs = patch_last_packet(outs, g2, aux["n_lm_series"][-1],
                                     aux["cur_series"][-1], do_p)
        st2 = _select_state(fb, st, ns)
        committed = active & ~fb
        # frames after the closure frame belong to scan-2
        m1 = committed & (~aux["closure_any"] | (fidx <= aux["kc_frame"]))
        if emit:
            ep, el, exy, ek = aux["edge_rows"]
            erows = (ep, el, exy, ek & committed)
        else:
            erows = jnp.zeros((), jnp.int32)
        prows = aux["pub_rows"] if cfg.mapping_publish_refine \
            else jnp.zeros((), jnp.int32)
        ys = (outs, m1, fb & active, aux["closure_any"] & committed,
              aux["kc_frame"], aux["cur_series"], aux["n_lm_series"], erows,
              prows)
        return (st2, stopped | fb | (aux["closure_any"] & committed)), ys

    (state, _), (outs1, m1, fb1, cls1, kcf1, cur1, nlm1, erows1, prows1) = \
        jax.lax.scan(
            body1, (state, closed0), (obs_b, valid_b, pose_b, fv_b, ov_b),
            unroll=unroll)

    if emit:
        # ---- one global edge compaction per pass: the scan's native ys
        # stacking laid the candidate rows out chronologically; kept-first
        # stable argsort over the flattened axis reproduces the in-place
        # path's content bit-exactly, appended after any pre-existing edges
        ep1, el1, exy1, ek1 = erows1
        tot = nb * (B * valid_c.shape[-1] + 1)
        ekf = ek1.reshape(tot)
        order = jnp.argsort(~ekf, stable=True)
        cap_e = state.graph.obs_pose.shape[0]
        K = min(cap_e, tot)
        sel = order[:K]
        nkeep = jnp.sum(ekf.astype(jnp.int32))
        to = jnp.where(jnp.arange(K) < nkeep, n_obs0 + jnp.arange(K), cap_e)
        ge = state.graph
        ge = dataclasses.replace(
            ge,
            obs_pose=ge.obs_pose.at[to].set(ep1.reshape(tot)[sel],
                                            mode="drop"),
            obs_lm=ge.obs_lm.at[to].set(el1.reshape(tot)[sel], mode="drop"),
            obs_xy=ge.obs_xy.at[to].set(exy1.reshape(tot, 2)[sel],
                                        mode="drop"),
        )
        state = dataclasses.replace(state, graph=ge)

    closure_found = jnp.any(cls1)
    i_c = jnp.argmax(cls1).astype(jnp.int32)
    kc_global = jnp.where(
        closure_found, i_c * B + kcf1[i_c],
        jnp.where(closed0, jnp.int32(-1), jnp.int32(Tp)))

    # ---- top-level one-shot closure GN (zero-trip when no closure):
    # scan-1 committed nothing past the closure frame, so the graph counts
    # are exactly what run_sequence's in-frame GN saw — no pinning needed.
    gcfg = _gn_config(cfg)
    if vmap_safe_gn:
        # the bucketed solve/assembly dispatch on lax.switch, and a vmapped
        # switch executes EVERY branch — a batched caller would factorize
        # at every bucket size. Run the full-capacity path instead.
        gcfg = dataclasses.replace(gcfg, solve_bucket_step=0,
                                   edge_bucket_step=0)
    g = gn.optimize(state.graph, gcfg,
                    enable=closure_found if "gn" not in ablate
                    else jnp.asarray(False))
    state = dataclasses.replace(state, graph=g)

    # patch the closure frame's cone packet to the post-GN map
    # (run_sequence computes it after its in-frame GN). The published POSE
    # needs no patch even with GPS priors: perform_keyframe's use_graph
    # gate reads loop_closure_complete after the mapping step, so the
    # closure frame itself publishes the raw pose, and every earlier
    # mapping frame's graph estimate equals its input (no GN has run).
    t_kc = jnp.clip(kc_global, 0, Tp - 1)
    kc_local = jnp.clip(kcf1[i_c], 0, B - 1)
    cur_kc = cur1[i_c, kc_local]
    nlm_kc = nlm1[i_c, kc_local]
    pose_pub_kc = pose_seq[t_kc]
    if cfg.mapping_publish_refine:
        # the per-frame path refines the closure frame's published pose
        # against the POST-closure-GN map (its in-step GN runs before the
        # publish); the blocked path hoists that GN, so re-run the refine
        # here with the optimized landmark rows
        tgt_kc = prows1[0][i_c, kc_local]            # [N] global lm ids
        mat_kc = prows1[1][i_c, kc_local]            # [N]
        body_kc = _body_xy(obs_c[t_kc], cfg)
        pub_kc = _publish_refine(pose_pub_kc, g.lm_xy[tgt_kc], mat_kc,
                                 body_kc, cfg)
        pose_pub_kc = jnp.where(closure_found, pub_kc, pose_pub_kc)
        outs1 = dataclasses.replace(
            outs1, pose=outs1.pose.at[i_c, kc_local].set(
                jnp.where(closure_found, pose_pub_kc,
                          outs1.pose[i_c, kc_local])))
    azk, dk, tk = _packet_series(g.lm_xy, g.lm_type, nlm_kc[None],
                                 cur_kc[None], pose_pub_kc[None], cfg)
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

    # ---- scan-2: localization blocks for every frame after the closure
    def body2(carry, xs):
        st, stopped = carry
        ib, (o, v, p, ov) = xs
        frames = ib * B + fidx
        active = ~stopped & st.loop_closure_complete
        okp = ((jnp.abs(p[:, 0]) <= cfg.gps_outlier_bound)
               & (jnp.abs(p[:, 1]) <= cfg.gps_outlier_bound)
               & (frames > kc_global) & active)
        ns, outs, aux2 = _loc_block(st, o, v, p, okp, cfg, overflow=ov,
                                    assoc_mesh=assoc_mesh, ablate=ablate)
        fb = aux2["fallback"]
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
                g2 = ns.graph
                for jj in range(B // cfg.periodic_gn_every):
                    fj = order[jj]
                    g2 = gn.optimize_window(
                        g2, pcfg, cfg.periodic_gn_window,
                        cfg.periodic_gn_edge_window,
                        enable=fires[fj] & gate,
                        landmarks=cfg.periodic_gn_window_landmarks,
                        end=npose_s[fj])
                do_p = fires[-1] & gate
                ns = dataclasses.replace(ns, graph=g2)
                if cfg.periodic_gn_window_landmarks:
                    outs = patch_last_packet(outs, g2, n_lm_b[-1],
                                             aux2["cur_series"][-1], do_p)
            elif cfg.periodic_gn_window > 0:
                fb = fb | (active & jnp.any(fires[:-1]))
                do_p = fires[-1] & active & ~fb
                g2 = gn.optimize_window(
                    ns.graph, pcfg, cfg.periodic_gn_window,
                    cfg.periodic_gn_edge_window, enable=do_p,
                    landmarks=cfg.periodic_gn_window_landmarks)
                ns = dataclasses.replace(ns, graph=g2)
                if cfg.periodic_gn_window_landmarks:
                    # the refreshed map changes the firing frame's packet
                    outs = patch_last_packet(outs, g2, n_lm_b[-1],
                                             aux2["cur_series"][-1], do_p)
                # else: map untouched and the published pose is the (pre-GN)
                # localizer pose — the outgoing packet is already exact
            else:
                fb = fb | (active & jnp.any(fires[:-1]))
                do_p = fires[-1] & active & ~fb
                g2 = gn.optimize(ns.graph, pcfg, enable=do_p)
                ns = dataclasses.replace(ns, graph=g2)
                # published pose stays localizer-refined (computed pre-GN, as
                # per-frame); only the firing frame's packet sees the new map
                outs = patch_last_packet(outs, g2, n_lm_b[-1],
                                         aux2["cur_series"][-1], do_p)
        st2 = _select_state(fb, st, ns)
        m2 = active & ~fb & (frames > kc_global)
        return (st2, stopped | fb), (outs, m2, fb)

    (state, _), (outs2, m2, fb2) = jax.lax.scan(
        body2, (state, jnp.asarray(False)),
        (jnp.arange(nb, dtype=jnp.int32), (obs_b, valid_b, pose_b, ov_b)),
        unroll=unroll)

    # ---- merge + completion boundary
    m1f = m1.reshape(Tp)
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
    return state, outs, done_upto


@partial(jax.jit, static_argnames="cfg")
def _per_frame_completion(state: SlamState, obs_seq, valid_seq, pose_seq,
                          cfg: SlamConfig, start_frame):
    """Exact per-frame scan, no-op before `start_frame` (masked frames get
    a pose failing the GPS outlier guard). Separate dispatch from
    `blocked_core` so its GN-bearing scan never taxes the hot program."""
    T = obs_seq.shape[0]
    mask = jnp.arange(T) >= start_frame
    far = jnp.full((3,), 2.0 * cfg.gps_outlier_bound + 1.0, pose_seq.dtype)
    p_eff = jnp.where(mask[:, None], pose_seq, far[None, :])

    def step(st, frame):
        o, v, p = frame
        return perform_keyframe.__wrapped__(st, o, v, p, cfg)

    return jax.lax.scan(step, state, (obs_seq, valid_seq, p_eff))


def _pick_compact(valid_seq, default: int = 32) -> int:
    """Data-driven observation-compaction width: the in-block pair
    machinery is O((B*nc)^2), so halving nc is quadratic leverage. One
    host readback of the max per-frame valid count picks the smallest safe
    bucket; denser streams than the bucket would overflow and per-frame
    fallback, so the pick is always sound, never just fast.

    Host-only: must run OUTSIDE any jit/scan trace (inside one, even ops
    on closed-over concrete arrays are staged as tracers and the readback
    cannot concretize) — hoist the call and pass the int through."""
    nmax_arr = jnp.max(jnp.sum(valid_seq, axis=-1))
    if isinstance(nmax_arr, jax.core.Tracer):
        raise TypeError(
            "_pick_compact needs a concrete valid mask — call it host-side "
            "before tracing and pass compact_obs as a static int")
    nmax = int(nmax_arr)
    for nc in (16, 32, 64):
        if nmax <= nc:
            return min(nc, valid_seq.shape[-1])
    return valid_seq.shape[-1]


def _pad_inputs(obs_seq, valid_seq, pose_seq, cfg, B):
    T = obs_seq.shape[0]
    pad = (-T) % B
    if pad:
        far = jnp.full((pad, 3), 2.0 * cfg.gps_outlier_bound + 1.0,
                       pose_seq.dtype)
        obs_seq = jnp.concatenate(
            [obs_seq, jnp.zeros((pad,) + obs_seq.shape[1:], obs_seq.dtype)])
        valid_seq = jnp.concatenate(
            [valid_seq, jnp.zeros((pad,) + valid_seq.shape[1:], bool)])
        pose_seq = jnp.concatenate([pose_seq, far])
    return obs_seq, valid_seq, pose_seq, T


def run_sequence_blocked(state: SlamState, obs_seq, valid_seq, pose_seq,
                         cfg: SlamConfig, block: int = 8, assoc_mesh=None):
    """Process T keyframes via the blocked pipeline.

    Same signature and results as `run_sequence` (bit-exact on supported
    configs — see `blocked_supported`). A host-side wrapper, not a jit: it
    dispatches `blocked_core` and, only when the core reports an unhandled
    bootstrap/capacity fallback (never on a healthy lap), finishes the
    remaining frames with the per-frame scan in a second dispatch.
    """
    if not blocked_supported(cfg, block):
        raise ValueError(
            "run_sequence_blocked: unsupported config (needs association in "
            "('first','nearest','mahalanobis'), "
            "vectorized mapping, periodic_gn_every a multiple of the block "
            "size — or dividing it, with a fixed-lag window) — use "
            "run_sequence")
    obs_seq, valid_seq, pose_seq, T = _pad_inputs(obs_seq, valid_seq,
                                                  pose_seq, cfg, block)
    # edge capacity below one block's rows: the mapping body cannot trace
    # its block-wide edge append; the per-frame scan is the whole program
    eff_n = min(obs_seq.shape[1], 32) if obs_seq.shape[1] > 32 \
        else obs_seq.shape[1]
    if cfg.capacity.max_obs < block * eff_n + 1:
        state, outs = _per_frame_completion(state, obs_seq, valid_seq,
                                            pose_seq, cfg, jnp.int32(0))
        return state, jax.tree.map(lambda x: x[:T], outs)

    state, outs, done_upto = blocked_core(state, obs_seq, valid_seq,
                                          pose_seq, cfg, block,
                                          assoc_mesh=assoc_mesh,
                                          compact_obs=_pick_compact(
                                              valid_seq))
    Tp = obs_seq.shape[0]
    if int(done_upto) < Tp:
        state, outs_net = _per_frame_completion(state, obs_seq, valid_seq,
                                                pose_seq, cfg, done_upto)
        fmask = jnp.arange(Tp) >= done_upto
        outs = jax.tree.map(
            lambda a, b: jnp.where(
                fmask.reshape((Tp,) + (1,) * (a.ndim - 1)), a, b),
            outs_net, outs)
    return state, jax.tree.map(lambda x: x[:T], outs)


def run_pass_blocked(obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                     block: int = 8, assoc_mesh=None):
    """One whole session from a fresh state via the blocked pipeline."""
    from tpuslam.frontend.state import initial_state
    return run_sequence_blocked(initial_state(cfg.capacity), obs_seq,
                                valid_seq, pose_seq, cfg, block,
                                assoc_mesh=assoc_mesh)


@partial(jax.jit, static_argnames=("cfg", "block", "compact_obs"))
def blocked_core_batched(states: SlamState, obs_seq, valid_seq, pose_seq,
                         cfg: SlamConfig, block: int = 8,
                         compact_obs: int = 32):
    """`blocked_core` vmapped over a leading session axis [S].

    The blocked body is a straight-line program (no lax.cond anywhere), so
    vmapping it is loss-free: every elementwise select, prefix scan, and
    one-hot contraction becomes an S-wide batched op, and the top-level GN
    becomes ONE batched solve per pass instead of one per session — unlike
    the per-frame batched path (tpuslam/parallel/batch.py), which must
    defer GN out of its vmapped cond and optimize sessions one at a time.

    states: stacked SlamState [S]; obs_seq [S,Tp,N,4], valid_seq [S,Tp,N],
    pose_seq [S,Tp,3] (pre-padded to a multiple of `block`). Returns
    (states, outputs [S,Tp], done_upto [S]).
    """
    return jax.vmap(
        lambda st, o, v, p: blocked_core.__wrapped__(st, o, v, p, cfg, block,
                                                     vmap_safe_gn=True,
                                                     compact_obs=compact_obs)
    )(states, obs_seq, valid_seq, pose_seq)


def run_sequences_blocked_batched(states: SlamState, obs_seq, valid_seq,
                                  pose_seq, cfg: SlamConfig, block: int = 8):
    """S independent sessions through the blocked pipeline in one dispatch.

    Host-side wrapper like `run_sequence_blocked`: sessions reporting an
    unhandled bootstrap/capacity fallback (never on healthy laps) are
    finished per-frame in follow-up dispatches.
    """
    if not blocked_supported(cfg, block):
        raise ValueError("unsupported config — see run_sequence_blocked")
    S, T = obs_seq.shape[:2]
    pad = (-T) % block
    if pad:
        far = jnp.full((S, pad, 3), 2.0 * cfg.gps_outlier_bound + 1.0,
                       pose_seq.dtype)
        obs_seq = jnp.concatenate(
            [obs_seq, jnp.zeros((S, pad) + obs_seq.shape[2:],
                                obs_seq.dtype)], axis=1)
        valid_seq = jnp.concatenate(
            [valid_seq, jnp.zeros((S, pad) + valid_seq.shape[2:], bool)],
            axis=1)
        pose_seq = jnp.concatenate([pose_seq, far], axis=1)
    states, outs, done = blocked_core_batched(
        states, obs_seq, valid_seq, pose_seq, cfg, block,
        compact_obs=_pick_compact(valid_seq))
    Tp = obs_seq.shape[1]
    done_h = [int(d) for d in done]
    if any(d < Tp for d in done_h):
        st_list, out_list = [], []
        for s in range(S):
            st_s = jax.tree.map(lambda x: x[s], states)
            out_s = jax.tree.map(lambda x: x[s], outs)
            if done_h[s] < Tp:
                st_s, out_net = _per_frame_completion(
                    st_s, obs_seq[s], valid_seq[s], pose_seq[s], cfg,
                    done[s])
                fmask = jnp.arange(Tp) >= done_h[s]
                out_s = jax.tree.map(
                    lambda a, b: jnp.where(
                        fmask.reshape((Tp,) + (1,) * (a.ndim - 1)), a, b),
                    out_net, out_s)
            st_list.append(st_s)
            out_list.append(out_s)
        states = jax.tree.map(lambda *x: jnp.stack(x), *st_list)
        outs = jax.tree.map(lambda *x: jnp.stack(x), *out_list)
    return states, jax.tree.map(lambda x: x[:, :T], outs)
