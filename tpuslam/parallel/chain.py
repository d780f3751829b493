"""Pose-chain (sequence) parallelism: contiguous keyframe blocks per device.

The SLAM analogue of context/sequence parallelism (SURVEY.md §2.4, §5.7): the
ever-growing keyframe chain is partitioned into contiguous blocks across the
'chain' mesh axis. Each device holds its pose block plus the landmark edges
whose observing pose it owns, and assembles its *rows* of the normal
equations locally. Communication:

- `ppermute` halo exchange of each block's last pose to its right neighbor
  (the odometry edge crossing a block boundary needs the predecessor pose);
- `psum` of the landmark-diagonal blocks Hll and gradient gl (landmarks are
  global, observed from many blocks);
- `all_gather` of the per-block Hpp rows / W rows / gp into the reduced pose
  system, which every device then solves identically (at Formula-Student
  scale the reduced solve is tiny next to assembly; on larger chains this is
  where a distributed block-tridiagonal factorization slots in).

Two reduced-solve providers (chain_optimize(solver=...)):

- 'replicated' — the all_gather + redundant-factorize path above; exact
  parity with the single-device solve.
- 'dd' — distributed domain decomposition (`chain_gn_step_dd`): each device
  eliminates its block-local landmarks and Cholesky-factorizes its interior
  poses; only the interface Schur complement (one separator pose per block +
  the cross-block shared landmarks, m = 3*n_dev + 2*n_shared) is psum'd and
  solved replicated; interiors back-substitute locally. Comm per iteration
  drops from O(P*L) to O(L + m^2) and the redundant O((3P)^3) factorization
  becomes O((3P/D)^3) per device. Measured on the 8-device virtual CPU mesh
  (scripts/bench_chain_solvers.py, 4 GN iterations, 6 obs/pose): DD wins at
  every scale — 12.4x at P=L=256 (172 ms vs 2.15 s), 26.4x at P=L=1024
  (1.35 s vs 35.8 s); there is no crossover in favor of 'replicated' above
  the smallest graphs, it is kept for bit-parity testing and tiny meshes.

Numerically identical to the single-device gn_step; verified in
tests/test_parallel.py.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tpuslam.backend import gauss_newton as gn
from tpuslam.backend.graph import FactorGraph
from tpuslam.backend.residuals import odometry_residuals
from tpuslam.geometry import se2

__all__ = ["partition_edges_by_pose_block", "chain_gn_step", "chain_optimize",
           "ChainPlan", "partition_chain", "chain_gn_step_dd",
           "assemble_pose_rows", "default_tray"]


def assemble_pose_rows(poses_l, odo_l, odo_w_sh, prior_pose_l, prior_info_l,
                       cfg: gn.GNConfig, n_poses, n_dev: int, base, axis: str):
    """Per-shard odometry + prior assembly shared by every chain solver.

    Returns (h_diag_l [b,3,3], h_off_l [b,3,3] (block (k-1,k)), gp_l [b,3],
    halo-returned contributions already folded). Pure function of the
    shard's pose block; the ppermute halo exchange with the neighbors is the
    only communication.
    """
    b = poses_l.shape[0]
    dtype = poses_l.dtype
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    halo = jax.lax.ppermute(poses_l[-1:], axis, perm)[0]
    k_local = jnp.arange(b)
    k_global = base + k_local
    p_prev = jnp.concatenate([halo[None, :], poses_l[:-1]], axis=0)
    odo_valid = (k_global >= 1) & (k_global < n_poses)
    r_o, j_oi, j_oj = odometry_residuals(p_prev, poses_l, odo_l)
    w_o = jnp.asarray(cfg.odo_info, dtype) * odo_valid.astype(dtype) \
        * odo_w_sh
    w3 = w_o[:, None, None]
    jti = jnp.swapaxes(j_oi, -1, -2)
    jtj = jnp.swapaxes(j_oj, -1, -2)
    a_ii = w3 * (jti @ j_oi)
    a_jj = w3 * (jtj @ j_oj)
    h_off_l = w3 * (jti @ j_oj)          # block (k-1, k)
    g_i = w_o[:, None] * (jti @ r_o[..., None])[..., 0]
    g_j = w_o[:, None] * (jtj @ r_o[..., None])[..., 0]
    back = [((i + 1) % n_dev, i) for i in range(n_dev)]
    a_ii_halo = jax.lax.ppermute(a_ii[:1], axis, back)[0]
    g_i_halo = jax.lax.ppermute(g_i[:1], axis, back)[0]
    h_diag_l = a_jj.at[:-1].add(a_ii[1:]).at[-1].add(a_ii_halo)
    gp_l = g_j.at[:-1].add(g_i[1:]).at[-1].add(g_i_halo)

    pose_valid = (k_global < n_poses).astype(dtype)
    ixy = prior_info_l[:, 0] * pose_valid
    ith = prior_info_l[:, 1] * pose_valid
    eye_xy = jnp.zeros((3, 3), dtype).at[0, 0].set(1.0).at[1, 1].set(1.0)
    eye_th = jnp.zeros((3, 3), dtype).at[2, 2].set(1.0)
    h_diag_l = h_diag_l + ixy[:, None, None] * eye_xy \
        + ith[:, None, None] * eye_th
    r_pr = poses_l - prior_pose_l
    r_pr = r_pr.at[:, 2].set(se2.wrap_angle(r_pr[:, 2]))
    gp_l = gp_l + r_pr * jnp.stack([ixy, ixy, ith], axis=-1)
    return h_diag_l, h_off_l, gp_l


def partition_edges_by_pose_block(g: FactorGraph, n_shards: int) -> FactorGraph:
    """Reorder the edge list so each pose-block's edges are contiguous and
    equally sized (host-side, once per solve). Edges of block d occupy slice
    [d*Eb, d*Eb + count_d); invalid padding has zero weight via n_obs-style
    masking replaced by an explicit validity convention: padded entries point
    at pose 0 / landmark 0 and are filtered by the per-edge valid flag we
    rebuild inside the solver from the counts array stored in n_obs slots.

    Returns a graph whose obs_* arrays are reordered+padded, with
    `n_obs` replaced by the TOTAL count (unchanged semantics for other
    consumers is NOT preserved — use the result only with chain_gn_step).
    """
    cap = g.capacity
    d = n_shards
    e_cap = cap.max_obs
    eb = e_cap // d
    n_obs = int(g.n_obs)
    block = cap.max_poses // d
    op = np.asarray(g.obs_pose)[:n_obs]
    ol = np.asarray(g.obs_lm)[:n_obs]
    oxy = np.asarray(g.obs_xy)[:n_obs]
    owner = op // block
    new_op = np.zeros(e_cap, np.int32)
    new_ol = np.zeros(e_cap, np.int32)
    new_oxy = np.zeros((e_cap, 2), np.float32)
    counts = np.zeros(d, np.int64)
    for dev in range(d):
        sel = np.flatnonzero(owner == dev)
        if len(sel) > eb:
            raise ValueError(f"block {dev} has {len(sel)} edges > per-block "
                             f"capacity {eb}; raise max_obs")
        base = dev * eb
        counts[dev] = len(sel)
        new_op[base:base + len(sel)] = op[sel]
        new_ol[base:base + len(sel)] = ol[sel]
        new_oxy[base:base + len(sel)] = oxy[sel]
    g2 = dataclasses.replace(
        g, obs_pose=jnp.asarray(new_op), obs_lm=jnp.asarray(new_ol),
        obs_xy=jnp.asarray(new_oxy), n_obs=g.n_obs)
    return g2, jnp.asarray(counts, jnp.int32)


def chain_gn_step(g: FactorGraph, edge_counts, cfg: gn.GNConfig, mesh) -> FactorGraph:
    """One GN iteration with poses AND their edges sharded along 'chain'."""
    cap = g.capacity
    n_dev = mesh.devices.size
    block = cap.max_poses // n_dev
    dtype = g.poses.dtype

    pose_spec = P("chain")
    rep = P()

    def per_shard(poses_l, odo_l, odo_w_sh, prior_pose_l, prior_info_l,
                  obs_pose_l, obs_lm_l, obs_xy_l, counts_l,
                  lm_xy, n_poses, n_landmarks):
        dev = jax.lax.axis_index("chain")
        base = dev * block

        h_diag_l, h_off_l, gp_l = assemble_pose_rows(
            poses_l, odo_l, odo_w_sh, prior_pose_l, prior_info_l, cfg,
            n_poses, n_dev, base, "chain")

        # --- landmark edges owned by this block (pose indices localized)
        eb = obs_pose_l.shape[0]
        w_l = jnp.asarray(cfg.lm_info, dtype) * \
            (jnp.arange(eb) < counts_l[0]).astype(dtype)
        local_idx = jnp.clip(obs_pose_l - base, 0, block - 1)  # pad-safe
        h_diag_lm, w_rows, hll_part, gp_lm, gl_part = gn.landmark_edge_blocks(
            poses_l, lm_xy, local_idx, obs_lm_l, obs_xy_l, w_l,
            cap.max_landmarks)
        h_diag_l = h_diag_l + h_diag_lm
        gp_l = gp_l + gp_lm

        # --- the distributed reductions
        hll, gl = jax.lax.psum((hll_part, gl_part), "chain")
        h_diag = jax.lax.all_gather(h_diag_l, "chain").reshape(-1, 3, 3)
        h_off = jax.lax.all_gather(h_off_l, "chain").reshape(-1, 3, 3)
        gp = jax.lax.all_gather(gp_l, "chain").reshape(-1, 3)
        w_mat = jax.lax.all_gather(w_rows.reshape(block, 3, -1), "chain") \
            .reshape(cap.max_poses * 3, -1)
        poses_full = jax.lax.all_gather(poses_l, "chain").reshape(-1, 3)

        # --- replicated reduced solve (identical on every device)
        hpp = gn.densify_hpp(h_diag, h_off)
        g_tmp = FactorGraph(  # shape/count carrier for _apply_gauge only
            poses=poses_full, n_poses=n_poses, odo_meas=poses_full,
            odo_w=jnp.ones(poses_full.shape[0], dtype),
            lm_xy=lm_xy, lm_type=jnp.zeros(lm_xy.shape[0], jnp.int32),
            n_landmarks=n_landmarks,
            obs_pose=jnp.zeros((1,), jnp.int32),
            obs_lm=jnp.zeros((1,), jnp.int32),
            obs_xy=jnp.zeros((1, 2), dtype), n_obs=jnp.int32(0),
            prior_pose=jnp.zeros_like(poses_full),
            prior_info=jnp.zeros((poses_full.shape[0], 2), dtype))
        blocks = gn._apply_gauge(g_tmp, cfg, hpp, w_mat, hll,
                                 gp.reshape(-1), gl)
        dp, dl = gn.schur_solve(*blocks)
        new_poses_full = poses_full + dp.reshape(-1, 3)
        new_poses_full = new_poses_full.at[:, 2].set(
            se2.wrap_angle(new_poses_full[:, 2]))
        new_lm = lm_xy + dl
        # back to this device's pose block
        new_local = jax.lax.dynamic_slice(new_poses_full, (base, 0), (block, 3))
        return new_local, new_lm

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(pose_spec, pose_spec, pose_spec, pose_spec, pose_spec,
                  pose_spec, pose_spec, pose_spec, pose_spec,
                  rep, rep, rep),
        out_specs=(pose_spec, rep),
        check_vma=False)  # lm output replication is by construction (post-psum)
    with jax.default_matmul_precision("highest"):
        new_poses, new_lm = fn(
            g.poses, g.odo_meas, g.odo_w, g.prior_pose, g.prior_info,
            g.obs_pose, g.obs_lm, g.obs_xy, edge_counts,
            g.lm_xy, g.n_poses, g.n_landmarks)
    return dataclasses.replace(g, poses=new_poses, lm_xy=new_lm)


@functools.lru_cache(maxsize=32)
def _dd_runner(plan: "ChainPlan", cfg: gn.GNConfig, mesh):
    """Compiled DD iteration loop, cached per (plan, cfg, mesh).

    The plan hashes by identity, so reusing one ChainPlan across calls (a
    localization loop re-solving the same graph layout) hits the jit cache
    instead of re-tracing — pass `plan=` to chain_optimize for that."""
    @jax.jit
    def run_dd(gg):
        def body(_, ggg):
            return chain_gn_step_dd(ggg, plan, cfg, mesh)
        return jax.lax.fori_loop(0, cfg.iterations, body, gg)

    return run_dd


def default_tray(n_dev: int, cap: int = 16) -> int:
    """Largest divisor of n_dev <= cap — the default ICI-domain (tray) size
    for the hierarchical solver when the caller doesn't pin one."""
    return max(t for t in range(1, min(cap, n_dev) + 1) if n_dev % t == 0)


def chain_optimize(g: FactorGraph, cfg: gn.GNConfig, mesh,
                   edge_counts=None, solver: str = "replicated",
                   plan=None, tray: int | None = None,
                   pod: int | None = None) -> FactorGraph:
    """Full chain-parallel GN: partition edges once, iterate under jit.

    solver='replicated': every device all_gathers the reduced system and
    factorizes it redundantly (exact parity with the single-device solve;
    comm O(P*L) per iteration). solver='dd': the distributed
    domain-decomposition solve (`chain_gn_step_dd`) — comm O(L + m^2) with
    m = 3*n_dev + 2*n_shared_landmarks (the block-boundary interface).
    solver='hier': the two-level nested-dissection solve
    (`hier.chain_optimize_hier`) — tray-interior separators and tray-local
    shared landmarks eliminated with a within-tray psum (ICI), only the
    O(n_trays) boundary system crossing trays (DCN at pod scale); `tray`
    is the ICI-domain size (default: largest divisor of the device count
    <= 16, `default_tray`). Pass a precomputed `plan` (partition_chain /
    partition_chain_hier) when re-solving the same layout to reuse the
    compiled program.
    """
    if solver == "hier3":
        # three-level nested dissection (parallel/hier3.py): tray ->
        # pod (default 256 devices, the comm model's pod, or the whole
        # mesh if smaller) -> cross-pod. The multi-pod path.
        from tpuslam.parallel.hier3 import chain_optimize_hier3
        n = mesh.devices.size
        if pod is None:
            pod = min(n, 256)
        if tray is None:
            # at least two trays per pod so level 2 is non-degenerate
            tray = default_tray(pod, cap=max(2, min(16, pod // 2)))
        return chain_optimize_hier3(g, cfg, mesh, tray, pod, plan=plan)
    if solver == "hier":
        from tpuslam.parallel.hier import chain_optimize_hier
        if tray is None:
            tray = default_tray(mesh.devices.size)
        return chain_optimize_hier(g, cfg, mesh, tray, plan=plan)
    if solver == "dd":
        if plan is None:
            plan = partition_chain(g, mesh.devices.size)
            g2 = plan.graph
        else:
            g2, _ = partition_edges_by_pose_block(g, mesh.devices.size)
        return _dd_runner(plan, cfg, mesh)(g2)

    if edge_counts is None:
        g, edge_counts = partition_edges_by_pose_block(g, mesh.devices.size)
    return _replicated_runner(cfg, mesh)(g, edge_counts)


@functools.lru_cache(maxsize=32)
def _replicated_runner(cfg: gn.GNConfig, mesh):
    @jax.jit
    def run(g, counts):
        def body(_, gg):
            return chain_gn_step(gg, counts, cfg, mesh)
        return jax.lax.fori_loop(0, cfg.iterations, body, g)

    return run


# ---------------------------------------------------------------------------
# Distributed domain-decomposition solve (VERDICT round-1 weak #1):
# no all_gather of W / Hpp, no replicated full factorization.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """Host-side partition for the DD chain solve (static per graph layout).

    The pose chain splits into n_dev contiguous blocks; each block's LAST
    pose is a *separator*. A landmark is *local* to block d when every pose
    observing it lies in block d (its elimination fill stays inside the
    block); otherwise it is *shared* and joins the interface system. The
    interface has m = 3*n_dev + 2*shared_cap variables — the only thing the
    devices reduce, O(block boundary) instead of the replicated path's
    O(P*L) all_gather.
    """
    graph: FactorGraph          # edges reordered per block (jax arrays)
    edge_counts: jax.Array      # [D] valid edges per block
    owner: jax.Array            # [L] owning block for local landmarks, -1 else
    shared_idx: jax.Array       # [shared_cap] landmark index, padded with L
    n_shared: int
    shared_cap: int             # static interface landmark capacity
    n_dev: int

    def __hash__(self):         # jit-static carrier (identity is fine: the
        return id(self)         # plan is built once per optimize call)

    def __eq__(self, other):
        return self is other


def partition_chain(g: FactorGraph, n_shards: int,
                    shared_cap: int | None = None) -> ChainPlan:
    """Host-side: edge partition + local/shared landmark classification."""
    cap = g.capacity
    block = cap.max_poses // n_shards
    if block < 3:
        raise ValueError("DD chain solve needs >= 3 poses per block "
                         "(separator must not be a gauge-fixed pose)")
    g2, counts = partition_edges_by_pose_block(g, n_shards)
    n_obs = int(g.n_obs)
    op = np.asarray(g.obs_pose)[:n_obs]
    ol = np.asarray(g.obs_lm)[:n_obs]
    owner_blk = op // block
    L = cap.max_landmarks
    min_o = np.full(L, n_shards, np.int64)
    max_o = np.full(L, -1, np.int64)
    np.minimum.at(min_o, ol, owner_blk)
    np.maximum.at(max_o, ol, owner_blk)
    n_lm = int(g.n_landmarks)
    valid = np.arange(L) < n_lm
    shared = valid & (max_o >= 0) & (max_o != min_o)
    first = np.where(max_o >= 0, min_o, -1)
    sh_list = np.flatnonzero(shared)
    n_shared = len(sh_list)
    if shared_cap is None:
        shared_cap = max(16, -(-max(n_shared, 1) // 16) * 16)
    if n_shared > shared_cap:
        raise ValueError(f"{n_shared} shared landmarks > capacity {shared_cap}")
    shared_idx = np.full(shared_cap, L, np.int32)
    shared_idx[:n_shared] = sh_list
    owner = np.where(valid & ~shared & (first >= 0), first, -1).astype(np.int32)
    # observed-from-nowhere landmarks (no edges, e.g. pre-closure creations
    # whose edges were dropped) have first = -1 -> no owner -> no update;
    # they are also outside every W column, so the solve ignores them.
    return ChainPlan(graph=g2, edge_counts=counts,
                     owner=jnp.asarray(owner), shared_idx=jnp.asarray(shared_idx),
                     n_shared=n_shared, shared_cap=int(shared_cap),
                     n_dev=n_shards)


def chain_gn_step_dd(g: FactorGraph, plan: ChainPlan, cfg: gn.GNConfig,
                     mesh) -> FactorGraph:
    """One GN iteration with a DISTRIBUTED reduced solve.

    Per device: assemble own rows (as chain_gn_step), eliminate the block's
    local landmarks (their fill stays inside the block), Cholesky-factorize
    the interior-pose system A_d, and psum only the interface Schur
    complement (separator poses + shared landmarks, m x m). The interface
    solve is replicated (m is tiny); interiors back-substitute locally.

    Exact linear algebra — identical to the replicated solve up to f32
    reduction order (block elimination vs one global factorization);
    verified to ~1e-4 absolute in tests/test_parallel.py.

    Comm per iteration: psum Hll/gl (O(L)) + psum the [m, m] interface
    (m = 3*n_dev + 2*shared_cap) + psum of local landmark updates (O(L)) —
    the replicated path's O(P*L) W all_gather and O((3P)^2) Hpp gather are
    gone, as is its O((3P)^3) redundant factorization.
    """
    cap = g.capacity
    n_dev = plan.n_dev
    b = cap.max_poses // n_dev
    ni = b - 1                        # interior poses per block
    lsh = plan.shared_cap
    m = 3 * n_dev + 3 + 2 * lsh      # +3: slot for the (unused) d-1 column
    # interface layout: cols [0, 3*n_dev) separators, then 2*lsh shared-
    # landmark coords; the extra +3 scratch block absorbs device 0's
    # "previous separator" writes (weight-0) without branching.
    L = cap.max_landmarks
    dtype = g.poses.dtype

    pose_spec = P("chain")
    rep = P()

    def per_shard(poses_l, odo_l, odo_w_sh, prior_pose_l, prior_info_l,
                  obs_pose_l, obs_lm_l, obs_xy_l, counts_l,
                  owner_sh, shared_idx, n_poses, n_landmarks):
        dev = jax.lax.axis_index("chain")
        base = dev * b
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        k_global = base + jnp.arange(b)

        h_diag_l, h_off_l, gp_l = assemble_pose_rows(
            poses_l, odo_l, odo_w_sh, prior_pose_l, prior_info_l, cfg,
            n_poses, n_dev, base, "chain")

        eb = obs_pose_l.shape[0]
        w_l = jnp.asarray(cfg.lm_info, dtype) * \
            (jnp.arange(eb) < counts_l[0]).astype(dtype)
        local_idx = jnp.clip(obs_pose_l - base, 0, b - 1)
        h_diag_lm, w0, w1, hll_part, gp_lm, gl_part = \
            gn._landmark_edge_blocks_split(
                poses_l, lm_xy_rep, local_idx, obs_lm_l, obs_xy_l, w_l, L)
        h_diag_l = h_diag_l + h_diag_lm
        gp_l = gp_l + gp_lm
        hll, gl = jax.lax.psum((hll_part, gl_part), "chain")

        # ---- gauge (same clamping as _apply_gauge_blocked) ----
        free_pose = (k_global >= cfg.fix_first_poses) & (k_global < n_poses)
        fpb = free_pose.astype(dtype)[:, None, None]
        eye3 = jnp.eye(3, dtype=dtype)
        h_diag_l = h_diag_l * fpb + eye3 * (1.0 - fpb)
        prev_free = jnp.concatenate(
            [jax.lax.ppermute(free_pose[-1:], "chain", perm),
             free_pose[:-1]])
        pair = (free_pose & prev_free & (k_global >= 1)).astype(dtype)
        h_off_l = h_off_l * pair[:, None, None]
        kl = jnp.arange(L)
        free_lm = (kl >= cfg.fix_first_landmarks) & (kl < n_landmarks)
        flm = free_lm.astype(dtype)
        w0 = w0 * free_pose.astype(dtype).repeat(3)[:, None] * flm[None, :]
        w1 = w1 * free_pose.astype(dtype).repeat(3)[:, None] * flm[None, :]
        eye2 = jnp.eye(2, dtype=dtype)
        flb = flm[:, None, None]
        hll = hll * flb + eye2 * (1.0 - flb)
        gp_l = gp_l * free_pose.astype(dtype)[:, None]
        gl = gl * flm[:, None]
        if cfg.damping:
            h_diag_l = h_diag_l + eye3 * jnp.asarray(cfg.damping, dtype) * fpb
            hll = hll + eye2 * jnp.asarray(cfg.damping, dtype) * flb

        # ---- eliminate LOCAL landmarks into the block system ----
        loc = (owner_sh[0] == dev) & free_lm
        hll_inv = gn._inv2x2(hll)
        ia, ib_, ic = hll_inv[:, 0, 0], hll_inv[:, 0, 1], hll_inv[:, 1, 1]
        locf = loc.astype(dtype)
        w0_loc = w0 * locf[None, :]
        w1_loc = w1 * locf[None, :]
        wa0 = w0_loc * ia[None, :] + w1_loc * ib_[None, :]
        wa1 = w0_loc * ib_[None, :] + w1_loc * ic[None, :]
        s_block = gn.densify_hpp(h_diag_l, h_off_l) \
            - (wa0 @ w0_loc.T + wa1 @ w1_loc.T)
        gl0, gl1 = gl[:, 0], gl[:, 1]
        g_eff = gp_l.reshape(-1) - (wa0 @ gl0 + wa1 @ gl1)

        # ---- split interior | separator ----
        a_mat = s_block[:3 * ni, :3 * ni]
        b_own = s_block[:3 * ni, 3 * ni:]           # [3ni, 3]
        c_sep = s_block[3 * ni:, 3 * ni:]           # [3, 3]
        g_int = g_eff[:3 * ni]
        g_sep = g_eff[3 * ni:]

        # shared-landmark column gathers (padded index L -> masked out)
        sh_clip = jnp.clip(shared_idx, 0, L - 1)
        sh_ok = (shared_idx < L).astype(dtype)
        w0_sh = w0[:, sh_clip] * sh_ok[None, :]     # [3b, lsh]
        w1_sh = w1[:, sh_clip] * sh_ok[None, :]
        w_sh = jnp.stack([w0_sh, w1_sh], axis=-1).reshape(3 * b, 2 * lsh)

        # ---- B [3ni, m] ----
        b_full = jnp.zeros((3 * ni, m), dtype)
        b_full = jax.lax.dynamic_update_slice(b_full, b_own, (0, 3 * dev))
        # previous separator coupling: edge at k_global = base couples
        # (base-1 = sep_{d-1}, base = interior 0); device 0's write lands in
        # the scratch block [3*n_dev, 3*n_dev+3) with zero weight anyway
        prev_col = jnp.where(dev > 0, 3 * (dev - 1), 3 * n_dev)
        b_full = jax.lax.dynamic_update_slice(b_full, h_off_l[0].T,
                                              (0, prev_col))
        b_full = b_full.at[:, 3 * n_dev + 3:].set(w_sh[:3 * ni])

        # ---- C contribution [m, m] + interface gradient [m] ----
        c_full = jnp.zeros((m, m), dtype)
        c_full = jax.lax.dynamic_update_slice(c_full, c_sep,
                                              (3 * dev, 3 * dev))
        w_sep_sh = w_sh[3 * ni:]                     # [3, 2*lsh]
        c_full = jax.lax.dynamic_update_slice(c_full, w_sep_sh,
                                              (3 * dev, 3 * n_dev + 3))
        c_full = jax.lax.dynamic_update_slice(c_full, w_sep_sh.T,
                                              (3 * n_dev + 3, 3 * dev))
        # shared Hll block-diagonal: contributed once (device 0)
        hll_sh = hll[sh_clip] * sh_ok[:, None, None]     # [lsh, 2, 2]
        once = (dev == 0).astype(dtype)
        r2 = jnp.arange(2 * lsh)
        blk2 = r2 // 2
        same2 = (blk2[:, None] == blk2[None, :]).astype(dtype)
        hll_dense = same2 * jnp.broadcast_to(
            hll_sh.reshape(2 * lsh, 1, 2), (2 * lsh, lsh, 2)
        ).reshape(2 * lsh, 2 * lsh)
        c_full = c_full.at[3 * n_dev + 3:, 3 * n_dev + 3:].add(
            once * hll_dense)
        g_if = jnp.zeros((m,), dtype)
        g_if = jax.lax.dynamic_update_slice(g_if, g_sep, (3 * dev,))
        gl_sh = (gl[sh_clip] * sh_ok[:, None]).reshape(2 * lsh)
        g_if = g_if.at[3 * n_dev + 3:].add(once * gl_sh)

        # ---- local factorization + interface Schur contribution ----
        chol_a = jnp.linalg.cholesky(a_mat)
        x_b = jax.scipy.linalg.cho_solve((chol_a, True), b_full)
        y_g = jax.scipy.linalg.cho_solve((chol_a, True), g_int)
        s_if_part = c_full - b_full.T @ x_b
        g_if_part = g_if - b_full.T @ y_g

        # THE reduction: O(m^2) instead of O(P*L + P^2)
        s_if, g_hat = jax.lax.psum((s_if_part, g_if_part), "chain")

        # inactive interface slots -> identity rows (invalid separators,
        # padded shared columns, the device-0 scratch block)
        sep_valid = jax.lax.all_gather(
            ((base + b - 1) < n_poses).astype(dtype)[None], "chain"
        ).reshape(-1).repeat(3)
        act = jnp.concatenate([sep_valid, jnp.zeros((3,), dtype),
                               sh_ok.repeat(2)])
        s_if = s_if * act[:, None] * act[None, :] + jnp.diag(1.0 - act)
        g_hat = g_hat * act

        # ---- replicated tiny interface solve ----
        chol_if = jnp.linalg.cholesky(s_if)
        dx_if = jax.scipy.linalg.cho_solve((chol_if, True), -g_hat)

        # ---- local back-substitution ----
        dp_int = jax.scipy.linalg.cho_solve(
            (chol_a, True), -g_int - b_full @ dx_if)
        dp_sep = jax.lax.dynamic_slice(dx_if, (3 * dev,), (3,))
        dp_blk = jnp.concatenate([dp_int, dp_sep]).reshape(b, 3)

        # ---- landmark updates ----
        dp_flat = dp_blk.reshape(-1)
        r0 = gl0 + w0_loc.T @ dp_flat
        r1 = gl1 + w1_loc.T @ dp_flat
        dl_loc = -jnp.stack([ia * r0 + ib_ * r1, ib_ * r0 + ic * r1],
                            axis=-1) * locf[:, None]
        dl = jax.lax.psum(dl_loc, "chain")          # owners are disjoint
        dl_sh_pairs = dx_if[3 * n_dev + 3:].reshape(lsh, 2) * sh_ok[:, None]
        dl = dl.at[sh_clip].add(jnp.where((shared_idx < L)[:, None],
                                          dl_sh_pairs, 0.0))

        new_local = poses_l + dp_blk
        new_local = new_local.at[:, 2].set(se2.wrap_angle(new_local[:, 2]))
        new_lm = lm_xy_rep + dl
        return new_local, new_lm

    # lm_xy is replicated; close over it so _landmark_edge_blocks_split and
    # the update read the same array
    lm_xy_rep = g.lm_xy

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(pose_spec, pose_spec, pose_spec, pose_spec, pose_spec,
                  pose_spec, pose_spec, pose_spec, pose_spec,
                  rep, rep, rep, rep),
        out_specs=(pose_spec, rep),
        check_vma=False)
    with jax.default_matmul_precision("highest"):
        new_poses, new_lm = fn(
            g.poses, g.odo_meas, g.odo_w, g.prior_pose, g.prior_info,
            g.obs_pose, g.obs_lm, g.obs_xy, plan.edge_counts,
            plan.owner[None], plan.shared_idx, g.n_poses, g.n_landmarks)
    return dataclasses.replace(g, poses=new_poses, lm_xy=new_lm)
