"""Batched Gauss-Newton with landmark Schur elimination — the GraphSLAM core.

Replaces the reference's g2o stack (`OptimizationAlgorithmGaussNewton` over
`BlockSolver<-1,-1>` + `LinearSolverEigen`, reference src/slam.cpp:53-65 and
461-484) with a dense, batched design:

- All factor residuals/Jacobians evaluate batched
  (tpuslam.backend.residuals — closed forms, no autodiff in the hot path).
- The Hessian is assembled into *dense blocked* structures:
  Hpp (3P x 3P), the pose-landmark coupling W (3P x 2L), and the landmark
  diagonal Hll as [L, 2, 2] blocks. Landmark elimination (Schur complement
  S = Hpp - W Hll^-1 W^T) is one large matmul; at Formula-Student scale
  (P ~ 1e3 poses, L ~ 5e2 landmarks) the reduced system is densified and
  factorized with one dense Cholesky.
- Gauge freedom is fixed exactly as the reference does: the first two poses
  and first two landmarks are clamped (reference src/slam.cpp:464-474),
  implemented by projecting their rows/columns to identity so their update is
  exactly zero.
- The per-shard `assemble` is a pure function of edge arrays, so the
  distributed path (tpuslam.parallel) shard_maps it over the observation axis
  and psums the block contributions into the reduced pose system.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from tpuslam import compat
from tpuslam.backend.graph import FactorGraph
from tpuslam.backend.residuals import landmark_residuals, odometry_residuals
from tpuslam.geometry import se2

__all__ = ["GNConfig", "assemble", "schur_solve", "schur_solve_split",
           "gn_step", "optimize", "chi2", "window_gn_step", "optimize_window"]


@dataclass(frozen=True)
class GNConfig:
    odo_info: float = compat.REF_ODOMETRY_INFO     # I3*5  (src/slam.cpp:456)
    lm_info: float = compat.REF_LANDMARK_INFO      # I2*0.01 (src/slam.cpp:546)
    iterations: int = compat.REF_GN_ITERATIONS     # optimize(10) (src/slam.cpp:481)
    fix_first_poses: int = 2                       # vertices 1000,1001 (src/slam.cpp:464-468)
    fix_first_landmarks: int = 2                   # vertices 0,1 (src/slam.cpp:470-474)
    damping: float = 0.0                           # optional Levenberg diag boost
    matmul_precision: str = "highest"              # dot precision for assembly/Schur:
    # "highest" = full f32; "high" and "default" let the backend use
    # reduced-precision passes (TF32 on a GPU's tensor cores). The normal
    # equations square the conditioning, so "default" is unsafe near
    # closure-scale graphs (mixed-precision graph optimization a la
    # Graphite, PAPERS.md [2]). The reduced-system Cholesky itself always
    # runs in f32.
    solve_bucket_step: int = 128                   # pose-count granularity of the
    # bucketed reduced solve (0 disables). The Cholesky + Schur product run on
    # the smallest bucket covering n_poses instead of the full capacity; the
    # padding region of the gauged system is exactly identity/zero, so every
    # bucket yields bit-identical updates to the full solve.
    edge_bucket_step: int = 2048                   # edge-count granularity of the
    # assembly (0 disables). Landmark-edge residuals/scatters run on the
    # smallest bucket covering n_obs; the edge list is append-only, so the
    # sliced-away tail is exactly the zero-weight padding. Equivalent up to
    # f32 reduction-order rounding (the shorter segment_sum uses a different
    # reduction tree), unlike the pose bucketing which is bit-identical.
    early_exit_tol: float = 0.0                    # stop iterating once the
    # update's max |delta| falls to this tolerance (0 = run all iterations,
    # exactly like the reference's fixed optimize(10), src/slam.cpp:481).
    # GN on these graphs converges in 1-2 iterations (the remaining steps
    # shuffle ~1e-5 f32 noise), so a tol above the noise floor cuts the
    # closure solve ~5x while changing poses by less than the tolerance
    # per skipped step.


def _block_idx(idx, bs):
    """Variable index [E] -> flattened row indices [E, bs]."""
    return idx[:, None] * bs + jnp.arange(bs)[None, :]


def _edge_terms(g: FactorGraph, cfg: GNConfig):
    """Per-edge residual/Jacobian/weight arrays (shared by assemble & chi2)."""
    cap = g.capacity
    dtype = g.poses.dtype

    k = jnp.arange(cap.max_poses)
    odo_valid = (k >= 1) & (k < g.n_poses)
    p_prev = g.poses[jnp.maximum(k - 1, 0)]
    r_o, j_oi, j_oj = odometry_residuals(p_prev, g.poses, g.odo_meas)
    w_o = jnp.asarray(cfg.odo_info, dtype) * odo_valid.astype(dtype) * g.odo_w

    pidx = g.obs_pose
    lidx = g.obs_lm
    r_l, j_lp, j_ll = landmark_residuals(g.poses[pidx], g.lm_xy[lidx], g.obs_xy)
    w_l = jnp.asarray(cfg.lm_info, dtype) * g.obs_valid.astype(dtype)
    return (r_o, j_oi, j_oj, w_o), (r_l, j_lp, j_ll, w_l, pidx, lidx)


def chi2(g: FactorGraph, cfg: GNConfig):
    """Weighted squared error — parity with g2o's verbose chi2 dump.
    Includes the absolute pose priors when present (zero-info = no-op)."""
    (r_o, _, _, w_o), (r_l, _, _, w_l, _, _) = _edge_terms(g, cfg)
    dtype = g.poses.dtype
    pv = g.pose_valid.astype(dtype)
    r_pr = g.poses - g.prior_pose
    r_pr = r_pr.at[:, 2].set(se2.wrap_angle(r_pr[:, 2]))
    prior = jnp.sum(pv * (g.prior_info[:, 0] * jnp.sum(r_pr[:, :2] ** 2, -1)
                          + g.prior_info[:, 1] * r_pr[:, 2] ** 2))
    return (jnp.sum(w_o * jnp.sum(r_o * r_o, -1))
            + jnp.sum(w_l * jnp.sum(r_l * r_l, -1)) + prior)


def assemble_odometry(g: FactorGraph, cfg: GNConfig):
    """Odometry-chain contribution: block-tridiagonal Hpp pieces + gradient.

    Returns (h_diag [P,3,3], h_off [P,3,3], gp [P,3]) where h_off[k] is the
    (k-1, k) super-diagonal block. Pure shifted adds — no scatters: the chain
    structure is static.
    """
    k = jnp.arange(g.capacity.max_poses)
    odo_valid = (k >= 1) & (k < g.n_poses)
    p_prev = g.poses[jnp.maximum(k - 1, 0)]
    r_o, j_oi, j_oj = odometry_residuals(p_prev, g.poses, g.odo_meas)
    dtype = g.poses.dtype
    w_o = jnp.asarray(cfg.odo_info, dtype) * odo_valid.astype(dtype) * g.odo_w

    w3 = w_o[:, None, None]
    jti = jnp.swapaxes(j_oi, -1, -2)
    jtj = jnp.swapaxes(j_oj, -1, -2)
    a_ii = w3 * (jti @ j_oi)   # contribution of edge k to block (k-1, k-1)
    a_jj = w3 * (jtj @ j_oj)   # ... to block (k, k)
    h_off = w3 * (jti @ j_oj)  # ... to block (k-1, k)
    g_i = w_o[:, None] * (jti @ r_o[..., None])[..., 0]
    g_j = w_o[:, None] * (jtj @ r_o[..., None])[..., 0]

    h_diag = a_jj.at[:-1].add(a_ii[1:])
    gp = g_j.at[:-1].add(g_i[1:])

    # absolute pose priors (unary factors, J = I): improved-mode GPS/heading
    # anchoring — zero info means disabled, so the compat path is unaffected
    pose_valid = (k < g.n_poses).astype(dtype)
    ixy = g.prior_info[:, 0] * pose_valid
    ith = g.prior_info[:, 1] * pose_valid
    eye_xy = jnp.zeros((3, 3), dtype).at[0, 0].set(1.0).at[1, 1].set(1.0)
    eye_th = jnp.zeros((3, 3), dtype).at[2, 2].set(1.0)
    h_diag = h_diag + ixy[:, None, None] * eye_xy + ith[:, None, None] * eye_th
    r_prior = g.poses - g.prior_pose
    r_prior = r_prior.at[:, 2].set(se2.wrap_angle(r_prior[:, 2]))
    gp = gp + r_prior * jnp.stack([ixy, ixy, ith], axis=-1)
    return h_diag, h_off, gp


def landmark_edge_blocks(poses, lm_xy, obs_pose, obs_lm, obs_xy, w_l, n_landmarks):
    """Landmark-edge contribution from an (arbitrary shard of the) edge list.

    Returns (h_diag_lm [P,3,3], w_mat [3P,2L], hll [L,2,2], gp_lm [P,3],
    gl [L,2]). All outputs are sums over the given edges, so shard-local
    results from an edge-sharded mesh psum into the full-graph totals —
    this is the distributed-Schur building block (SURVEY.md §2.4).

    Every aggregation here is a one-hot [P,E]@[E,k] matmul, not a
    scatter-add/segment_sum: the form chosen for the code's first
    accelerator, whose compiler lowered indexed scatters to sort-based
    loops. Whether the plain scatter-add is faster on a GPU is not
    measured yet.
    """
    h_diag_lm, w0, w1, hll, gp_lm, gl = _landmark_edge_blocks_split(
        poses, lm_xy, obs_pose, obs_lm, obs_xy, w_l, n_landmarks)
    return h_diag_lm, _interleave_w(w0, w1), hll, gp_lm, gl


def _interleave_w(w0, w1):
    """(W0, W1) [3P,L] halves -> interleaved W [3P,2L] (public layout)."""
    three_p, L = w0.shape
    return jnp.stack([w0, w1], axis=-1).reshape(three_p, 2 * L)


def _landmark_edge_blocks_split(poses, lm_xy, obs_pose, obs_lm, obs_xy, w_l,
                                n_landmarks):
    """`landmark_edge_blocks` with W returned as even/odd column halves
    W0, W1 [3P, L] — the hot-path layout: interleaved [3P, 2L] forces
    stride-2 slicing in the Schur product, while the halves keep every op
    contiguous."""
    P = poses.shape[0]
    L = n_landmarks
    E = obs_pose.shape[0]
    dtype = poses.dtype
    r_l, j_lp, j_ll = landmark_residuals(poses[obs_pose], lm_xy[obs_lm], obs_xy)

    wl3 = w_l[:, None, None]
    jtp = jnp.swapaxes(j_lp, -1, -2)   # [E, 3, 2]
    onehot_p = (obs_pose[None, :] == jnp.arange(P)[:, None]).astype(dtype)  # [P,E]
    onehot_l = (obs_lm[None, :] == jnp.arange(L)[:, None]).astype(dtype)    # [L,E]

    hpp_e = (wl3 * (jtp @ j_lp)).reshape(E, 9)
    h_diag_lm = (onehot_p @ hpp_e).reshape(P, 3, 3)
    gp_lm = onehot_p @ (w_l[:, None] * (jtp @ r_l[..., None])[..., 0])

    # W[3p+i, 2l+j] = sum_e 1[pe=p] 1[le=l] w_e (Jp^T Jl)[e,i,j] — a double
    # one-hot contraction: 3 (i,) rows x 2 j-halves of [P,E]@[E,L] matmuls
    w_e = wl3 * (jtp @ j_ll)                                # [E, 3, 2]
    w0 = jnp.einsum("pe,ei,le->pil", onehot_p, w_e[..., 0],
                    onehot_l).reshape(3 * P, L)
    w1 = jnp.einsum("pe,ei,le->pil", onehot_p, w_e[..., 1],
                    onehot_l).reshape(3 * P, L)

    jtl = jnp.swapaxes(j_ll, -1, -2)
    hll_e = (wl3 * (jtl @ j_ll)).reshape(E, 4)
    hll = (onehot_l @ hll_e).reshape(L, 2, 2)
    gl = onehot_l @ (w_l[:, None] * (jtl @ r_l[..., None])[..., 0])
    return h_diag_lm, w0, w1, hll, gp_lm, gl


def densify_hpp(h_diag, h_off):
    """(P,3,3) diagonal + (P,3,3) super-diagonal blocks -> dense [3P,3P].

    Built with broadcast multiplies against (shifted-)block-identity masks,
    entirely in [3P, 3P] 2-D layout — a fused elementwise pass over the
    output, in place of an indexed scatter or [P,3,P,3]-shaped broadcasts
    (forms with a trailing dim of 3).
    """
    P = h_diag.shape[0]
    tp = 3 * P
    blk = jnp.arange(tp) // 3                                    # [3P]
    same = (blk[:, None] == blk[None, :]).astype(h_diag.dtype)   # [3P,3P]
    up = (blk[None, :] == blk[:, None] + 1).astype(h_diag.dtype)
    # diag term: value at (r, c) is h_diag[r//3, r%3, c%3] -> lay rows out
    # as [3P, 3] and broadcast across column blocks
    d_rows = jnp.broadcast_to(h_diag.reshape(tp, 1, 3),
                              (tp, P, 3)).reshape(tp, tp)
    # off term at (r, c), c//3 == r//3 + 1: value h_off[c//3, r%3, c%3] ->
    # lay columns out as [3, 3P] and broadcast across row blocks
    o_cols = jnp.broadcast_to(
        jnp.transpose(h_off, (1, 0, 2)).reshape(1, 3, tp),
        (P, 3, tp)).reshape(tp, tp)
    h2 = same * d_rows + up * o_cols
    return h2 + up.T * o_cols.T


def _assemble_blocked(g: FactorGraph, cfg: GNConfig):
    """`assemble` without the densification: returns the block-tridiagonal
    pose pieces (h_diag [P,3,3], h_off [P,3,3]) plus W as even/odd halves
    (W0, W1 [3P,L]), Hll [L,2,2], gp [P,3], gl [L,2]. The bucketed solve
    densifies only the active leading blocks."""
    cap = g.capacity
    h_diag, h_off, gp_o = assemble_odometry(g, cfg)
    w_l = (jnp.asarray(cfg.lm_info, g.poses.dtype)
           * g.obs_valid.astype(g.poses.dtype))

    if cfg.edge_bucket_step > 0 and cfg.edge_bucket_step < cap.max_obs:
        # run the edge scatters on the smallest bucket covering n_obs — the
        # edge list is append-only, so the dropped tail is zero-weight padding
        buckets = _pose_buckets(cap.max_obs, cfg.edge_bucket_step)
        sel = jnp.minimum(
            jnp.searchsorted(jnp.asarray(buckets, jnp.int32),
                             g.n_obs.astype(jnp.int32), side="left"),
            len(buckets) - 1)

        def make_branch(b):
            def branch(_):
                return _landmark_edge_blocks_split(
                    g.poses, g.lm_xy, g.obs_pose[:b], g.obs_lm[:b],
                    g.obs_xy[:b], w_l[:b], cap.max_landmarks)
            return branch

        h_diag_lm, w0, w1, hll, gp_lm, gl = jax.lax.switch(
            sel, [make_branch(b) for b in buckets], 0)
    else:
        h_diag_lm, w0, w1, hll, gp_lm, gl = _landmark_edge_blocks_split(
            g.poses, g.lm_xy, g.obs_pose, g.obs_lm, g.obs_xy, w_l,
            cap.max_landmarks)
    return h_diag + h_diag_lm, h_off, w0, w1, hll, gp_o + gp_lm, gl


def assemble(g: FactorGraph, cfg: GNConfig):
    """Build the dense-blocked normal equations.

    Returns (Hpp [3P,3P], W [3P,2L], Hll [L,2,2], gp [3P], gl [L,2]).
    Pure function of the graph arrays; the landmark-edge part is a sum over
    edges, so edge-sharded partial results psum into the same totals.
    """
    h_diag, h_off, w0, w1, hll, gp, gl = _assemble_blocked(g, cfg)
    return (densify_hpp(h_diag, h_off), _interleave_w(w0, w1), hll,
            gp.reshape(-1), gl)


def _inv2x2(m):
    """Batched closed-form 2x2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < 1e-20, 1.0, det)
    inv = jnp.stack([jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def _apply_gauge(g: FactorGraph, cfg: GNConfig, hpp, w_mat, hll, gp, gl):
    """Clamp fixed + padding variables: identity rows/cols, zero gradient."""
    P, L = g.capacity.max_poses, g.capacity.max_landmarks
    dtype = hpp.dtype
    kp = jnp.arange(P)
    free_pose = (kp >= cfg.fix_first_poses) & (kp < g.n_poses)
    kl = jnp.arange(L)
    free_lm = (kl >= cfg.fix_first_landmarks) & (kl < g.n_landmarks)

    fp = jnp.repeat(free_pose.astype(dtype), 3)   # [3P]
    fl2 = jnp.repeat(free_lm.astype(dtype), 2)    # [2L]
    hpp = hpp * fp[:, None] * fp[None, :] + jnp.diag(1.0 - fp)
    w_mat = w_mat * fp[:, None] * fl2[None, :]
    eye2 = jnp.eye(2, dtype=dtype)
    flb = free_lm.astype(dtype)[:, None, None]
    hll = hll * flb + eye2 * (1.0 - flb)
    gp = gp * fp
    gl = gl * free_lm.astype(dtype)[:, None]
    if cfg.damping:
        hpp = hpp + jnp.diag(jnp.asarray(cfg.damping, dtype) * fp)
        hll = hll + eye2 * jnp.asarray(cfg.damping, dtype) * flb
    return hpp, w_mat, hll, gp, gl


def schur_solve(hpp, w_mat, hll, gp, gl):
    """Solve the gauged system via landmark Schur elimination (public,
    interleaved-W form; the hot path uses `schur_solve_split` directly).

    [Hpp  W ] [dp]   [-gp]      S dp = -gp + W Hll^-1 gl,
    [W^T Hll] [dl] = [-gl]  =>  dl   = -Hll^-1 (gl + W^T dp),
    with S = Hpp - W Hll^-1 W^T computed as one matmul.

    NOTE: callers run it under highest matmul precision — reduced-precision
    dot passes (bf16, TF32) wreck the normal equations' conditioning and NaN
    the Cholesky.
    """
    return schur_solve_split(hpp, w_mat[:, 0::2], w_mat[:, 1::2], hll, gp,
                             gl)


def schur_solve_split(hpp, w0, w1, hll, gp, gl):
    """`schur_solve` on even/odd W column halves W0/W1 [3P, L].

    The halves avoid [3P, L, 2] einsum operands and the stride-2 slices
    that would cut them out of the interleaved [3P, 2L] layout: every op
    stays in contiguous [3P, L] layout and the Schur product is two
    matmuls. The factorization is `jnp.linalg.cholesky`.
    """
    hll_inv = _inv2x2(hll)                                   # [L, 2, 2]
    ia, ib, ic = hll_inv[:, 0, 0], hll_inv[:, 0, 1], hll_inv[:, 1, 1]
    wa0 = w0 * ia[None, :] + w1 * ib[None, :]                # W Hll^-1 cols
    wa1 = w0 * ib[None, :] + w1 * ic[None, :]
    s = hpp - (wa0 @ w0.T + wa1 @ w1.T)
    gl0, gl1 = gl[:, 0], gl[:, 1]
    rhs = -gp + (wa0 @ gl0 + wa1 @ gl1)
    c = jnp.linalg.cholesky(s)
    dp = jax.scipy.linalg.cho_solve((c, True), rhs)
    wtdp0 = w0.T @ dp                                        # [L]
    wtdp1 = w1.T @ dp
    r0, r1 = gl0 + wtdp0, gl1 + wtdp1
    dl = -jnp.stack([ia * r0 + ib * r1, ib * r0 + ic * r1], axis=-1)
    return dp, dl


def _pose_buckets(max_poses: int, step: int):
    """Pose-count buckets: multiples of `step` up to capacity (capacity last)."""
    sizes = list(range(step, max_poses, step))
    sizes.append(max_poses)
    return sizes


def _apply_gauge_blocked(g: FactorGraph, cfg: GNConfig, h_diag, h_off,
                         w0, w1, hll, gp, gl):
    """`_apply_gauge` on the block-tridiagonal form, before densification:
    fixed/padding poses get identity diagonal blocks and zeroed couplings —
    entrywise identical to gauging the dense matrix."""
    P, L = g.capacity.max_poses, g.capacity.max_landmarks
    dtype = h_diag.dtype
    kp = jnp.arange(P)
    free_pose = (kp >= cfg.fix_first_poses) & (kp < g.n_poses)
    kl = jnp.arange(L)
    free_lm = (kl >= cfg.fix_first_landmarks) & (kl < g.n_landmarks)

    fpb = free_pose.astype(dtype)[:, None, None]
    eye3 = jnp.eye(3, dtype=dtype)
    h_diag = h_diag * fpb + eye3 * (1.0 - fpb)
    # h_off[k] is the (k-1, k) block: zero unless both endpoints are free
    pair = free_pose & jnp.roll(free_pose, 1)
    pair = pair.at[0].set(False)
    h_off = h_off * pair.astype(dtype)[:, None, None]

    fp = jnp.repeat(free_pose.astype(dtype), 3)   # [3P]
    fl = free_lm.astype(dtype)                    # [L]
    w0 = w0 * fp[:, None] * fl[None, :]
    w1 = w1 * fp[:, None] * fl[None, :]
    eye2 = jnp.eye(2, dtype=dtype)
    flb = free_lm.astype(dtype)[:, None, None]
    hll = hll * flb + eye2 * (1.0 - flb)
    gp = gp * free_pose.astype(dtype)[:, None]
    gl = gl * free_lm.astype(dtype)[:, None]
    if cfg.damping:
        h_diag = h_diag + eye3 * jnp.asarray(cfg.damping, dtype) * fpb
        hll = hll + eye2 * jnp.asarray(cfg.damping, dtype) * flb
    return h_diag, h_off, w0, w1, hll, gp, gl


def _bucketed_schur_solve(n_poses, h_diag, h_off, w0, w1, hll, gp, gl,
                          cfg: GNConfig):
    """Solve on the smallest pose bucket covering n_poses (lax.switch).

    The gauged system's rows past n_poses are exactly identity (Hpp) and zero
    (W, gp), so densifying + factorizing only the leading b pose blocks is
    bit-identical to the full solve while the O(b^3) / O(b^2 L) costs — and
    the densification scatter itself — track the *active* graph, not the
    capacity. Early/periodic optimizations on a growing graph stop paying
    for the empty tail.
    """
    p_cap = h_diag.shape[0]
    buckets = _pose_buckets(p_cap, cfg.solve_bucket_step)
    sel = jnp.searchsorted(jnp.asarray(buckets, jnp.int32),
                           n_poses.astype(jnp.int32), side="left")
    sel = jnp.minimum(sel, len(buckets) - 1)

    def make_branch(b):
        def branch(ops):
            h_diag, h_off, w0, w1, hll, gp, gl = ops
            hpp_b = densify_hpp(h_diag[:b], h_off[:b])
            dp_b, dl = schur_solve_split(
                hpp_b, w0[:3 * b], w1[:3 * b], hll, gp[:b].reshape(-1), gl)
            dp = jnp.zeros((3 * p_cap,), dp_b.dtype).at[:3 * b].set(dp_b)
            return dp, dl
        return branch

    return jax.lax.switch(sel, [make_branch(b) for b in buckets],
                          (h_diag, h_off, w0, w1, hll, gp, gl))


@partial(jax.jit, static_argnames="cfg")
def gn_step(g: FactorGraph, cfg: GNConfig) -> FactorGraph:
    """One Gauss-Newton iteration over the full graph."""
    with jax.default_matmul_precision(cfg.matmul_precision):
        h_diag, h_off, w0, w1, hll, gp2, gl = _assemble_blocked(g, cfg)
        blocks = _apply_gauge_blocked(g, cfg, h_diag, h_off, w0, w1, hll,
                                      gp2, gl)
        if cfg.solve_bucket_step > 0:
            dp, dl = _bucketed_schur_solve(g.n_poses, *blocks, cfg)
        else:
            h_diag, h_off, w0, w1, hll, gp2, gl = blocks
            dp, dl = schur_solve_split(
                densify_hpp(h_diag, h_off), w0, w1, hll, gp2.reshape(-1),
                gl)
    d_pose = dp.reshape(-1, 3)
    poses = g.poses + d_pose
    # wrap only active vertices: rows >= n_poses receive an exact-zero
    # update, and wrap_angle is not a bit-exact identity in f32 — rows a
    # caller has pre-inserted past the pinned n_poses (the blocked
    # pipeline's in-body closure GN) must come through untouched
    act = jnp.arange(poses.shape[0]) < g.n_poses
    poses = poses.at[:, 2].set(
        jnp.where(act, se2.wrap_angle(poses[:, 2]), poses[:, 2]))
    return dataclasses.replace(g, poses=poses, lm_xy=g.lm_xy + dl)


def window_gn_step(g: FactorGraph, cfg: GNConfig, window: int,
                   edge_window: int, landmarks: bool = True,
                   lm_prior=None, end=None, end_obs=None) -> FactorGraph:
    """One fixed-lag GN iteration: refine the trailing `window` poses (and,
    with `landmarks=True`, the map) with everything older marginalized.

    The full periodic re-optimization (`optimize`) costs O(P·E·L) per firing,
    which at a firing every 8 keyframes dominates the improved-full
    pipeline no matter how the solve is bucketed. Fixed-lag smoothing is
    the standard online answer: poses before `n_poses - window` and every
    landmark are constants, so the system is the window's block-tridiagonal
    odometry chain plus pose-block-diagonal landmark terms — a [3W, 3W]
    dense solve with no Schur elimination and no lax.switch, cheap enough
    to run *inside* the blocked pipeline's scans.

    Anchoring: the boundary odometry edge (fixed pose w0-1 -> window row 0)
    contributes only its J_j half, tying the window to the fixed prefix;
    GPS/heading priors of window poses apply as usual; in clamp-gauge
    (reference-compat) configs the global fix_first_poses rows clamp exactly
    as in `gn_step`. `edge_window` is a completeness knob, not a correctness
    one: the trailing `edge_window` edges are considered, and any window
    pose whose edges scrolled out is simply constrained by fewer factors
    (both the per-frame and blocked paths use the same slice, so they stay
    bit-equal).

    `landmarks=True` (the production mode) also refines the map: every
    landmark joins the system, anchored by the information of its
    MARGINALIZED (out-of-window) observations as a Gaussian prior. Because
    the landmark Jacobian of an observation edge is a pure rotation
    (J_ll = R^T, backend/residuals.py), each edge contributes exactly
    `lm_info * I2` to its landmark's Hll — so the marginal prior carries
    information `lm_info * n_out * I2`, and the assembled Hll is just
    `lm_info * n_total * I2`: the full-batch Hll, for free. The prior's
    MEAN is `lm_prior` — the estimate at the start of the firing, which is
    the previous firing's posterior (nothing else moves existing landmarks
    between firings) — contributing the restoring gradient
    `lm_info * n_out * (x - lm_prior)`. This is the standard recursive
    fixed-lag prior update (posterior mean of firing k becomes the prior
    mean of firing k+1); with `lm_prior=None` the prior centers at the
    current estimate (zero gradient — damping only, the pre-r4 behavior,
    kept for single-step callers). Oracle: a stationary window converges
    to the information-weighted mean of prior and in-window measurements
    (tests/test_backend.py::test_window_gn_marginal_prior_restores).
    Only in-window edges contribute coupling; landmarks untouched by the
    window (n_out = 0 and no in-window edges) receive an exact-zero update.
    The solve is the same Schur elimination as the full GN, at [3W, L]
    instead of [3P, L]. With `landmarks=False` the map is constant and the
    system is pose-only block-tridiagonal.
    """
    W, EW = window, edge_window
    dtype = g.poses.dtype
    # `end`/`end_obs` (traced, optional) re-anchor the window at a PAST
    # pose/edge count instead of the graph head — the blocked pipeline's
    # mid-block firings refine the window that ended at the firing frame
    # (poses/edges committed later are excluded from the system and get
    # exact-zero updates; landmarks with no edge before `end_obs` collapse
    # to identity rows, so later-created landmarks are untouched too)
    n = g.n_poses if end is None else end
    e_stop = g.n_obs if end_obs is None else end_obs
    w0 = jnp.maximum(n - W, 0)
    poses_w = jax.lax.dynamic_slice(g.poses, (w0, 0), (W, 3))
    odo_meas_w = jax.lax.dynamic_slice(g.odo_meas, (w0, 0), (W, 3))
    odo_ww = jax.lax.dynamic_slice(g.odo_w, (w0,), (W,))
    prior_pose_w = jax.lax.dynamic_slice(g.prior_pose, (w0, 0), (W, 3))
    prior_info_w = jax.lax.dynamic_slice(g.prior_info, (w0, 0), (W, 2))
    kg = w0 + jnp.arange(W)                       # global pose index per row

    # ---- odometry chain within the window (+ the fixed boundary edge)
    prev0 = g.poses[jnp.maximum(w0 - 1, 0)]
    p_prev = jnp.concatenate([prev0[None, :], poses_w[:-1]], axis=0)
    odo_valid = (kg >= 1) & (kg < n)
    r_o, j_oi, j_oj = odometry_residuals(p_prev, poses_w, odo_meas_w)
    w_o = jnp.asarray(cfg.odo_info, dtype) * odo_valid.astype(dtype) * odo_ww
    w3 = w_o[:, None, None]
    jti = jnp.swapaxes(j_oi, -1, -2)
    jtj = jnp.swapaxes(j_oj, -1, -2)
    a_ii = w3 * (jti @ j_oi)
    a_jj = w3 * (jtj @ j_oj)
    h_off = w3 * (jti @ j_oj)                     # block (r-1, r)
    g_i = w_o[:, None] * (jti @ r_o[..., None])[..., 0]
    g_j = w_o[:, None] * (jtj @ r_o[..., None])[..., 0]
    # row 0's i-side belongs to the fixed pose w0-1: its diagonal/gradient
    # contribution and the coupling block leave the free system entirely
    h_diag = a_jj.at[:-1].add(a_ii[1:])
    h_off = h_off.at[0].set(0.0)
    gp = g_j.at[:-1].add(g_i[1:])

    # ---- GPS/heading priors of window poses
    pose_valid = (kg < n).astype(dtype)
    ixy = prior_info_w[:, 0] * pose_valid
    ith = prior_info_w[:, 1] * pose_valid
    eye_xy = jnp.zeros((3, 3), dtype).at[0, 0].set(1.0).at[1, 1].set(1.0)
    eye_th = jnp.zeros((3, 3), dtype).at[2, 2].set(1.0)
    h_diag = h_diag + ixy[:, None, None] * eye_xy + ith[:, None, None] * eye_th
    r_pr = poses_w - prior_pose_w
    r_pr = r_pr.at[:, 2].set(se2.wrap_angle(r_pr[:, 2]))
    gp = gp + r_pr * jnp.stack([ixy, ixy, ith], axis=-1)

    # ---- trailing landmark edges
    L = g.capacity.max_landmarks
    e0 = jnp.maximum(e_stop - EW, 0)
    op = jax.lax.dynamic_slice(g.obs_pose, (e0,), (EW,))
    ol = jax.lax.dynamic_slice(g.obs_lm, (e0,), (EW,))
    oxy = jax.lax.dynamic_slice(g.obs_xy, (e0, 0), (EW, 2))
    ke = e0 + jnp.arange(EW)
    w_l = jnp.asarray(cfg.lm_info, dtype) * \
        ((ke < e_stop) & (op >= w0)).astype(dtype)
    local = jnp.clip(op - w0, 0, W - 1)
    r_l, j_lp, j_ll = landmark_residuals(poses_w[local], g.lm_xy[ol], oxy)
    wl3 = w_l[:, None, None]
    jtp = jnp.swapaxes(j_lp, -1, -2)
    onehot_p = (local[None, :] == jnp.arange(W)[:, None]).astype(dtype)
    hpp_e = (wl3 * (jtp @ j_lp)).reshape(EW, 9)
    # one-hot sums outside the precision scope below: pinned to full f32
    hi = jax.lax.Precision.HIGHEST
    h_diag = h_diag + jnp.matmul(onehot_p, hpp_e, precision=hi).reshape(
        W, 3, 3)
    gp = gp + jnp.matmul(onehot_p, w_l[:, None]
                         * (jtp @ r_l[..., None])[..., 0], precision=hi)

    # ---- gauge clamping by GLOBAL index (same rows gn_step clamps)
    free = (kg >= cfg.fix_first_poses) & (kg < n)
    fpb = free.astype(dtype)[:, None, None]
    eye3 = jnp.eye(3, dtype=dtype)
    h_diag = h_diag * fpb + eye3 * (1.0 - fpb)
    prev_free = jnp.concatenate([jnp.zeros((1,), bool), free[:-1]])
    pair = (free & prev_free).astype(dtype)
    h_off = h_off * pair[:, None, None]
    gp = gp * free.astype(dtype)[:, None]
    if cfg.damping:
        h_diag = h_diag + eye3 * jnp.asarray(cfg.damping, dtype) * fpb

    with jax.default_matmul_precision(cfg.matmul_precision):
        if landmarks:
            # free-map window system: Hll from TOTAL per-landmark counts
            # (marginal prior + in-window edges collapse to lm_info*n*I2),
            # W/gl from in-window edges only; Schur-eliminate as usual
            kl = jnp.arange(L)
            e_all = g.obs_pose.shape[0]
            ve = (jnp.arange(e_all) < e_stop).astype(dtype)
            onehot_tot = (g.obs_lm[None, :] == kl[:, None]).astype(dtype)
            n_tot = onehot_tot @ ve                              # [L]
            free_lm = (kl >= cfg.fix_first_landmarks) & (kl < g.n_landmarks)
            flm = free_lm.astype(dtype)
            eye2 = jnp.eye(2, dtype=dtype)
            hll_d = jnp.asarray(cfg.lm_info, dtype) * n_tot * flm
            # clamped/unobserved rows get exact identity (zero gradient ->
            # exact-zero update)
            hll = jnp.where(hll_d > 0, hll_d, 1.0)[:, None, None] * eye2
            if cfg.damping:
                hll = hll + eye2 * jnp.asarray(cfg.damping, dtype) \
                    * flm[:, None, None]
            onehot_l = (ol[None, :] == kl[:, None]).astype(dtype)   # [L,EW]
            w_e = wl3 * (jtp @ j_ll)                             # [EW, 3, 2]
            fp3 = free.astype(dtype).repeat(3)
            w0c = jnp.einsum("we,ei,le->wil", onehot_p, w_e[..., 0],
                             onehot_l).reshape(3 * W, L) \
                * fp3[:, None] * flm[None, :]
            w1c = jnp.einsum("we,ei,le->wil", onehot_p, w_e[..., 1],
                             onehot_l).reshape(3 * W, L) \
                * fp3[:, None] * flm[None, :]
            jtl = jnp.swapaxes(j_ll, -1, -2)
            gl = (onehot_l @ (w_l[:, None] * (jtl @ r_l[..., None])[..., 0])) \
                * flm[:, None]
            if lm_prior is not None:
                # restoring gradient of the marginalized-information prior
                # (mean = start-of-firing estimate); n_out = total obs minus
                # in-window obs per landmark
                ve_in = ((ke < e_stop) & (op >= w0)).astype(dtype)
                n_out = jnp.maximum(n_tot - onehot_l @ ve_in, 0.0)
                gl = gl + (jnp.asarray(cfg.lm_info, dtype) * n_out
                           * flm)[:, None] * (g.lm_xy - lm_prior)
            hpp = densify_hpp(h_diag, h_off)
            dp, dl = schur_solve_split(hpp, w0c, w1c, hll,
                                       gp.reshape(-1), gl)
            new_lm = g.lm_xy + dl
        else:
            # ---- dense pose-only [3W, 3W] solve
            hpp = densify_hpp(h_diag, h_off)
            c = jnp.linalg.cholesky(hpp)
            dp = jax.scipy.linalg.cho_solve((c, True), -gp.reshape(-1))
            new_lm = g.lm_xy
    new_w = poses_w + dp.reshape(W, 3)
    # clamped rows receive an exact-zero update; keep them bit-identical
    # (wrap_angle is not a bit-exact identity in f32)
    new_w = new_w.at[:, 2].set(
        jnp.where(free, se2.wrap_angle(new_w[:, 2]), new_w[:, 2]))
    return dataclasses.replace(
        g, poses=jax.lax.dynamic_update_slice(g.poses, new_w, (w0, 0)),
        lm_xy=new_lm)


@partial(jax.jit, static_argnames=("cfg", "window", "edge_window",
                                   "landmarks"))
def optimize_window(g: FactorGraph, cfg: GNConfig, window: int,
                    edge_window: int, enable=None,
                    landmarks: bool = True, end=None,
                    end_obs=None) -> FactorGraph:
    """`optimize`'s loop shell around `window_gn_step` (fixed-lag
    refinement). Straight-line per iteration — no bucketing, no lax.switch —
    so it is safe inside scans and under vmap; `enable=False` is an exact
    zero-trip identity.

    With `landmarks=True` the marginalized-information landmark prior is
    anchored at the ENTRY estimate (the previous firing's posterior — see
    window_gn_step's docstring), so out-of-window observations exert a true
    restoring force across the firing's iterations instead of only damping
    the step (ADVICE r3).

    `end`/`end_obs` (traced, optional) anchor the window at a past
    pose/edge count instead of the graph head — the blocked pipeline's
    mid-block firings (see window_gn_step)."""
    iters = jnp.int32(cfg.iterations)
    if enable is not None:
        iters = jnp.where(enable, iters, 0)
    tol = jnp.asarray(cfg.early_exit_tol, g.poses.dtype) \
        if cfg.early_exit_tol > 0.0 else jnp.asarray(-jnp.inf, g.poses.dtype)
    lm_prior = g.lm_xy if landmarks else None

    def cond(carry):
        _, i, delta = carry
        return (i < iters) & (delta > tol)

    def body(carry):
        gg, i, _ = carry
        g2 = window_gn_step(gg, cfg, window, edge_window,
                            landmarks=landmarks, lm_prior=lm_prior,
                            end=end, end_obs=end_obs)
        delta = jnp.maximum(jnp.max(jnp.abs(g2.poses - gg.poses)),
                            jnp.max(jnp.abs(g2.lm_xy - gg.lm_xy)))
        return g2, i + 1, delta

    out, _, _ = jax.lax.while_loop(
        cond, body, (g, jnp.int32(0), jnp.asarray(jnp.inf, g.poses.dtype)))
    return out


@partial(jax.jit, static_argnames="cfg")
def optimize(g: FactorGraph, cfg: GNConfig, enable=None) -> FactorGraph:
    """Run `cfg.iterations` GN iterations (reference runs 10, src/slam.cpp:481).

    With `cfg.early_exit_tol > 0` the loop stops as soon as an iteration's
    max |update| (poses and landmarks) drops to the tolerance — same fixed
    upper bound, measurably identical result (each skipped step would have
    moved the estimate by less than the tolerance).

    `enable` (traced bool, optional) gates the whole optimization via the
    loop's trip count: False = zero iterations = exact identity. Callers
    inside scans should prefer `optimize(g, cfg, enable=flag)` over
    `lax.cond(flag, optimize, identity)` — a zero-trip while_loop skips the
    assemble/solve body entirely, whereas a conditional carrying the graph
    state forces per-iteration buffer copies of the branch operands.
    """
    iters = jnp.int32(cfg.iterations)
    if enable is not None:
        iters = jnp.where(enable, iters, 0)
    # early_exit_tol == 0 degenerates to a pure count loop (delta > -inf),
    # executing the exact same gn_step sequence the fori form did.
    tol = jnp.asarray(cfg.early_exit_tol, g.poses.dtype) \
        if cfg.early_exit_tol > 0.0 else jnp.asarray(-jnp.inf, g.poses.dtype)

    def cond(carry):
        gg, i, delta = carry
        return (i < iters) & (delta > tol)

    def body(carry):
        gg, i, _ = carry
        g2 = gn_step(gg, cfg)
        delta = jnp.maximum(jnp.max(jnp.abs(g2.poses - gg.poses)),
                            jnp.max(jnp.abs(g2.lm_xy - gg.lm_xy)))
        return g2, i + 1, delta

    out, _, _ = jax.lax.while_loop(
        cond, body, (g, jnp.int32(0), jnp.asarray(jnp.inf, g.poses.dtype)))
    return out
