"""Cone detection from lidar point clouds — the "attention" front-end.

The reference pipeline's cone detector is the sibling
`cfsd18-sensation-attention` microservice (its full parameterization is
preserved in reference usecase/docker-compose.yml:34: ROI boundaries, RANSAC
ground plane with dot/inlier thresholds and 10 iterations, connected
clustering at 0.4 m, 2..80 points per cone, near/far radius and z-range
validation). That service is CPU C++ with sequential region growing; this is
the data-parallel redesign:

- ROI + ground removal as masked vector ops.
- RANSAC ground plane: all hypotheses evaluated at once (iterations x N
  point-plane distances — one matmul-shaped reduction instead of a loop).
- Clustering: connected components via min-label propagation. Two providers:
  the dense path materializes the (N x N) radius adjacency (exact, fine to
  ~4k points); the grid path hashes points into connect-radius cells over
  the static ROI extent and propagates labels over each point's 3x3-cell
  candidate list — O(N * 9 * cell_capacity) memory, which is what lets a
  full ~29k-return VLP-16 sweep (10 Hz rev) run on device where the dense
  adjacency would need 3.4 GB.
- Cluster statistics/validation via segment reductions.

Everything is fixed-shape jnp and jit-compatible; point capacity is the
static bound (pad + mask).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["AttentionConfig", "detect_cones"]


@dataclass(frozen=True)
class AttentionConfig:
    # defaults = reference usecase/docker-compose.yml:34 flags
    x_boundary: float = 4.0            # lateral half-width of ROI [m]
    y_boundary: float = 12.0           # forward extent of ROI [m]
    ground_layer_z: float = -0.3       # fallback ground height [m]
    cone_height: float = 0.5
    connect_distance_threshold: float = 0.4
    min_points: int = 2
    max_points: int = 80
    far_cone_radius: float = 0.2
    near_cone_radius: float = 0.25
    near_range: float = 6.0            # near/far split for radius gating
    z_range_threshold: float = 0.08    # unused spare from the reference set
    inlier_range_threshold: float = 0.06
    dot_threshold: float = 0.1         # |normal x z| tolerance
    inlier_found_threshold: int = 150
    ransac_iterations: int = 10
    label_iterations: int = 8          # min-label propagation rounds. With
    # the x2 pointer jumping each round triples a label's reach, so 8 rounds
    # cover component diameters far beyond any cone cluster (~3 cells);
    # on a full 28.8k-point sweep 8 rounds produce detections identical to 16
    max_cones: int = 64
    sensor_height: float = 0.0         # sensor z above ground
    # clustering provider: 'dense' = exact NxN adjacency; 'grid' = hashed
    # 3x3-cell candidate lists (full-sweep scale); 'auto' picks grid above
    # dense_max_points
    clustering: str = "auto"
    dense_max_points: int = 4096
    cell_capacity: int = 32            # cell-table slots per grid cell: the
    # label loop is O(C * K * 9K), so K is quadratic leverage (K=32 gives
    # detections identical to K=64 on the full-sweep scene). Ground-masked obstacle points rarely exceed ~16
    # per 0.4 m cell; a single cone overflowing one cell folds into that
    # cell's rank-0 component, which IS its cluster (capacity caveat in
    # _connected_components_grid)
    point_capacity: int = 4096         # service-side device buffer size
    host_prefilter: bool = True        # ROI-filter on host before device pad


def _ransac_ground(points, valid, cfg: AttentionConfig, key):
    """Vectorized RANSAC plane fit; returns signed height above ground [N]."""
    n = points.shape[0]
    iters = cfg.ransac_iterations
    idx = jax.random.randint(key, (iters, 3), 0, n)
    tri = points[idx]                                  # [I, 3, 3]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    normal = jnp.cross(v1, v2)
    norm = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / jnp.maximum(norm, 1e-9)
    # plane must be near-horizontal (reference dotThreshold)
    horiz = jnp.abs(normal[:, 2]) > (1.0 - cfg.dot_threshold)
    d = -jnp.sum(normal * tri[:, 0], axis=-1)          # [I]
    dist = jnp.abs(points @ normal.T + d[None, :])     # [N, I]
    inliers = jnp.sum((dist < cfg.inlier_range_threshold) & valid[:, None],
                      axis=0)
    score = jnp.where(horiz, inliers, -1)
    best = jnp.argmax(score)
    ok = score[best] >= cfg.inlier_found_threshold
    sign = jnp.sign(normal[best, 2])
    height_plane = (points @ normal[best] + d[best]) * sign
    height_flat = points[:, 2] - cfg.ground_layer_z
    return jnp.where(ok, height_plane, height_flat)


def _connected_components(points_xy, valid, cfg: AttentionConfig):
    """Min-label propagation over the radius graph -> root labels [N]."""
    n = points_xy.shape[0]
    d = points_xy[:, None, :] - points_xy[None, :, :]
    d2 = jnp.sum(d * d, axis=-1)
    thr2 = cfg.connect_distance_threshold ** 2
    adj = (d2 < thr2) & valid[:, None] & valid[None, :]
    labels = jnp.where(valid, jnp.arange(n), n)

    def body(_, lab):
        neigh = jnp.where(adj, lab[None, :], n)
        return jnp.minimum(lab, jnp.min(neigh, axis=1))

    # 2x plain rounds instead of the grid provider's jump-compressed rounds:
    # no [N] pointer-jump gather, and doubling the [N, N] masked-min rounds
    # restores the same worst-case chain reach (barrier diameters
    # ~2*label_iterations hops)
    return jax.lax.fori_loop(0, 2 * cfg.label_iterations, body, labels)


def _connected_components_grid(points_xy, valid, cfg: AttentionConfig):
    """Grid-hashed connected components for full-sweep point counts.

    The dense provider's NxN adjacency is 3.4 GB at a real 29k-return VLP-16
    sweep. Here points hash into square cells of side h =
    connect_distance_threshold over the static ROI extent (valid points are
    always inside the ROI — detect_cones masks first), so any neighbor
    within h lies in the 3x3 cell neighborhood. Points pack into a dense
    [cells, cell_capacity] table and the label loop touches neighbors via
    9 STATIC jnp.roll shifts of the [nx, ny, K] grid — zero per-point
    gathers in the hot loop (a form chosen for the code's first
    accelerator; the gather form is not measured on a GPU yet); the masked
    min over [cells, K, 9K] is elementwise work.
    Labels are table-slot ids (min-slot hooking + pointer jumping via one
    tiny [cells*K] gather), mapped back to per-point original-index
    representatives at the end.

    Capacity caveat: points beyond `cell_capacity` in one cell (> K returns
    inside one h x h cell — an ultra-dense blob, not a cone) are attached to
    their cell's rank-0 component rather than distance-checked; such blobs
    exceed max_points and are rejected by cluster validation anyway.
    """
    n = points_xy.shape[0]
    h = cfg.connect_distance_threshold
    # static grid over the ROI (+1 pad cell each side: valid points land in
    # [1, n-2], so 3x3 roll wrap-around only ever brings empty pad rows)
    nx = int(math.ceil(cfg.y_boundary / h)) + 3
    ny = int(math.ceil(2.0 * cfg.x_boundary / h)) + 3
    c = nx * ny
    k = cfg.cell_capacity
    cx = jnp.clip(jnp.floor(points_xy[:, 0] / h).astype(jnp.int32) + 1,
                  0, nx - 1)
    cy = jnp.clip(jnp.floor((points_xy[:, 1] + cfg.x_boundary) / h)
                  .astype(jnp.int32) + 1, 0, ny - 1)
    cell = jnp.where(valid, cx * ny + cy, c)
    order = jnp.argsort(cell)                       # stable: ties by index
    sorted_cell = cell[order]
    bounds = jnp.searchsorted(sorted_cell, jnp.arange(c + 1))

    # dense cell table: tbl[cell, rank] = original point index (n = empty)
    cnt = bounds[1:] - bounds[:-1]                              # [C]
    slot = bounds[:c, None] + jnp.arange(k)[None, :]            # [C, K]
    occ = jnp.arange(k)[None, :] < cnt[:, None]
    tbl = jnp.where(occ, order[jnp.clip(slot, 0, n - 1)], n)
    txy = points_xy[jnp.clip(tbl, 0, n - 1)]                    # [C, K, 2]

    def neigh(x):
        """[C, K, ...] -> [C, 9K, ...]: the 3x3 cell neighborhood, via
        static rolls (no gather)."""
        g = x.reshape(nx, ny, *x.shape[1:])
        rolls = [jnp.roll(g, (-dx, -dy), (0, 1))
                 for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
        return jnp.stack(rolls, axis=2).reshape(c, 9 * k, *x.shape[2:])

    nbr_occ = neigh(occ)                                        # [C, 9K]
    nbr_xy = neigh(txy)                                         # [C, 9K, 2]
    diff = txy[:, :, None, :] - nbr_xy[:, None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    adj = occ[:, :, None] & nbr_occ[:, None, :] & (d2 < h * h)  # [C, K, 9K]

    sent = c * k                                     # sentinel slot id
    lab0 = jnp.where(occ, jnp.arange(sent).reshape(c, k), sent)

    def body(_, lab):
        nbr_lab = neigh(lab)                                    # [C, 9K]
        m = jnp.min(jnp.where(adj, nbr_lab[:, None, :], sent), axis=2)
        lab = jnp.minimum(lab, m)
        fl = lab.reshape(-1)
        fl_pad = jnp.concatenate([fl, jnp.asarray([sent])])
        fl = jnp.minimum(fl, fl_pad[fl])             # pointer jumping x2
        fl_pad = jnp.concatenate([fl, jnp.asarray([sent])])
        return jnp.minimum(fl, fl_pad[fl]).reshape(c, k)

    lab = jax.lax.fori_loop(0, cfg.label_iterations, body, lab0)

    # slot labels -> per-point labels (representative = root slot's point)
    root_pt = jnp.concatenate([tbl.reshape(-1), jnp.asarray([n])])[
        lab.reshape(-1)]                                        # [C*K]
    rank = jnp.arange(n) - bounds[jnp.clip(sorted_cell, 0, c - 1)]
    real = sorted_cell < c
    slot_of = jnp.where(real & (rank < k),
                        jnp.clip(sorted_cell, 0, c - 1) * k
                        + jnp.clip(rank, 0, k - 1),
                        jnp.where(real, jnp.clip(sorted_cell, 0, c - 1) * k,
                                  sent))
    lab_sorted = jnp.concatenate([root_pt, jnp.asarray([n])])[slot_of]
    return jnp.full(n, n, lab_sorted.dtype).at[order].set(lab_sorted)


@partial(jax.jit, static_argnames="cfg")
def grid_cell_overflow(points, valid, cfg: AttentionConfig):
    """Diagnostic counter for the grid-clustering capacity caveat (ADVICE
    r3): number of points beyond `cell_capacity` in their hash cell — those
    fold into the cell's rank-0 component instead of being distance-checked
    (see `_connected_components_grid`). Run on ground-MASKED points (the
    same [N, 2] xy + validity the label loop sees) to decide whether the
    tuned K=32 silently truncates on a denser-than-tuning scene; nonzero
    overflow on a scene with legitimate cone-sized clusters means K should
    be raised for that deployment."""
    h = cfg.connect_distance_threshold
    nx = int(math.ceil(cfg.y_boundary / h)) + 3
    ny = int(math.ceil(2.0 * cfg.x_boundary / h)) + 3
    c = nx * ny
    cx = jnp.clip(jnp.floor(points[:, 0] / h).astype(jnp.int32) + 1,
                  0, nx - 1)
    cy = jnp.clip(jnp.floor((points[:, 1] + cfg.x_boundary) / h)
                  .astype(jnp.int32) + 1, 0, ny - 1)
    cell = jnp.where(valid, cx * ny + cy, c)
    cnt = jnp.zeros((c + 1,), jnp.int32).at[cell].add(1)
    return jnp.sum(jnp.maximum(cnt[:c] - cfg.cell_capacity, 0))


@partial(jax.jit, static_argnames="cfg")
def detect_cones(points, valid, cfg: AttentionConfig, seed=0, intensity=None):
    """Point cloud [N,3] (sensor frame: x fwd, y left, z up) -> cone tuples.

    Returns (cones [K,4] = (azimuth_deg, zenith_deg, distance_m, type),
    cone_valid [K], n_cones). Types come from mean cluster intensity via the
    convention type=round(intensity/10) (a stand-in classifier — the real
    CFSD18 color classification lived in a separate vision service); 0 when
    no intensity is given.
    """
    n = points.shape[0]
    key = jax.random.PRNGKey(seed)

    roi = (valid
           & (jnp.abs(points[:, 1]) <= cfg.x_boundary)
           & (points[:, 0] > 0.1) & (points[:, 0] <= cfg.y_boundary))
    height = _ransac_ground(points, roi, cfg, key)
    obstacle = roi & (height > cfg.inlier_range_threshold) & \
        (height < cfg.cone_height + 0.3)

    use_grid = cfg.clustering == "grid" or (
        cfg.clustering == "auto" and n > cfg.dense_max_points)
    cc = _connected_components_grid if use_grid else _connected_components
    labels = cc(points[:, :2], obstacle, cfg)

    w = obstacle.astype(points.dtype)
    counts = jax.ops.segment_sum(w, labels, num_segments=n + 1)[:n]
    sums = jax.ops.segment_sum(points * w[:, None], labels,
                               num_segments=n + 1)[:n]
    safe = jnp.maximum(counts, 1.0)
    centroid = sums / safe[:, None]

    # xy scatter radius per cluster
    dxy = points[:, :2] - centroid[labels.clip(0, n - 1), :2]
    r2 = jnp.sum(dxy * dxy, axis=-1) * w
    rmax2 = jax.ops.segment_max(jnp.where(obstacle, r2, -1.0), labels,
                                num_segments=n + 1)[:n]

    is_root = counts > 0
    dist = jnp.linalg.norm(centroid[:, :2], axis=-1)
    r_gate = jnp.where(dist < cfg.near_range, cfg.near_cone_radius,
                       cfg.far_cone_radius)
    good = (is_root
            & (counts >= cfg.min_points) & (counts <= cfg.max_points)
            & (rmax2 <= r_gate ** 2))

    # rank clusters by distance, take the first max_cones
    order = jnp.argsort(jnp.where(good, dist, jnp.inf))
    k = cfg.max_cones
    sel = order[:k]
    sel_good = good[sel]
    c = centroid[sel]
    az = jnp.degrees(jnp.arctan2(c[:, 1], c[:, 0]))
    rng = jnp.linalg.norm(c, axis=-1)
    zen = jnp.degrees(jnp.arcsin(jnp.clip((c[:, 2] + cfg.sensor_height)
                                          / jnp.maximum(rng, 1e-6), -1, 1)))
    if intensity is not None:
        isum = jax.ops.segment_sum(intensity * w, labels, num_segments=n + 1)[:n]
        ctype = jnp.round(isum[sel] / jnp.maximum(counts[sel], 1.0) / 10.0)
    else:
        ctype = jnp.zeros(k, points.dtype)
    cones = jnp.stack([az, zen, rng, ctype], axis=-1)
    return cones, sel_good, jnp.sum(sel_good.astype(jnp.int32))
