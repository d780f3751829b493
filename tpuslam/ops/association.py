"""Batched observation-to-landmark data association.

Replaces the reference's per-observation linear scan of the map
(reference src/slam.cpp:570-607 mapping, :350-383 localization — O(N*M)
sequential with early exit) with a single (N x M) cost-matrix computation plus
masked reductions: one batched program, no data-dependent control flow.

Three policies:
- 'first':       FIRST landmark in index order within the Euclidean gate and
                 with equal type — the reference's exact semantics (its while
                 loop takes the first hit, not the nearest; src/slam.cpp:575-584).
- 'nearest':     nearest landmark within the Euclidean gate (clean NN).
- 'mahalanobis': nearest by Mahalanobis distance with per-landmark 2x2
                 covariances, gated by a chi-square threshold (the
                 generalization BASELINE.json mandates).
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["cost_matrix", "associate"]

_BIG = 1e30


def cost_matrix(obs_xy, lm_xy, lm_cov_inv=None):
    """Pairwise squared distances [N, M]; Mahalanobis if `lm_cov_inv` given.

    obs_xy [N, 2] (global frame), lm_xy [M, 2], lm_cov_inv [M, 2, 2] optional.
    """
    d = obs_xy[:, None, :] - lm_xy[None, :, :]                  # [N, M, 2]
    if lm_cov_inv is None:
        return jnp.sum(d * d, axis=-1)
    sd = jnp.einsum("nmk,mkl->nml", d, lm_cov_inv)
    return jnp.sum(sd * d, axis=-1)


def associate(obs_xy, obs_type, obs_valid, lm_xy, lm_type, lm_valid,
              gate, mode="first", lm_cov_inv=None, type_signed_bug=False):
    """Associate each observation with at most one landmark.

    Args:
      obs_xy [N,2] global-frame observations; obs_type [N] int; obs_valid [N] bool.
      lm_xy [M,2]; lm_type [M] int; lm_valid [M] bool.
      gate: squared-distance gate is `gate**2` for Euclidean modes, or the
            chi-square bound itself for 'mahalanobis'.
      mode: 'first' | 'nearest' | 'mahalanobis'.
      type_signed_bug: reproduce reference src/slam.cpp:360 where the
            localizer compares (map_type - obs_type) < 1e-4 WITHOUT fabs, so a
            lower-typed map cone matches any higher-typed observation.

    Returns (match_idx [N] int32, matched [N] bool, cost [N] f32).
    """
    if mode == "mahalanobis":
        if lm_cov_inv is None:
            raise ValueError("mahalanobis mode needs lm_cov_inv")
        c = cost_matrix(obs_xy, lm_xy, lm_cov_inv)
        gate2 = gate
    else:
        c = cost_matrix(obs_xy, lm_xy)
        gate2 = gate * gate

    if type_signed_bug:
        type_ok = (lm_type[None, :] - obs_type[:, None]) < 1e-4
    else:
        type_ok = lm_type[None, :] == obs_type[:, None]
    ok = type_ok & lm_valid[None, :] & obs_valid[:, None] & (c < gate2)

    if mode == "first":
        # first True along the landmark axis (argmax of bool)
        idx = jnp.argmax(ok, axis=1).astype(jnp.int32)
    else:
        idx = jnp.argmin(jnp.where(ok, c, _BIG), axis=1).astype(jnp.int32)
    matched = jnp.any(ok, axis=1)
    chosen_cost = jnp.take_along_axis(c, idx[:, None], axis=1)[:, 0]
    return idx, matched, jnp.where(matched, chosen_cost, _BIG)
