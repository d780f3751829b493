"""Device-mesh setup for pod-scale mapping.

The reference has no distributed layer at all (SURVEY.md §2.4 — one process,
one node, pub/sub over UDP multicast). This framework's two parallel axes:

- 'sessions': data parallelism over independent mapping sessions (multi-lap /
  multi-car "multi-session pod-scale mapping" in BASELINE.json) — no
  communication except at solve reductions.
- 'edges': model parallelism *within* a session — the landmark-observation
  edge list is sharded, each device assembles partial normal-equation blocks,
  and `psum` over this axis carries the distributed Schur reduction. On the
  cards of one host XLA hands it to NCCL over NVLink, which joins every card
  to every other, so the mesh order follows the algorithm alone.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_slam_mesh", "make_chain_mesh", "initialize_distributed"]


def make_chain_mesh(n_shards: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the 'chain' axis for pose-chain (sequence) parallelism."""
    if devices is None:
        devices = jax.devices()
    n = n_shards or len(devices)
    return Mesh(np.array(devices[:n]), axis_names=("chain",))


def make_slam_mesh(n_sessions: int = 1, n_edge_shards: int | None = None,
                   devices=None) -> Mesh:
    """Build a ('sessions', 'edges') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_edge_shards is None:
        if n % n_sessions != 0:
            raise ValueError(f"{n} devices not divisible by {n_sessions} sessions")
        n_edge_shards = n // n_sessions
    use = n_sessions * n_edge_shards
    grid = np.array(devices[:use]).reshape(n_sessions, n_edge_shards)
    return Mesh(grid, axis_names=("sessions", "edges"))


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Multi-host bring-up (jax.distributed) — no-op when single-process.

    On several hosts each process calls this before building the mesh,
    with the coordinator address, process count and its own id (nothing in
    the environment supplies them).
    """
    if num_processes is None or num_processes <= 1:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True
