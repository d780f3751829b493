"""Whole-sequence device pipeline: lax.scan over keyframes.

For replay/benchmark workloads the entire lap is known up front, so instead
of one host dispatch per keyframe the whole sequence runs as a single XLA
program: `run_sequence` scans `perform_keyframe` over the frame axis. This is
the speed-of-light configuration for the throughput benchmarks (no host in
the loop at all); the live service uses the per-frame entry point instead.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpuslam.frontend.keyframe import KeyframeOutputs, perform_keyframe
from tpuslam.frontend.state import SlamState
from tpuslam.runtime.config import SlamConfig

__all__ = ["run_sequence", "run_pass"]


@partial(jax.jit, static_argnames=("cfg", "assoc_mesh"),
         donate_argnames="state")
def run_sequence(state: SlamState, obs_seq, valid_seq, pose_seq,
                 cfg: SlamConfig, assoc_mesh=None):
    """Process T keyframes in one compiled scan.

    obs_seq [T, N, 4], valid_seq [T, N], pose_seq [T, 3] (odometry poses,
    already heading-corrected). Returns (final_state, stacked KeyframeOutputs).
    With `assoc_mesh`, every frame's association runs against the
    landmark-sharded map (see perform_keyframe).
    """
    def step(state, frame):
        obs, valid, pose = frame
        # inline the wrapped function to keep one jit layer
        new_state, out = perform_keyframe.__wrapped__(
            state, obs, valid, pose, cfg, assoc_mesh=assoc_mesh)
        return new_state, out

    return jax.lax.scan(step, state, (obs_seq, valid_seq, pose_seq))


@partial(jax.jit, static_argnames="cfg")
def run_pass(obs_seq, valid_seq, pose_seq, cfg: SlamConfig):
    """One whole session from a fresh state, as a single XLA program.

    Folding the state construction into the jit removes every per-pass host
    dispatch except this call itself.
    Returns (final_state, stacked KeyframeOutputs).
    """
    from tpuslam.frontend.state import initial_state
    state = initial_state(cfg.capacity)
    return run_sequence.__wrapped__(state, obs_seq, valid_seq, pose_seq, cfg)
