"""Batched multi-session pipelines: vmap over independent SLAM sessions.

The per-keyframe update is tiny by accelerator standards (hundreds-of-landmarks
maps, 3-DoF poses), so a single online session is dispatch/overhead-bound.
The answer is batching: `vmap(perform_keyframe)` runs S
independent sessions (cars, laps, replay shards) in lock-step, turning every
elementwise op and small matmul into an S-wide batched op at essentially the
cost of one. This is the single-chip complement of the cross-chip 'sessions'
mesh axis in tpuslam.parallel.multisession (SURVEY.md §2.4 "multi-session
pod-scale mapping"): shard sessions across chips, vmap sessions within a chip.

The reference processes exactly one session per process (one `Slam` instance,
reference src/opendlv-logic-cfsd18-sensation-slam.cpp:66) — fleet throughput
there means one microservice per car.
"""
from __future__ import annotations

from functools import partial

import jax

from tpuslam.frontend.keyframe import perform_keyframe
from tpuslam.frontend.state import SlamState, initial_state
from tpuslam.runtime.config import SlamConfig

__all__ = ["initial_states", "run_sequences_batched", "run_passes_batched"]


def initial_states(cap, n_sessions: int) -> SlamState:
    """Stacked initial state for `n_sessions` independent sessions."""
    one = initial_state(cap)
    return jax.tree.map(
        lambda x: jax.numpy.broadcast_to(x, (n_sessions,) + x.shape).copy(), one)


@partial(jax.jit, static_argnames="cfg", donate_argnames="states")
def run_sequences_batched(states: SlamState, obs_seq, valid_seq, pose_seq,
                          cfg: SlamConfig):
    """Run S sessions of T keyframes each as one compiled program.

    states: stacked SlamState with leading axis S (see `initial_states`);
    obs_seq [S, T, N, 4], valid_seq [S, T, N], pose_seq [S, T, 3].
    Returns (final stacked state, stacked KeyframeOutputs with axes [S, T]).

    Sessions are fully independent — same math as S separate `run_sequence`
    calls — but the scan body is vmapped over S, so the chip executes one
    batched op stream instead of S sequential ones.

    GN handling: a vmapped `lax.cond` executes BOTH branches per frame, which
    would run the full optimizer every frame for every session. Instead the
    per-keyframe update runs with `defer_gn=True` (it only *flags* wanted
    optimizations) and an outer while_loop then optimizes exactly the
    sessions that asked, one at a time via dynamic indexing — sessions close
    their loops at different frames, so this costs one *unbatched* GN per
    actual closure instead of an S-wide vmapped GN per closure frame. Net
    effect: closure GN is applied after that frame's outputs instead of
    within it (next frame onward sees the optimized map). Published
    trajectories are unchanged on these tracks — EXCEPT, under
    cfg.mapping_publish_refine, the closure frame itself: its published
    refine ran against the pre-closure-GN map (the sequential path refines
    post-GN), a one-frame ~0.1 m deviation
    (tests/test_parallel.py::test_batched_sessions_improved_windowed_gn).
    """
    from tpuslam.backend import gauss_newton as gn
    from tpuslam.frontend.keyframe import _gn_config
    import dataclasses as dc
    import jax.numpy as jnp

    gcfg = _gn_config(cfg)
    periodic_cfg = dc.replace(gcfg, iterations=cfg.periodic_gn_iterations)

    def step(states, frame):
        obs, valid, pose = frame
        states, outs, want_closure, want_periodic = jax.vmap(
            lambda st, o, v, p: perform_keyframe.__wrapped__(
                st, o, v, p, cfg, defer_gn=True)
        )(states, obs, valid, pose)

        def gn_cond(carry):
            _, wc, wp = carry
            return jnp.any(wc | wp)

        def gn_one(carry):
            st, wc, wp = carry
            i = jnp.argmax(wc | wp)                # next session wanting GN
            g_i = jax.tree.map(lambda x: x[i], st.graph)
            if cfg.periodic_gn_every > 0:
                g_opt = jax.lax.cond(wc[i],
                                     lambda g: gn.optimize(g, gcfg),
                                     lambda g: gn.optimize(g, periodic_cfg),
                                     g_i)
            else:
                g_opt = gn.optimize(g_i, gcfg)
            graphs = jax.tree.map(lambda full, one: full.at[i].set(one),
                                  st.graph, g_opt)
            return (dc.replace(st, graph=graphs),
                    wc.at[i].set(False), wp.at[i].set(False))

        states, _, _ = jax.lax.while_loop(
            gn_cond, gn_one, (states, want_closure, want_periodic))
        return states, outs

    # scan over time, vmap over sessions: frame axis must lead for the scan
    frames = (jax.numpy.swapaxes(obs_seq, 0, 1),
              jax.numpy.swapaxes(valid_seq, 0, 1),
              jax.numpy.swapaxes(pose_seq, 0, 1))
    final, outs = jax.lax.scan(step, states, frames)
    return final, jax.tree.map(lambda x: jax.numpy.swapaxes(x, 0, 1), outs)


@partial(jax.jit, static_argnames="cfg")
def run_passes_batched(obs_seq, valid_seq, pose_seq, cfg: SlamConfig):
    """`run_sequences_batched` from fresh states, as one XLA program —
    the single-dispatch form for throughput benchmarking (state construction
    inside the jit; no per-pass host round trips)."""
    n_sessions = obs_seq.shape[0]
    states = initial_states(cfg.capacity, n_sessions)
    return run_sequences_batched.__wrapped__(states, obs_seq, valid_seq,
                                             pose_seq, cfg)
