#!/usr/bin/env python
"""Benchmark: SLAM keyframe updates/sec/chip on the trackdrive config.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Baseline: the reference publishes no numbers (BASELINE.md), so the baseline is
*measured* here from the faithful CPU reference re-implementation
(tpuslam.sim.golden_frontend.GoldenSlam — same control flow as
reference src/slam.cpp). Note the real reference service is additionally
wall-clock limited to <=1000/gatheringTimeMs ~ 100 frames/s by its
frame-gathering busy-wait (reference src/slam.cpp:227-233); we report the
measured compute-bound baseline and that design bound separately.
"""
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from tpuslam.backend.graph import GraphCapacity
from tpuslam.frontend.pipeline import run_sequence
from tpuslam.frontend.state import initial_state
from tpuslam.runtime.config import SlamConfig
from tpuslam.sim import SimConfig, simulate, trackdrive
from tpuslam.sim.golden_frontend import GoldenSlam
from tpuslam.sim.simulator import ate


def build_scenario():
    track = trackdrive(seed=11)
    scen = simulate(track, SimConfig(laps=1.4, keyframe_dt=0.1, speed=8.0,
                                     max_range=20.0, seed=12))
    return track, scen


# Published dense peak rates per device, keyed by jax `device_kind`.
# Source: NVIDIA H100 Tensor Core GPU datasheet, SXM5 part, at its full
# 700 W power limit (a card set below it cannot hold these clocks; the run
# record carries the card's power limit beside every rate).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(kind: str) -> dict:
    """Peak rates of `kind`; a device the table does not list is an error,
    never a default."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device_kind {kind!r}; "
                         f"bench.PEAKS lists {sorted(PEAKS)}") from None


def _note(msg):
    """Progress marker on stderr (stdout carries only the final JSON line);
    if a run stops mid-way, the last marker says where."""
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


_DT_BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
             "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "pred": 1, "s8": 1,
             "u8": 1}


def _hlo_top_bytes(compiled, top: int = 10) -> dict:
    """Top op kinds of a compiled module by RESULT bytes per program point
    (sum over instruction definitions of that kind). A per-point metric —
    instructions inside loop bodies count once, not per trip — so it NAMES
    the big consumers rather than re-deriving the cost model's totals."""
    import re
    txt = compiled.as_text()
    by_kind: dict = {}
    ty_re = re.compile(r"(f64|f32|f16|bf16|s64|s32|s16|s8|u64|u32|u16|u8|"
                       r"pred)\[([0-9,]*)\]")
    line_re = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s"
                         r"([\w\-]+)\(")
    skip = {"while", "conditional", "call", "parameter", "constant",
            "tuple", "get-tuple-element", "bitcast", "copy-done"}
    for line in txt.splitlines():
        mm = line_re.match(line)
        if not mm:
            continue
        name, types, kind = mm.groups()
        if kind in skip:
            continue
        if kind == "fusion":
            # the fusion NAME prefix encodes its root op (e.g.
            # broadcast_select_fusion) — far more informative than the
            # generic kind
            kind = name.split(".")[0].lstrip("%")
        b = 0
        for dt, dims in ty_re.findall(types):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            b += n * _DT_BYTES[dt]
        rec = by_kind.setdefault(kind, [0, 0])
        rec[0] += b
        rec[1] += 1
    ranked = sorted(by_kind.items(), key=lambda kv: -kv[1][0])[:top]
    return {k: {"mb": round(v[0] / 1e6, 2), "n_sites": v[1]}
            for k, v in ranked}


def _section(extras, name, fn):
    """Run one bench section and merge its record. A failure propagates:
    the run exits non-zero rather than printing a partial record."""
    _note(name)
    extras.update(fn())


def device_op_lanes(events) -> set:
    """(pid, tid) lanes of a `jax.profiler` trace that carry the GPU's
    per-op events: the "XLA Ops" line of each `/device:GPU:N` process, or
    its "Stream" lines where the trace has no such line. Host threads and
    the per-module envelope line are left out, so no interval is counted
    twice."""
    procs = {e["pid"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"
             and e["args"]["name"].startswith("/device:GPU")}
    threads = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
               if e.get("ph") == "M" and e.get("name") == "thread_name"
               and e.get("pid") in procs}
    ops = {k for k, n in threads.items() if n == "XLA Ops"}
    ops_pids = {pid for pid, _ in ops}
    streams = {k for k, n in threads.items()
               if n.startswith("Stream") and k[0] not in ops_pids}
    return ops | streams


def main():
    from tpuslam.runtime.device import (device_record, enable_compile_cache,
                                        nvidia_smi)
    enable_compile_cache()
    device = device_record()
    if device["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {device}")
    peaks = device_peaks(device["kind"])
    track, scen = build_scenario()
    t_frames = len(scen.times)
    cap = GraphCapacity(max_poses=1 << (t_frames - 1).bit_length(),
                        max_landmarks=256, max_obs=8192)
    cfg = SlamConfig(capacity=cap)

    obs = jnp.asarray(scen.obs, jnp.float32)
    valid = jnp.asarray(scen.obs_valid)
    poses = jnp.asarray(scen.odom_poses, jnp.float32)

    # warm-up + correctness. ATE is measured on the *published* trajectory —
    # the reference's observable output is its odometry-driven pose stream
    # (drawPoses returns m_poses, and the localization-mode publish is the
    # last vertex's odometry estimate since its optimize is disabled,
    # reference src/slam.cpp:403-421) — so parity compares like with like.
    # ATE measured on the production (blocked) pipeline's outputs — bit-exact
    # vs the per-frame run_sequence (tests/test_blocked_equivalence.py)
    from tpuslam.frontend.blocked import run_sequence_blocked
    state = initial_state(cap)
    state, outs = run_sequence_blocked(state, obs, valid, poses, cfg, block=32)
    jax.block_until_ready(state.graph.poses)
    closed = bool(state.loop_closure_complete)
    est = np.asarray(outs.pose)
    ate_m = ate(est[:, :2], scen.gt_poses[:t_frames, :2])

    extras = {}

    # improved (non-compat) pipeline: GPS/heading priors + calibrated weights
    # + refinement — the "beats the reference" configuration
    def improved_section():
        from tpuslam.backend import gauss_newton as gn
        from tpuslam.frontend.keyframe import _gn_config
        cfg_improved = SlamConfig.improved(capacity=cap)
        st2 = initial_state(cap)
        st2, outs2 = run_sequence(st2, obs, valid, poses, cfg_improved)
        jax.block_until_ready(st2.graph.poses)
        ate_improved = ate(np.asarray(outs2.pose)[:, :2],
                           scen.gt_poses[:t_frames, :2])
        g2 = gn.optimize(st2.graph, _gn_config(cfg_improved))
        ate_improved_final = ate(np.asarray(g2.poses)[:t_frames, :2],
                                 scen.gt_poses[:t_frames, :2])
        lm2 = np.asarray(g2.lm_xy)[:int(g2.n_landmarks)]
        map_err_improved = float(np.median(np.linalg.norm(
            lm2[:, None, :] - track.cones_xy[None], axis=-1).min(axis=1)))
        return {"ate_improved_online_m": round(float(ate_improved), 4),
                "ate_improved_final_m": round(float(ate_improved_final), 4),
                "map_error_improved_m": round(map_err_improved, 4)}

    _section(extras, "improved_mode", improved_section)

    # timed passes: the blocked pipeline (frontend/blocked.py), K whole
    # passes per dispatch. Per-pass device time comes from the slope between
    # two dispatch sizes, so the fixed per-dispatch cost cancels. Each timed
    # call ends by pulling a scalar to the host.
    from tpuslam.frontend import blocked as BL
    from tpuslam.frontend.state import initial_state as init_state

    # block=32: the single-session block size the bench has always timed
    obs_p, valid_p, pose_p, _ = BL._pad_inputs(obs, valid, poses, cfg, 32)
    # data-driven compaction (r4): the trackdrive frames carry <= 12 valid
    # obs, so nc=16 halves the quadratic in-block pair terms (2.1x at the
    # batched knee); denser inputs bucket up automatically
    nc = BL._pick_compact(valid)

    def multi_pass(k):
        @jax.jit
        def run():
            def one(_, __):
                st = init_state(cap)
                st, _outs, done = BL.blocked_core.__wrapped__(
                    st, obs_p, valid_p, pose_p, cfg, 32, compact_obs=nc)
                return (), st.graph.n_poses + done
            _, ys = jax.lax.scan(one, (), None, length=k)
            return ys
        return run

    def timed_slope_stats(make_fn, k1, k2, reps=5):
        """Per-pass device time from the dispatch-size slope, with spread.

        min over reps: the best-of pair drops host-side stalls. Returns
        (slope_from_mins, per_rep_slopes) — the per-rep slopes carry the
        run-to-run variance the min-based value hides.
        """
        f1, f2 = make_fn(k1), make_fn(k2)
        _ = int(f1()[0]); _ = int(f2()[0])      # warm/compile
        t1 = t2 = 1e9
        slopes = []
        for _ in range(reps):
            t0 = time.perf_counter(); _ = int(f1()[0])
            d1 = time.perf_counter() - t0
            t0 = time.perf_counter(); _ = int(f2()[0])
            d2 = time.perf_counter() - t0
            t1, t2 = min(t1, d1), min(t2, d2)
            slopes.append((d2 - d1) / (k2 - k1))
        return (t2 - t1) / (k2 - k1), slopes

    def timed_slope(make_fn, k1, k2, reps=5):
        return timed_slope_stats(make_fn, k1, k2, reps)[0]

    _note("primary: blocked-pipeline throughput slope")
    # a wide dispatch-size spread (28 laps) keeps the measured delta well
    # above host timing jitter
    sec_per_pass, primary_slopes = timed_slope_stats(multi_pass, 4, 32)
    fps_dev = t_frames / sec_per_pass
    extras["primary_reps"] = len(primary_slopes)
    extras["primary_fps_per_rep"] = [round(t_frames / s, 1)
                                     for s in primary_slopes]
    extras["primary_fps_min"] = round(t_frames / max(primary_slopes), 1)
    extras["primary_fps_max"] = round(t_frames / min(primary_slopes), 1)

    # online latency: device time per keyframe of the LIVE path (the
    # per-frame run_sequence scan the service drives one keyframe at a
    # time) — the number that compares against the reference's 10-20 ms
    # real-time frame budget (gatheringTimeMs)
    def online_latency_section():
        def multi_seq(k):
            @jax.jit
            def run():
                def one(_, __):
                    st = init_state(cap)
                    st, _o = run_sequence.__wrapped__(st, obs, valid, poses,
                                                      cfg)
                    return (), st.graph.n_poses
                _, ys = jax.lax.scan(one, (), None, length=k)
                return ys
            return run
        us = timed_slope(multi_seq, 2, 8) / t_frames * 1e6
        return {"online_keyframe_latency_us": round(us, 1)}

    _section(extras, "online_latency", online_latency_section)

    # batched multi-session SATURATION SWEEP (VERDICT r2 next #1): the
    # blocked core vmapped over S independent sessions for S = 16..256 —
    # find the throughput knee, report FLOP and bandwidth utilization and
    # the binding resource at it.
    # Pose capacity sized to the lap (384 >= t_frames) so the batched
    # full-capacity Schur/Cholesky tracks the real problem, not padding.
    n_sess = 16
    # S < 16 brackets the knee from the left (VERDICT r3 weak #1: the r3
    # sweep started AT the knee, so its position was asserted, not measured)
    sweep_sizes = (2, 4, 8, 16, 32, 64, 128, 256)

    def batched_section():
        from tpuslam.parallel.batch import initial_states
        # 16 distinct simulated sessions, tiled up to the largest S: tiling
        # repeats DATA but not WORK — every op is data-independent in cost,
        # so throughput numbers are unaffected while host-side scenario
        # generation stays bounded.
        scens_b = [simulate(trackdrive(seed=11), SimConfig(
            laps=1.4, keyframe_dt=0.1, speed=8.0, max_range=20.0, seed=20 + s))
            for s in range(n_sess)]
        t_b = min(t_frames, *(len(sc.times) for sc in scens_b))
        cap_b = GraphCapacity(max_poses=max(384, t_b), max_landmarks=256,
                              max_obs=4096)
        cfg_b = SlamConfig(capacity=cap_b)
        obs_b = jnp.stack([jnp.asarray(sc.obs[:t_b], jnp.float32)
                           for sc in scens_b])
        valid_b = jnp.stack([jnp.asarray(sc.obs_valid[:t_b])
                             for sc in scens_b])
        poses_b = jnp.stack([jnp.asarray(sc.odom_poses[:t_b], jnp.float32)
                             for sc in scens_b])
        pad_b = (-t_b) % 32
        if pad_b:
            far = jnp.full((n_sess, pad_b, 3),
                           2.0 * cfg_b.gps_outlier_bound + 1.0, jnp.float32)
            obs_b = jnp.concatenate(
                [obs_b, jnp.zeros((n_sess, pad_b) + obs_b.shape[2:],
                                  obs_b.dtype)], 1)
            valid_b = jnp.concatenate(
                [valid_b, jnp.zeros((n_sess, pad_b) + valid_b.shape[2:],
                                    bool)], 1)
            poses_b = jnp.concatenate([poses_b, far], 1)

        # compaction width picked HOST-SIDE, before any trace: inside the
        # jit below even ops on the closed-over concrete array would be
        # staged as tracers, and _pick_compact's int() readback would throw
        compact_b = BL._pick_compact(valid_b)

        def make_runner(s):
            if s <= n_sess:
                o, v, p = obs_b[:s], valid_b[:s], poses_b[:s]
            else:
                reps = s // n_sess
                o = jnp.tile(obs_b, (reps, 1, 1, 1))
                v = jnp.tile(valid_b, (reps, 1, 1))
                p = jnp.tile(poses_b, (reps, 1, 1))

            def multi_batched(k):
                @jax.jit
                def run():
                    def one(_, __):
                        sts = initial_states(cap_b, s)
                        sts, _o2, done = BL.blocked_core_batched.__wrapped__(
                            sts, o, v, p, cfg_b, 32,
                            compact_obs=compact_b)
                        return (), sts.graph.n_poses[0] + jnp.min(done)
                    _, ys = jax.lax.scan(one, (), None, length=k)
                    return ys
                return run
            return multi_batched

        out = {}
        sweep = []
        best = (0.0, n_sess, 1.0)
        for s in sweep_sizes:
            runner = make_runner(s)
            _note(f"batched S={s}")
            # scale the dispatch spread with 1/S so the measured
            # device-time delta stays large at every point: at a fixed
            # 1-vs-3 spread the small-S deltas sit inside timing jitter
            k_hi = max(3, min(64, 128 // s))
            sec = timed_slope(runner, 1, k_hi, reps=3)
            fps = s * t_b / sec
            sweep.append({"sessions": s, "frames_per_sec": round(fps, 1),
                          "sec_per_pass": round(sec, 5)})
            if fps > best[0]:
                best = (fps, s, sec)
        out["batched_sweep"] = sweep
        fps_knee, s_knee, sec_knee = best
        out["batched_frames_per_sec_per_chip"] = round(
            next(r["frames_per_sec"] for r in sweep if r["sessions"] == 16),
            2)
        out["batched_knee_sessions"] = s_knee
        out["batched_knee_frames_per_sec_per_chip"] = round(fps_knee, 2)

        # ---- limiter attribution: XLA's own cost model gives FLOPs and
        # bytes of the compiled pass at the smallest and largest S;
        # achieved rates over the card's published peaks (PEAKS) name the
        # binding resource and show whether the per-session working set
        # grows with S. The pass computes in f32 with GN at "highest", so
        # FLOP/s divide by the f32 rate. "bytes accessed" is HLO-level and
        # counts fused producers' operands: it bounds the traffic from above.
        for s_pt in sorted({sweep_sizes[0], 16, s_knee, sweep_sizes[-1]}):
            _note(f"cost analysis S={s_pt}")
            one_pass = make_runner(s_pt)(1)
            ca = one_pass.lower().compile().cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            flops = float(ca.get("flops", 0.0))
            byts = float(ca.get("bytes accessed", 0.0))
            sec_pt = next(r["sec_per_pass"] for r in sweep
                          if r["sessions"] == s_pt)
            for r in sweep:
                if r["sessions"] == s_pt and flops > 0:
                    r["achieved_tflops_f32"] = round(flops / sec_pt / 1e12, 2)
                    r["hbm_gbytes_per_s"] = round(byts / sec_pt / 1e9, 1)
                    r["flop_util_vs_f32_peak_pct"] = round(
                        flops / sec_pt / peaks["f32_flops"] * 100, 2)
                    r["hbm_util_pct"] = round(
                        byts / sec_pt / peaks["hbm_bytes_per_s"] * 100, 1)
                    r["bytes_per_session_gb"] = round(byts / s_pt / 1e9, 3)
            if s_pt == s_knee and flops > 0:
                out["knee_achieved_tflops_f32"] = round(
                    flops / sec_knee / 1e12, 2)
                out["knee_hbm_gbytes_per_s"] = round(byts / sec_knee / 1e9, 1)
                out["knee_flop_util_vs_f32_peak_pct"] = round(
                    flops / sec_knee / peaks["f32_flops"] * 100, 2)
                out["knee_hbm_util_pct"] = round(
                    byts / sec_knee / peaks["hbm_bytes_per_s"] * 100, 1)

        # ---- per-subsystem byte budget at S=16 (VERDICT r3 next #1):
        # compile-only cost analysis with one subsystem ablated at a time
        # (frontend/blocked.py measurement hooks) attributes the pass's
        # HBM bytes to arrays/subsystems instead of asserting a limiter
        def _budget_prog(ablate, compact=32):
            s_n = 16
            o = obs_b[:s_n]
            v = valid_b[:s_n]
            p = poses_b[:s_n]

            @jax.jit
            def run():
                from tpuslam.parallel.batch import initial_states as ist

                def one(_, __):
                    sts = ist(cap_b, s_n)
                    sts, _o2, done = jax.vmap(
                        lambda st, oo, vv, pp:
                        BL.blocked_core.__wrapped__(
                            st, oo, vv, pp, cfg_b, 32,
                            vmap_safe_gn=True, compact_obs=compact,
                            ablate=ablate))(sts, o, v, p)
                    return (), sts.graph.n_poses[0] + jnp.min(done)
                _, ys = jax.lax.scan(one, (), None, length=1)
                return ys
            return run.lower().compile()

        def bytes_of(ablate, compact=32):
            ca2 = _budget_prog(ablate, compact).cost_analysis()
            if isinstance(ca2, (list, tuple)):
                ca2 = ca2[0]
            return float(ca2.get("bytes accessed", 0.0))

        base_b = bytes_of(frozenset())
        budget = {"total_gb": round(base_b / 1e9, 3)}
        # r5 (VERDICT r4 next #2): two finer axes split the former
        # "non-optional core" — 'transforms' (global/body coordinate
        # transforms) and 'closure' (detection prefix machinery)
        hooks = ("dup", "assoc", "packet", "edges", "gn",
                 "transforms", "closure")
        for nm in hooks:
            _note(f"byte budget: {nm}")
            delta = base_b - bytes_of(frozenset({nm}))
            budget[f"{nm}_gb"] = round(delta / 1e9, 3)
            budget[f"{nm}_pct"] = round(delta / base_b * 100, 1)
        # the floor is measured directly (everything ablated at once),
        # NOT by subtracting the single-ablation deltas — those
        # overlap (e.g. 'edges' empties arrays 'gn' also reads), so
        # per-subsystem pcts need not sum to 100 - residual. What
        # remains is the NON-OPTIONAL core: global transforms, closure
        # detection, prefix scans, pose/index series, state threading
        # — not just the carried arrays, so it is named accordingly
        _note("byte budget: residual")
        resid_b = bytes_of(frozenset(hooks))
        budget["residual_core_gb"] = round(resid_b / 1e9, 3)
        budget["residual_core_pct"] = round(resid_b / base_b * 100, 1)
        # top HLO byte consumers INSIDE the residual core (VERDICT r4
        # next #2): per-instruction operand+result bytes of the
        # compiled ALL-ABLATED program, summed by op kind — names what
        # the "non-optional core" traffic actually is, below
        # subsystem granularity
        budget["residual_top_ops"] = _hlo_top_bytes(
            _budget_prog(frozenset(hooks)), top=10)
        out["byte_budget_s16"] = budget

        # ---- device profiler trace at the knee (VERDICT r4 next #2): the
        # r4 "issue/occupancy-limited" conclusion rested on cost-model
        # elimination; this MEASURES where plateau time goes — one pass at
        # the knee under jax.profiler, the GPU's XLA-op events aggregated
        # by op category + the top individual consumers.
        import glob as _glob
        import gzip as _gzip
        import tempfile as _tf
        runner1 = make_runner(s_knee)(1)
        jax.block_until_ready(runner1())          # warm/compile
        with _tf.TemporaryDirectory() as td:
            with jax.profiler.trace(td):
                r = runner1()
                jax.block_until_ready(r)
            tr = sorted(_glob.glob(
                td + "/plugins/profile/*/*.trace.json.gz"))[-1]
            with _gzip.open(tr, "rt") as f:
                trace = json.load(f)
        lanes = device_op_lanes(trace["traceEvents"])
        # generic 'fusion.N' events are the bulk of device time; name
        # them by their ROOT opcode from the compiled module text
        # ("%fusion.N = ... fusion(...), calls=%comp" + comp's "ROOT
        # %x = ty op(...)"), so the top-op table reads e.g.
        # select_fusion instead of an unattributed 73% 'fusion' bucket
        import re as _re
        hlo_txt = runner1.lower().compile().as_text()
        comp_root = {}
        cur_comp = None
        for ln in hlo_txt.splitlines():
            mm = _re.match(r"%?([\w.\-]+)\s*(?:\([^)]*\))?\s*"
                           r"(?:->.*)?\s*\{\s*(?:/\*.*\*/)?\s*$", ln)
            if mm and "=" not in ln:
                cur_comp = mm.group(1)
            rm = _re.match(r"\s*ROOT\s+%?[\w.\-]+\s*=\s*[^=]*?\s"
                           r"([\w\-]+)\(", ln)
            if rm and cur_comp:
                comp_root[cur_comp] = rm.group(1)
        fusion_root = {}
        for mm in _re.finditer(
                r"%?([\w.\-]+)\s*=\s*[^=\n]*?\sfusion\([^\n]*?"
                r"calls=%?([\w.\-]+)", hlo_txt):
            fusion_root[mm.group(1)] = comp_root.get(mm.group(2), "")
        cats = {}
        tops = {}
        total = 0.0
        for e in trace["traceEvents"]:
            if e.get("ph") != "X" or (e.get("pid"), e.get("tid")) not in lanes:
                continue
            nm = e.get("name", "")
            dur = float(e.get("dur", 0.0))
            if nm.startswith("jit_") or "(" in nm:
                continue                          # XLA-module envelope
            if nm.split(".")[0] == "fusion":
                root = fusion_root.get(nm, "")
                if root:
                    nm = f"fusion[{root}]"
            low = nm.lower()
            if low.split(".")[0] in ("while", "conditional", "call"):
                # control-flow ENVELOPE events overlap their body ops
                # in the flat event list — counting them would double-
                # count ~40% of device time under the scan loops
                continue
            if "convolution" in low or "dot" in low:
                cat = "matmul/conv (+fused elementwise)"
            elif ("gather" in low or "scatter" in low
                    or "dynamic" in low or "select-and" in low):
                cat = "gather/scatter/dynamic-slice"
            elif "reduce" in low or "sort" in low or "cumsum" in low:
                cat = "reduction/scan/sort"
            elif "copy" in low or "transpose" in low or "bitcast" in low:
                cat = "copy/layout"
            elif "all-reduce" in low or "collective" in low:
                cat = "collective"
            else:
                cat = "elementwise/other fusion"
            cats[cat] = cats.get(cat, 0.0) + dur
            key = nm.split(".")[0]
            tops[key] = tops.get(key, 0.0) + dur
            total += dur
        if total > 0:
            out["knee_profile"] = {
                "device_time_us": round(total, 1),
                "by_category_pct": {
                    k: round(v / total * 100, 1)
                    for k, v in sorted(cats.items(),
                                       key=lambda kv: -kv[1])},
                "top_ops_pct": {
                    k: round(v / total * 100, 1)
                    for k, v in sorted(tops.items(),
                                       key=lambda kv: -kv[1])[:10]},
                "note": ("GPU XLA-op events of ONE batched pass "
                         f"at the knee (S={s_knee}) from a "
                         "jax.profiler trace; categories from "
                         "optimized-HLO op names (a fusion is binned "
                         "by its root op, so 'matmul/conv' includes "
                         "elementwise producers XLA fused into it)"),
            }
        return out

    _section(extras, "batched_sessions", batched_section)

    # cross-session map fusion on the real chip (BASELINE config 5): S
    # whole-lap IMPROVED-mode sessions -> one jointly optimized global map
    # via ICP alignment + information-weighted dedup/merge + joint GN over
    # the fused (S*P poses, S*L landmarks) graph. VERDICT r2 weak #3 bar:
    # map_error_fused_m <= map_error_improved_m (fused laps beat one lap).
    def fusion_section():
        import dataclasses as _dc

        from tpuslam.backend import gauss_newton as gnb
        from tpuslam.parallel import fusion
        from tpuslam.parallel.batch import initial_states
        s_f = 8
        scens_f = [simulate(trackdrive(seed=11), SimConfig(
            laps=1.4, keyframe_dt=0.1, speed=8.0, max_range=20.0, seed=60 + s))
            for s in range(s_f)]
        t_f = min(len(sc.times) for sc in scens_f)
        t_f -= t_f % 16
        cap_f = GraphCapacity(max_poses=max(384, t_f), max_landmarks=256,
                              max_obs=4096)
        # periodic boundaries must land on block (16) ends for the blocked
        # pass; closure + final joint GN dominate map quality here anyway
        cfg_f = SlamConfig.improved(capacity=cap_f,
                                    association="mahalanobis",
                                    periodic_gn_every=16)
        obs_f = jnp.stack([jnp.asarray(sc.obs[:t_f], jnp.float32)
                           for sc in scens_f])
        valid_f = jnp.stack([jnp.asarray(sc.obs_valid[:t_f])
                             for sc in scens_f])
        poses_f = jnp.stack([jnp.asarray(sc.odom_poses[:t_f], jnp.float32)
                             for sc in scens_f])
        sts = initial_states(cap_f, s_f)
        sts, _o, _d = BL.blocked_core_batched(sts, obs_f, valid_f, poses_f,
                                              cfg_f, 16)
        # frames >= done_upto were NOT processed (ADVICE r2): make an
        # incomplete pass visible instead of silently mis-attributing
        done_min = int(jnp.min(_d))
        assert done_min == obs_f.shape[1], \
            f"fusion sessions incomplete: done_upto min {done_min}"
        stacked = sts.graph                      # FactorGraph [S]
        lm_info_f = sts.lm_info_xy               # [S, L, 3]
        # bucketing off: the fused graph runs at ~85% of its (S*P, S*L)
        # capacity, so the bucketed solve saves nothing here while its
        # lax.switch branches (24 pose x 16 edge buckets at this size)
        # dominate compile time. Improved weights +
        # GPS-prior anchoring (no gauge clamping).
        fcfg = gnb.GNConfig(odo_info=cfg_f.odo_info, lm_info=cfg_f.lm_info,
                            iterations=10, fix_first_poses=0,
                            fix_first_landmarks=0, solve_bucket_step=0,
                            edge_bucket_step=0, early_exit_tol=1e-4)
        gate_f = cfg_f.same_cone_threshold
        # align=False: these sessions share one GPS frame (absolute priors);
        # ICP on the repetitive cone ring only adds a spurious rigid move
        # (measured 0.029 m aligned vs 0.012 m unaligned fused map error)
        fused, rep = fusion.fuse_sessions(stacked, cfg=fcfg, gate=gate_f,
                                          lm_info=lm_info_f, align=False)
        jax.block_until_ready(fused.poses)
        lmf = np.asarray(fused.lm_xy)[:int(fused.n_landmarks)]
        map_err = float(np.median(np.linalg.norm(
            lmf[:, None, :] - track.cones_xy[None], axis=-1).min(axis=1)))

        def multi_fuse(k):
            @jax.jit
            def run():
                def one(c, __):
                    # thread a data dependence through the carry so XLA
                    # cannot hoist the loop-invariant fusion out of the
                    # scan (ADVICE r2): perturb one pose sub-ulp by c
                    st2 = _dc.replace(
                        stacked, poses=stacked.poses.at[0, 0, 0].add(c))
                    f2, _r = fusion.fuse_sessions(st2, cfg=fcfg,
                                                  gate=gate_f,
                                                  lm_info=lm_info_f,
                                                  align=False)
                    return f2.poses[0, 0] * 1e-12, f2.poses[0, 0]
                _, ys = jax.lax.scan(one, jnp.float32(0), None, length=k)
                return ys
            return run

        fuse_ms = timed_slope(multi_fuse, 1, 4) * 1e3

        # ---- drifted variant (VERDICT r3 weak #5): sessions rigidly
        # offset (no shared GPS anchor), so the ICP registration path runs
        # ON CHIP inside the timed fusion — priors are dropped (they would
        # pin each session to its own drifted frame) and alignment is on.
        rngd = np.random.default_rng(7)
        offs = rngd.uniform([-0.6, -0.6, -0.04], [0.6, 0.6, 0.04], (s_f, 3))
        offs[0] = 0.0                                # session 0 = anchor
        c, si = np.cos(offs[:, 2]), np.sin(offs[:, 2])
        p_np = np.asarray(poses_f)
        xy = np.einsum("sij,stj->sti",
                       np.stack([np.stack([c, si], -1),
                                 np.stack([-si, c], -1)], 1),
                       p_np[:, :, :2])
        poses_d = np.stack([xy[..., 0] + offs[:, None, 0],
                            xy[..., 1] + offs[:, None, 1],
                            p_np[:, :, 2] + offs[:, None, 2]], -1)
        # run_sequences_... wrapper: drifted closures can land on mid-block
        # boundaries (fallback), the wrapper finishes per-frame
        sts_d, _od = BL.run_sequences_blocked_batched(
            initial_states(cap_f, s_f), obs_f, valid_f,
            jnp.asarray(poses_d, jnp.float32), cfg_f, 16)
        st_drift = sts_d.graph
        gate_d = 2.0 * gate_f       # annealed ICP gate spans the drift
        # robust=True: trimmed ICP (best 75% of matched pairs per
        # iteration) registers drifted sessions better than plain ICP
        fused_d, rep_d = fusion.fuse_sessions(
            st_drift, cfg=fcfg, gate=gate_d, lm_info=sts_d.lm_info_xy,
            align=True, robust=True)
        jax.block_until_ready(fused_d.poses)
        lmd = np.asarray(fused_d.lm_xy)[:int(fused_d.n_landmarks)]
        # drifted sessions lose the shared frame: compare up to the
        # anchor session's frame (session 0 is unoffset, so direct)
        map_err_d = float(np.median(np.linalg.norm(
            lmd[:, None, :] - track.cones_xy[None], axis=-1).min(axis=1)))

        def multi_fuse_d(k):
            @jax.jit
            def run():
                def one(cr, __):
                    st2 = _dc.replace(
                        st_drift,
                        poses=st_drift.poses.at[0, 0, 0].add(cr))
                    f2, _r = fusion.fuse_sessions(st2, cfg=fcfg,
                                                  gate=gate_d,
                                                  lm_info=sts_d.lm_info_xy,
                                                  align=True, robust=True)
                    return f2.poses[0, 0] * 1e-12, f2.poses[0, 0]
                _, ys = jax.lax.scan(one, jnp.float32(0), None, length=k)
                return ys
            return run

        fuse_d_ms = timed_slope(multi_fuse_d, 1, 4) * 1e3
        return {"fusion_sessions": s_f,
                "fusion_latency_ms": round(fuse_ms, 2),
                "fused_landmarks": int(fused.n_landmarks),
                "fusion_cross_session_merges":
                    int(rep["n_cross_session_merges"]),
                "map_error_fused_m": round(map_err, 4),
                "map_error_fused_drifted_m": round(map_err_d, 4),
                "fused_landmarks_drifted": int(fused_d.n_landmarks),
                "fusion_drifted_latency_ms": round(fuse_d_ms, 2)}

    _section(extras, "cross_session_fusion", fusion_section)

    # improved-fast: the blocked-compatible accuracy configuration
    # (GPS/heading priors + nearest association + localizer refine +
    # closure GN; no periodic GN) — beats the reference's accuracy at
    # blocked-pipeline speed (bit-exact vs run_sequence on this config)
    def improved_fast_section():
        cfg_if = SlamConfig.improved(capacity=cap, periodic_gn_every=0)
        st_if, outs_if = run_sequence_blocked(initial_state(cap), obs, valid,
                                              poses, cfg_if, block=32)
        jax.block_until_ready(st_if.graph.poses)
        ate_if = ate(np.asarray(outs_if.pose)[:, :2],
                     scen.gt_poses[:t_frames, :2])

        def multi_if(k):
            @jax.jit
            def run():
                def one(_, __):
                    st = init_state(cap)
                    st, _o, done = BL.blocked_core.__wrapped__(
                        st, obs_p, valid_p, pose_p, cfg_if, 32,
                        compact_obs=nc)
                    return (), st.graph.n_poses + done
                _, ys = jax.lax.scan(one, (), None, length=k)
                return ys
            return run

        fps_if = t_frames / timed_slope(multi_if, 4, 32)
        return {"improved_fast_frames_per_sec_per_chip": round(fps_if, 2),
                "ate_improved_fast_online_m": round(float(ate_if), 4)}

    _section(extras, "improved_fast", improved_fast_section)

    # improved (FULL, the r4 default): GPS priors + periodic fixed-lag GN
    # every 16 keyframes at block=16 + per-frame published-pose MAP
    # refinement (mapping_publish_refine — accuracy decoupled from the
    # refresh cadence; blocked matches run_sequence to f32 solve
    # tolerance). The every=8/B=8 variant is reported alongside: with the
    # publish refine it is an ACCURACY upgrade (more frequent map refresh),
    # no longer the default's prerequisite.
    def improved_full_section():
        out = {}
        # r5 (VERDICT r4 next #3): the *_b32 rows run the SAME firing
        # cadence inside block=32 bodies (mid-block multi-fire, each
        # firing anchored at its frame's committed counts + one-gather
        # publish re-refine) — the accuracy cadence no longer dictates
        # the throughput block size
        for tag, every, blk, primary in (("", 16, 16, True),
                                         ("_every16_b32", 16, 32, False),
                                         ("_every8", 8, 8, False),
                                         ("_every8_b32", 8, 32, False)):
            cfg_im = SlamConfig.improved(capacity=cap,
                                         periodic_gn_every=every)
            st_im, outs_im = run_sequence_blocked(
                initial_state(cap), obs, valid, poses, cfg_im, block=blk)
            jax.block_until_ready(st_im.graph.poses)
            ate_im = ate(np.asarray(outs_im.pose)[:, :2],
                         scen.gt_poses[:t_frames, :2])
            obs_q, valid_q, pose_q, _ = BL._pad_inputs(obs, valid, poses,
                                                       cfg_im, blk)

            def multi_im(k, cfg_im=cfg_im, blk=blk, obs_q=obs_q,
                         valid_q=valid_q, pose_q=pose_q):
                @jax.jit
                def run():
                    def one(_, __):
                        st = init_state(cap)
                        st, _o, done = BL.blocked_core.__wrapped__(
                            st, obs_q, valid_q, pose_q, cfg_im, blk,
                            compact_obs=nc)
                        return (), st.graph.n_poses + done
                    _, ys = jax.lax.scan(one, (), None, length=k)
                    return ys
                return run

            fps_im = t_frames / timed_slope(multi_im, 2, 16)
            out[f"improved_frames_per_sec_per_chip{tag}"] = round(fps_im, 2)
            out[f"ate_improved_blocked_online_m{tag}"] = round(float(ate_im),
                                                              4)
        return out

    _section(extras, "improved_full", improved_full_section)

    # Device-time breakdown + FLOP utilization: per-stage attribution via
    # the same slope method, FLOPs from XLA's own cost_analysis of the
    # compiled pass. The engine computes in f32, so utilization is quoted
    # against the card's published f32 peak (PEAKS).
    def device_breakdown_section():
        from tpuslam.backend import gauss_newton as gn
        from tpuslam.frontend.keyframe import (_associate_shared, _cone_packet,
                                               _gn_config)
        out = {}
        # ---- FLOPs of one whole blocked pass from the compiled executable
        one_pass = multi_pass(1)
        ca = one_pass.lower().compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0))
        if flops > 0:
            tflops_s = flops / sec_per_pass / 1e12
            out["pass_gflop"] = round(flops / 1e9, 2)
            out["achieved_tflops_f32"] = round(tflops_s, 3)
            out["flop_util_vs_f32_peak_pct"] = round(
                flops / sec_per_pass / peaks["f32_flops"] * 100, 3)

        # ---- stage slopes. Association: the dense (N x L) gating each
        # keyframe runs; solve: the closure-scale GN; egress: packet build.
        st_fin = state  # post-lap state (realistic map size)

        def assoc_scan(k):
            @jax.jit
            def run():
                def one(c, t):
                    _g, _b, cost, _gt = _associate_shared(
                        st_fin, obs[t % t_frames], valid[t % t_frames],
                        poses[t % t_frames] + c * 1e-9, cfg)
                    return c + cost[0, 0] * 1e-9, cost[0, 0]
                _, ys = jax.lax.scan(one, jnp.float32(0),
                                     jnp.arange(k * t_frames))
                return ys
            return run

        us_assoc = timed_slope(assoc_scan, 1, 3) / t_frames * 1e6

        gcfg = _gn_config(cfg)

        def solve_scan(k):
            @jax.jit
            def run():
                def one(g, _):
                    g2 = gn.optimize(g, gcfg)
                    return g2, g2.poses[0, 0]
                _, ys = jax.lax.scan(one, st_fin.graph, None, length=k)
                return ys
            return run

        us_solve = timed_slope(solve_scan, 1, 3) * 1e6

        def egress_scan(k):
            @jax.jit
            def run():
                def one(c, t):
                    az, dist, _ty = _cone_packet(st_fin, poses[t % t_frames]
                                                 + c * 1e-9, cfg)
                    return c + az[0] * 1e-9, az[0]
                _, ys = jax.lax.scan(one, jnp.float32(0),
                                     jnp.arange(k * t_frames))
                return ys
            return run

        us_egress = timed_slope(egress_scan, 1, 3) / t_frames * 1e6

        us_pass_frame = sec_per_pass / t_frames * 1e6
        out.update({
            # STANDALONE stage slopes (each its own scan program): upper
            # bounds on in-pass cost — XLA fuses association/egress into the
            # blocked body and the block axis amortizes per-frame overhead,
            # so the stages legitimately sum past the fused total.
            "stage_association_standalone_us_per_frame": round(us_assoc, 2),
            "stage_closure_gn_us_per_lap": round(us_solve, 1),
            "stage_egress_standalone_us_per_frame": round(us_egress, 2),
            "blocked_us_per_frame_total": round(us_pass_frame, 2),
        })
        return out

    _section(extras, "device_breakdown", device_breakdown_section)

    # VLP-16 front-end throughput (BASELINE config 4): raw sweeps through
    # the on-device cone detector (RANSAC ground plane + label-propagation
    # clustering). The physical sensor spins at 10 Hz, so this is the
    # margin available for multi-lidar / faster-than-real-time replay.
    def vlp16_section():
        from tpuslam.perception import AttentionConfig, detect_cones
        from tpuslam.sim.vlp16_sim import Vlp16SceneConfig, render_scene
        vcfg = Vlp16SceneConfig(seed=3, points_per_cone=60)
        rngv = np.random.default_rng(3)
        cone_xy = rngv.uniform(-12, 12, (24, 2)).astype(np.float32)
        pts_np, _ = render_scene(cone_xy, np.ones(len(cone_xy), np.int32),
                                 vcfg)
        acfg = AttentionConfig(sensor_height=vcfg.sensor_height,
                               ground_layer_z=-vcfg.sensor_height)
        cap_pts = 4096
        pts = np.zeros((cap_pts, 3), np.float32)
        nv = min(len(pts_np), cap_pts)
        pts[:nv] = pts_np[:nv]
        vmask = np.arange(cap_pts) < nv
        pts_j, vmask_j = jnp.asarray(pts), jnp.asarray(vmask)

        def multi_att(k):
            @jax.jit
            def run():
                def one(_, i):
                    _c, ok, n = detect_cones(pts_j, vmask_j, acfg, seed=0)
                    return (), n
                _, ys = jax.lax.scan(one, (), jnp.arange(k))
                return ys
            return run

        sweeps = 1.0 / timed_slope(multi_att, 8, 64)

        # full 360-degree sweep at TRUE sensor point count (~29k returns,
        # VERDICT round-1 missing #3): raycast sweep -> grid-hash clustering
        # (the dense NxN adjacency would need 3.4 GB here)
        from tpuslam.perception.vlp16 import decode_point_cloud_reading
        from tpuslam.sim.vlp16_sim import scene_to_point_cloud_reading
        cones_roi = rngv.uniform([1.0, -3.5], [11.0, 3.5], (12, 2))
        # surround wall: every beam returns -> the full 28.8k returns/rev of
        # the real sensor (open-field scenes lose the upward beams to sky)
        msg = scene_to_point_cloud_reading(
            cones_roi, Vlp16SceneConfig(seed=4, surround_range=30.0))
        cloud, _ = decode_point_cloud_reading(msg)
        fcap = 32768
        fpts = np.zeros((fcap, 3), np.float32)
        nf = min(len(cloud), fcap)
        fpts[:nf] = cloud[:nf]
        facfg = AttentionConfig(sensor_height=0.9, ground_layer_z=-0.9,
                                inlier_found_threshold=1000, min_points=3)
        fpts_j = jnp.asarray(fpts)
        fmask_j = jnp.asarray(np.arange(fcap) < nf)

        def multi_full(k):
            @jax.jit
            def run():
                def one(_, i):
                    _c, ok, n = detect_cones(fpts_j, fmask_j, facfg, seed=0)
                    return (), n
                _, ys = jax.lax.scan(one, (), jnp.arange(k))
                return ys
            return run

        full_sweeps = 1.0 / timed_slope(multi_full, 4, 16)
        return {"vlp16_sweeps_per_sec_per_chip": round(sweeps, 1),
                "vlp16_full_sweep_points": int(nf),
                "vlp16_full_sweeps_per_sec_per_chip": round(full_sweeps, 1),
                "vlp16_sensor_rate_hz": 10.0}

    _section(extras, "vlp16_frontend", vlp16_section)

    # ATE parity on the other BASELINE configs (skidpad / acceleration):
    # published trajectory must match the reference-semantics CPU golden
    def extra_ate_section():
        out = {}
        from tpuslam.sim import acceleration, skidpad
        # distinct seeds/cadence per config: odometry noise is additive and
        # track-independent in the simulator, so identical seeds would make
        # the two configs report bit-identical ATE (uninformative)
        for name, tk, laps, seed in (("skidpad", skidpad(), 1.3, 5),
                                     ("acceleration", acceleration(), 1.0, 6)):
            sc = simulate(tk, SimConfig(laps=laps, keyframe_dt=0.25,
                                        seed=seed))
            tt = len(sc.times)
            cap2 = GraphCapacity(
                max_poses=max(64, 1 << (tt - 1).bit_length()),
                max_landmarks=128, max_obs=4096)
            st2b, outs2b = run_sequence(
                initial_state(cap2), jnp.asarray(sc.obs, jnp.float32),
                jnp.asarray(sc.obs_valid),
                jnp.asarray(sc.odom_poses, jnp.float32),
                SlamConfig(capacity=cap2))
            gold2 = GoldenSlam()
            gold2.run_scenario(sc)
            out[f"ate_{name}_m"] = round(float(ate(
                np.asarray(outs2b.pose)[:, :2], sc.gt_poses[:tt, :2])), 4)
            out[f"baseline_ate_{name}_m"] = round(float(ate(
                np.stack(gold2.trajectory)[:, :2], sc.gt_poses[:tt, :2])), 4) \
                if gold2.trajectory else float("nan")
        return out

    _section(extras, "extra_ate_configs", extra_ate_section)

    _note("measured CPU baseline (golden frontend)")
    # measured CPU baseline (reference-semantics golden frontend); best of
    # 3 so transient host load cannot deflate the baseline (and inflate
    # vs_baseline) — the r2->r3 318->154 f/s swing was exactly that
    dt_gold = 1e9
    for _ in range(3):
        gold = GoldenSlam()
        t0 = time.perf_counter()
        gold.run_scenario(scen)
        dt_gold = min(dt_gold, time.perf_counter() - t0)
    fps_gold_meas = t_frames / dt_gold
    gold_ate = ate(np.stack(gold.trajectory)[:, :2], scen.gt_poses[:t_frames, :2]) \
        if gold.trajectory else float("nan")
    # PINNED golden baseline (VERDICT r4 next #6): best-of-3 still swung
    # 32% between hosts/runs, moving the vs_baseline denominator with it.
    # The committed BASELINE_golden.json pins the denominator; the
    # measured value is still reported for drift visibility, and a first
    # run on a fresh checkout writes the pin.
    pin_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "BASELINE_golden.json")
    try:
        with open(pin_path) as f:
            pin = json.load(f)
        fps_gold = float(pin["baseline_fps_cpu_golden"])
        gold_src = "pinned:BASELINE_golden.json"
    except (OSError, KeyError, ValueError):
        fps_gold = fps_gold_meas
        gold_src = "measured:first-run (pin written)"
        with open(pin_path, "w") as f:
            json.dump({"baseline_fps_cpu_golden": round(fps_gold_meas, 2),
                       "frames": t_frames,
                       "note": ("reference-semantics pure-Python golden "
                                "frontend, best of 3 on the bench primary "
                                "scenario; pinned so vs_baseline is stable "
                                "across hosts/runs")}, f, indent=1)

    # the reference service's own design bound: gatheringTimeMs busy-wait
    reference_design_bound_fps = 1000.0 / cfg.gathering_time_ms

    full = {
        "metric": "slam_keyframe_updates_per_sec_per_chip",
        "value": round(fps_dev, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_dev / fps_gold, 2),
        "baseline_fps_cpu_golden": round(fps_gold, 2),
        "baseline_fps_source": gold_src,
        "baseline_fps_cpu_golden_measured": round(fps_gold_meas, 2),
        "reference_design_bound_fps": reference_design_bound_fps,
        "batched_sessions": n_sess,
        "reference_frame_budget_us": cfg.gathering_time_ms * 1000.0,
        "ate_m": round(float(ate_m), 4),
        "baseline_ate_m": round(float(gold_ate), 4),
        "loop_closed": closed,
        "frames": t_frames,
        "device": device,
        "gpu": nvidia_smi(),
        **extras,
    }
    # full record to a file + stderr (the r3 artifact lost the primary
    # metric because the one JSON line outgrew the driver's stdout-tail
    # capture — VERDICT r3 weak #3); stdout gets ONE compact line with the
    # primary fields FIRST, small enough to always survive the capture
    with open("BENCH_full.json", "w") as f:
        json.dump(full, f, indent=1)
    print(json.dumps(full), file=sys.stderr, flush=True)
    compact_keys = (
        "metric", "value", "unit", "vs_baseline", "baseline_fps_cpu_golden",
        "primary_fps_min", "primary_fps_max", "ate_m", "baseline_ate_m",
        "loop_closed", "frames", "batched_knee_frames_per_sec_per_chip",
        "knee_hbm_util_pct", "improved_frames_per_sec_per_chip",
        "improved_frames_per_sec_per_chip_every16_b32",
        "ate_improved_blocked_online_m_every16_b32",
        "improved_frames_per_sec_per_chip_every8",
        "improved_frames_per_sec_per_chip_every8_b32",
        "ate_improved_blocked_online_m_every8_b32", "map_error_fused_m",
        "map_error_fused_drifted_m", "device", "gpu",
    )
    print(json.dumps({k: full[k] for k in compact_keys if k in full}))


if __name__ == "__main__":
    main()
