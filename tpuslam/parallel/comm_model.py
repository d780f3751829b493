"""Analytic communication accounting + scaling model for the parallel tiers.

A virtual CPU mesh cannot exhibit real scaling (its wall-clocks validate
the collective paths, not their efficiency). What CAN be stated rigorously
is the
per-iteration communication volume of every tier — each collective's payload
is a static function of the graph shape — and a first-order time model on
top of it:

    t(D) = t_comp(1)/D + beta * bytes_on_wire(D) + alpha * n_collectives(D)

with bytes_on_wire the ring-allreduce cost 2*(D-1)/D * payload for psums,
(D-1)/D * gathered for all_gathers, and (alpha, beta) the per-collective
latency and inverse link bandwidth. The defaults model a TPU v5e pod's
ICI and DCN links (~186 GB/s usable ICI per chip across its 4 links at
400 Gbps/link, ~1 us per collective hop), the machine this code was first
written for. They are stated inputs, not measurements, and every time the
model gives is a prediction: no run on an H100 (NVLink, all to all) checks
them. The model's *relative* predictions (replicated vs DD vs resident) are
compared with wall-clock ratios on the virtual mesh in bench_scaling.py.

Volumes are derived from the shard_map programs themselves:

- `distributed_gn_step` (edge-sharded Schur, parallel/distributed.py):
  psums the FULL assembled system per iteration — h_diag [P,3,3] + h_off
  [P,3,3] + W halves 2x[3P, L] + Hll [L,2,2] + gp [P,3] + gl [L,2].
- `chain_gn_step` (replicated reduced solve, parallel/chain.py): psum Hll+gl
  (O(L)) + all_gather of W rows [3P, 2L], Hpp rows, gp, poses.
- `chain_gn_step_dd`: psum Hll+gl (O(L)), the [m, m] interface, and the dl
  update (O(L)); m = 3D + 3 + 2*shared_cap.
- `chain_gn_step_dd_resident` (parallel/resident.py): interface [m, m] +
  shared-row Hll/gl [shared_cap] only — nothing O(L) (the point).
- fusion sharded dedup (parallel/fusion.py): all_gather of the [S*L] label
  vector per label iteration.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CommModel", "tier_bytes_per_iteration", "predict_times",
           "predict_efficiency", "hier_bytes_per_iteration",
           "hier_comm_time", "hier3_bytes_per_iteration", "hier3_comm_time",
           "flat_comm_time", "predict_efficiency_hier",
           "predict_efficiency_weak", "online_comm_time",
           "predict_efficiency_weak_online"]

F32 = 4


def tier_bytes_per_iteration(tier: str, *, P: int, L: int, D: int,
                             shared_cap: int = 64, SL: int | None = None,
                             dedup_iters: int = 8) -> dict:
    """Per-GN-iteration collective payloads (bytes, f32) and counts for a
    tier, as a dict {payload_psum, payload_gather, n_collectives}."""
    if tier == "distributed":          # edge-sharded Schur
        payload = (P * 9 + P * 9 + 2 * (3 * P) * L + L * 4 + P * 3
                   + L * 2) * F32
        return dict(payload_psum=payload, payload_gather=0, n_collectives=1)
    if tier == "chain_replicated":
        b = P // D
        gathered = ((3 * b) * 2 * L + 9 * b * 2 + 3 * b + 3 * b) * F32 * D
        return dict(payload_psum=(L * 4 + L * 2) * F32,
                    payload_gather=gathered, n_collectives=6)
    if tier == "chain_dd":
        m = 3 * D + 3 + 2 * shared_cap
        return dict(payload_psum=(L * 6 + m * m + m + L * 2) * F32,
                    payload_gather=D * F32, n_collectives=4)
    if tier == "chain_dd_resident":
        m = 3 * D + 3 + 2 * shared_cap
        return dict(payload_psum=(shared_cap * 6 + m * m + m) * F32,
                    payload_gather=D * F32, n_collectives=3)
    if tier == "fusion_dedup":
        assert SL is not None
        return dict(payload_psum=0, payload_gather=SL * F32 * dedup_iters,
                    n_collectives=dedup_iters)
    raise ValueError(f"unknown tier {tier}")


@dataclass(frozen=True)
class CommModel:
    ici_bw_bytes_per_s: float = 186e9   # one TPU v5e chip's usable ICI
    collective_latency_s: float = 1e-6  # per collective launch/hop
    # DCN tier (SURVEY §5.8 names ICI *and* DCN): the TPU pod's
    # inter-slice/host network. Both are stated inputs, not measurements —
    # ~25 GB/s usable per host (200 Gbps NICs) and ~10 us per collective.
    dcn_bw_bytes_per_s: float = 25e9
    dcn_latency_s: float = 10e-6


def predict_times(tier: str, t_comp_1dev_s: float, D: int, *, P: int, L: int,
                  shared_cap: int = 64, model: CommModel = CommModel(),
                  iterations: int = 1, SL: int | None = None) -> dict:
    """First-order t(D) = t_comp/D + comm; returns seconds + breakdown."""
    v = tier_bytes_per_iteration(tier, P=P, L=L, D=D,
                                 shared_cap=shared_cap, SL=SL)
    ring = 2.0 * (D - 1) / D
    gath = (D - 1) / D
    t_comm = iterations * (
        (ring * v["payload_psum"] + gath * v["payload_gather"])
        / model.ici_bw_bytes_per_s
        + v["n_collectives"] * model.collective_latency_s * D ** 0.5)
    t_comp = t_comp_1dev_s / D
    return dict(t_total_s=t_comp + t_comm, t_comp_s=t_comp,
                t_comm_s=t_comm, bytes_psum=v["payload_psum"],
                bytes_gather=v["payload_gather"])


def predict_efficiency(tier: str, t_comp_1dev_s: float, D: int, *, P: int,
                       L: int, shared_cap: int = 64,
                       model: CommModel = CommModel(),
                       iterations: int = 1, SL: int | None = None) -> float:
    """Parallel efficiency t(1)/(D * t(D)) under the model."""
    t_d = predict_times(tier, t_comp_1dev_s, D, P=P, L=L,
                        shared_cap=shared_cap, model=model,
                        iterations=iterations, SL=SL)["t_total_s"]
    return t_comp_1dev_s / (D * t_d)


def hier_bytes_per_iteration(D: int, tray: int, *,
                             shared_per_boundary: float = 2.0) -> dict:
    """Per-iteration payloads of the two-level hierarchical resident DD
    solve (parallel/hier.py), split by the domain the collective rides.

    The flat shared set grows with the block count (each block boundary
    contributes ~`shared_per_boundary` straddling landmarks), so the flat
    interface m = 3D + 3 + 2*c*D grows linearly in D; the hierarchy keeps
    the big exchange within a tray (ms ~ m/T + K) and sends only
    mk = 3T + 3 + 2*c*T across trays.
    """
    G = tray
    T = max(D // G, 1)
    c = shared_per_boundary
    lsh = int(c * D)
    lsh_t = int(c * (G - 1)) + 1
    lsh_x = int(c * T) + 1
    wt = 3 * (G - 1) + 2 * lsh_t
    mk = 3 * T + 3 + 2 * lsh_x
    ms = wt + mk
    return dict(
        payload_psum_ici=(ms * ms + ms) * F32,       # level-1, tray group
        payload_psum_dcn=(mk * mk + mk + lsh * 8) * F32,  # level-2 + lm psums
        n_collectives_ici=2, n_collectives_dcn=3,
        ms=ms, mk=mk, lsh=lsh)


def hier_comm_time(D: int, tray: int, *, shared_per_boundary: float = 2.0,
                   model: CommModel = CommModel(),
                   iterations: int = 1) -> float:
    """Per-solve communication time of the hierarchical solve: the level-1
    ring rides ICI within the tray, level 2 crosses trays on DCN."""
    v = hier_bytes_per_iteration(D, tray,
                                 shared_per_boundary=shared_per_boundary)
    G = tray
    T = max(D // G, 1)
    ring_g = 2.0 * (G - 1) / G
    ring_t = 2.0 * (T - 1) / T if T > 1 else 0.0
    return iterations * (
        ring_g * v["payload_psum_ici"] / model.ici_bw_bytes_per_s
        + ring_t * v["payload_psum_dcn"] / model.dcn_bw_bytes_per_s
        + v["n_collectives_ici"] * model.collective_latency_s * G ** 0.5
        + v["n_collectives_dcn"] * model.dcn_latency_s * max(T, 1) ** 0.5)


def predict_efficiency_hier(t_comp_1dev_s: float, D: int, tray: int, *,
                            shared_per_boundary: float = 2.0,
                            model: CommModel = CommModel(),
                            iterations: int = 1) -> float:
    """STRONG-scaling efficiency of the hierarchical solve (fixed problem
    split D ways)."""
    t_comm = hier_comm_time(D, tray, shared_per_boundary=shared_per_boundary,
                            model=model, iterations=iterations)
    t_d = t_comp_1dev_s / D + t_comm
    return t_comp_1dev_s / (D * t_d)


def hier3_bytes_per_iteration(D: int, tray: int, pod: int, *,
                              shared_per_boundary: float = 2.0) -> dict:
    """Per-iteration payloads of a THREE-level nested dissection (VERDICT
    r4 next #7): trays (ICI groups of `tray` chips) eliminate their
    interiors with a within-tray psum; the tray-boundary systems of one
    POD (`pod` chips — a v5e pod is one all-ICI domain of up to 256) are
    summed and eliminated with a within-pod psum that STILL rides ICI;
    only the O(n_pods) pod-boundary system crosses pods on DCN. This is
    what the two-level scheme mis-prices: its level-2 charge assumes DCN
    for every cross-tray byte, but within one pod that exchange is ICI.
    """
    G = tray
    T_pod = max(pod // G, 1)        # trays per pod
    n_pods = max(D // pod, 1)
    c = shared_per_boundary
    lsh = int(c * D)
    lsh_t = int(c * (G - 1)) + 1
    lsh_p = int(c * T_pod) + 1
    lsh_x = int(c * n_pods) + 1
    wt = 3 * (G - 1) + 2 * lsh_t                  # tray interior width
    mk2 = 3 * T_pod + 2 * lsh_p                   # pod-level boundary
    mk3 = 3 * n_pods + 3 + 2 * lsh_x              # cross-pod boundary
    ms1 = wt + mk2 + mk3                          # level-1 sub-interface
    ms2 = mk2 + mk3                               # level-2 sub-interface
    return dict(
        payload_psum_l1_ici=(ms1 * ms1 + ms1) * F32,
        payload_psum_l2_ici=(ms2 * ms2 + ms2) * F32,
        payload_psum_l3_dcn=(mk3 * mk3 + mk3 + lsh * 8) * F32,
        n_collectives_ici=4, n_collectives_dcn=2,
        ms1=ms1, ms2=ms2, mk3=mk3, lsh=lsh)


def hier3_comm_time(D: int, tray: int, pod: int = 256, *,
                    shared_per_boundary: float = 2.0,
                    model: CommModel = CommModel(),
                    iterations: int = 1) -> float:
    """Per-solve comm time of the three-level solve: levels 1-2 ride ICI
    (tray group, then pod group), level 3 crosses pods on DCN."""
    pod = min(pod, D)
    v = hier3_bytes_per_iteration(D, tray, pod,
                                  shared_per_boundary=shared_per_boundary)
    G = tray
    T_pod = max(pod // G, 1)
    n_pods = max(D // pod, 1)
    ring_g = 2.0 * (G - 1) / G
    ring_p = 2.0 * (T_pod - 1) / T_pod if T_pod > 1 else 0.0
    ring_x = 2.0 * (n_pods - 1) / n_pods if n_pods > 1 else 0.0
    return iterations * (
        (ring_g * v["payload_psum_l1_ici"]
         + ring_p * v["payload_psum_l2_ici"]) / model.ici_bw_bytes_per_s
        + ring_x * v["payload_psum_l3_dcn"] / model.dcn_bw_bytes_per_s
        + v["n_collectives_ici"] * model.collective_latency_s
        * max(pod, 1) ** 0.5
        + (v["n_collectives_dcn"] * model.dcn_latency_s
           * max(n_pods, 1) ** 0.5 if n_pods > 1 else 0.0))


def flat_comm_time(D: int, *, shared_per_boundary: float = 2.0,
                   model: CommModel = CommModel(),
                   iterations: int = 1, cross_domain: bool = True) -> float:
    """Per-solve comm time of the FLAT resident DD at fleet scale: the
    shared set grows with the block count (lsh = c*D), so the single
    [m, m] interface psum has m = 3D + 3 + 2cD. Past one tray the flat
    psum necessarily crosses DCN (`cross_domain`)."""
    c = shared_per_boundary
    lsh = int(c * D)
    m = 3 * D + 3 + 2 * lsh
    ring = 2.0 * (D - 1) / D
    bw = model.dcn_bw_bytes_per_s if cross_domain and D > 8 \
        else model.ici_bw_bytes_per_s
    lat = model.dcn_latency_s if cross_domain and D > 8 \
        else model.collective_latency_s
    payload = (m * m + m + lsh * 8) * F32
    return iterations * (ring * payload / bw + 3 * lat * D ** 0.5)


def online_comm_time(D: int, *, bytes_per_lap: int, n_collectives: int,
                     model: CommModel = CommModel(),
                     cross_domain: bool = True) -> float:
    """Per-lap communication time of the ONLINE resident-map pipeline
    (parallel/resident_online.py) — the frontend tier VERDICT r3 next #7
    asked to fold into the efficiency predictions.

    Unlike the solver tiers there is no analytic shape formula here: the
    pass's per-device collective payload is MEASURED by the jaxpr walker
    (`parallel/instrument.py`) and is exactly D-invariant (association is
    shard-local [BN, L/D]; winners are [BN]-sized pmins; both solves psum
    a reduced system whose size is set by pose capacity, not L or D —
    verified at D = 2/4/8 in tests/test_instrument.py). So the model takes
    the measured per-lap bytes/count as inputs; callers should pass the
    instrumenter's while_mult=<GN iteration cap> UPPER bound (while-loop
    trip counts are dynamic and counted once by default). Ring factor and
    the DCN-past-one-tray convention match `flat_comm_time`."""
    ring = 2.0 * (D - 1) / D
    bw = model.dcn_bw_bytes_per_s if cross_domain and D > 8 \
        else model.ici_bw_bytes_per_s
    lat = model.dcn_latency_s if cross_domain and D > 8 \
        else model.collective_latency_s
    return ring * bytes_per_lap / bw + n_collectives * lat * D ** 0.5


def predict_efficiency_weak_online(t_lap_1dev_s: float, D: int, *,
                                   bytes_per_lap: int, n_collectives: int,
                                   model: CommModel = CommModel()) -> float:
    """WEAK-scaling efficiency of the online pipeline: the map grows with
    D at fixed per-device shard width, per-device compute and per-device
    collective payload constant (measured), so
    eff = t_lap / (t_lap + t_comm(D))."""
    t_comm = online_comm_time(D, bytes_per_lap=bytes_per_lap,
                              n_collectives=n_collectives, model=model)
    return t_lap_1dev_s / (t_lap_1dev_s + t_comm)


def predict_efficiency_weak(tier: str, t_comp_per_dev_s: float, D: int, *,
                            tray: int = 8, shared_per_boundary: float = 2.0,
                            model: CommModel = CommModel(),
                            iterations: int = 1) -> float:
    """WEAK-scaling efficiency — the pod-scale-mapping regime (BASELINE
    config 5): the fleet's map/chain grows with D, per-device compute
    constant. eff = t_pd / (t_pd + t_comm(D)). Tiers: 'chain_dd_resident'
    (flat interface, grows with D), 'chain_dd_hier' (two-level), or
    'chain_dd_hier3' (three-level; level-2 rides the pod's ICI)."""
    if tier == "chain_dd_hier3":
        t_comm = hier3_comm_time(D, tray,
                                 shared_per_boundary=shared_per_boundary,
                                 model=model, iterations=iterations)
    elif tier == "chain_dd_hier":
        t_comm = hier_comm_time(D, tray,
                                shared_per_boundary=shared_per_boundary,
                                model=model, iterations=iterations)
    elif tier == "chain_dd_resident":
        t_comm = flat_comm_time(D, shared_per_boundary=shared_per_boundary,
                                model=model, iterations=iterations)
    else:
        raise ValueError(tier)
    return t_comp_per_dev_s / (t_comp_per_dev_s + t_comm)
