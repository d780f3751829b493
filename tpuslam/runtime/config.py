"""Typed configuration — every reference CLI flag and magic constant, promoted.

The reference splits configuration between ten CLI flags
(reference src/opendlv-logic-cfsd18-sensation-slam.cpp:52-55, canonical values
in usecase/docker-compose.yml:14) and a scatter of hard-coded constants
(SURVEY.md §5.6). Here everything is one frozen dataclass, hashable so it can
be a jit static argument. Defaults reproduce the reference usecase deployment.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from tpuslam import compat
from tpuslam.backend.graph import GraphCapacity


@dataclass(frozen=True)
class SlamConfig:
    # --- reference CLI flags (usecase/docker-compose.yml:14) ---
    cid: int = 111                        # OD4 session id
    sender_id: int = 120                  # our senderStamp ("--id")
    detect_cone_id: int = 118             # accept cone msgs from this senderStamp
    estimation_id: int = 114              # accept pose/yaw msgs from this senderStamp
    gathering_time_ms: float = 10.0       # cone frame-assembly window
    same_cone_threshold: float = 1.2      # association gate [m]
    ref_latitude: float = 57.714787       # WGS84 local-frame origin
    ref_longitude: float = 11.948313
    time_between_keyframes_ms: float = 500.0
    cone_mapping_threshold: float = 50.0  # max range to create a landmark [m]
    cones_per_packet: int = 20            # cones published per update

    # --- promoted reference constants (SURVEY.md §5.6) ---
    odo_info: float = compat.REF_ODOMETRY_INFO
    lm_info: float = compat.REF_LANDMARK_INFO
    loop_closure_radius: float = compat.REF_LOOP_CLOSURE_RADIUS
    loop_closure_min_index: int = compat.REF_LOOP_CLOSURE_MIN_INDEX
    lidar_to_cog: float = compat.REF_LIDAR_TO_COG
    yaw_rate_scale: float = compat.REF_YAW_RATE_SCALE
    gn_iterations: int = compat.REF_GN_ITERATIONS
    gps_outlier_bound: float = compat.REF_GPS_OUTLIER_BOUND

    # --- behavior switches (clean math vs reference-faithful quirks) ---
    reference_compat: bool = True         # use quirky constants/remaps (tpuslam.compat)
    association: str = "first"            # 'first' (reference), 'nearest', 'mahalanobis'
    localizer_type_bug: bool = True       # reference src/slam.cpp:360 signed type compare
    localizer_refine: bool = False        # pose-only GN in localization mode (improvement)
    periodic_gn_every: int = 0            # >0: re-optimize every k keyframes (improvement)
    periodic_gn_iterations: int = 3       # GN iterations per periodic pass
                                          # (warm-started, so few are needed;
                                          # closure still runs gn_iterations)
    periodic_gn_window: int = 0           # >0: periodic refinement is
                                          # FIXED-LAG — GN over the trailing
                                          # k poses with the map held fixed
                                          # (gn.optimize_window, a fraction
                                          # of the full re-optimize's work);
                                          # 0 = full-batch periodic GN. The
                                          # closure optimization is always
                                          # full-batch.
    periodic_gn_edge_window: int = 1024   # trailing landmark-edge slice the
                                          # fixed-lag refinement considers
                                          # (completeness knob — see
                                          # gn.window_gn_step). The firing
                                          # cost is dominated by the
                                          # [W, EW] x [EW, L] coupling
                                          # contractions, so EW sizes the
                                          # solve: 1024 covers a 64-pose
                                          # window at ~9 obs/frame (~600
                                          # in-window edges) with ~70%
                                          # slack at half the 2048 cost
    periodic_gn_window_landmarks: bool = True
                                          # fixed-lag refinement also updates
                                          # the map (landmarks anchored by
                                          # their marginalized observation
                                          # information); False = pose-only
    mahalanobis_gate: float = 9.21        # chi2(2) 99% gate for 'mahalanobis' mode
    obs_noise_std: float = 0.3            # assumed range sigma [m] for the
                                          # Mahalanobis measurement information
    obs_noise_az_deg: float = 0.3         # assumed azimuth sigma [deg] — the
                                          # tangential information is
                                          # 1/(range * sigma_az_rad)^2
    vectorized_mapping: bool = True       # batched mapping step (same semantics,
                                          # no per-observation scan; False =
                                          # lax.scan form)
    mapping_publish_refine: bool = False  # improvement: the PUBLISHED pose in
                                          # mapping mode is a per-frame MAP
                                          # estimate (landmark-fixed 3x3 GN
                                          # over the frame's matched cones +
                                          # the GPS/heading prior) instead of
                                          # the raw/graph estimate. Decouples
                                          # online accuracy from the periodic
                                          # GN cadence: every frame publishes
                                          # a refined pose, the map refresh
                                          # stays on its own schedule. State
                                          # and the map are untouched.
                                          # Requires vectorized_mapping.
    publish_refine_obs_info: float = 25.0 # per-cone weight of the publish
                                          # refine vs the GPS/heading prior.
                                          # Deliberately BELOW lm_info (100):
                                          # the map itself drifts between
                                          # refreshes, so the output filter
                                          # trusts it less than the solver
                                          # does. Swept 4/10/25/100 on long
                                          # + short trackdrive: 25 gave the
                                          # best online ATE on both
    in_frame_dup_depth: int = 4           # max same-frame duplicate-chain depth
                                          # merged by the vectorized step; the
                                          # scan form is unbounded (sequential);
                                          # physical cone layouts have depth <= 1
    use_ekf_fusion: bool = False          # CTRV EKF fuses GPS/heading/yaw at
                                          # message rate; keyframes use the
                                          # filtered pose (improvement over
                                          # the reference's yaw-only hack)
    use_gps_prior: bool = False           # improved mode: absolute GPS/heading
                                          # unary factors anchor the graph
                                          # (replaces gauge clamping)
    gps_prior_std: float = 0.15           # GPS xy sigma [m] for the prior
    heading_prior_std: float = 0.05       # heading sigma [rad] for the prior
    gn_matmul_precision: str = "highest"  # dot precision for GN assembly/Schur
                                          # ("highest"|"high"|"default"); see
                                          # GNConfig.matmul_precision
    gn_early_exit_tol: float = 1e-4       # stop GN once max|update| falls to
                                          # this (0 = always run gn_iterations
                                          # like the reference). These graphs
                                          # converge in 1-2 iterations; the
                                          # f32 noise floor is ~1e-5/step, so
                                          # 1e-4 bounds the deviation from the
                                          # full 10 passes well below ATE
                                          # measurement noise.

    # --- capacities (static shapes) ---
    capacity: GraphCapacity = field(default_factory=GraphCapacity)
    max_obs_per_frame: int = 64           # reference collector is 4x100 (src/slam.cpp:46)

    def with_(self, **kw) -> "SlamConfig":
        return replace(self, **kw)

    @classmethod
    def improved(cls, **kw) -> "SlamConfig":
        """The beats-the-reference configuration: nearest-neighbor
        association, absolute GPS/heading priors instead of gauge clamping,
        calibrated information weights, localization refinement, periodic
        fixed-lag re-optimization, and per-frame published-pose MAP
        refinement. On the trackdrive benchmark lap it publishes at
        0.1019 m online ATE (block 32, every-16 refresh, on an H100 and on
        the CPU alike — chip_smoke.py); publication refinement decouples
        online accuracy from the refresh cadence (see MIGRATION.md)."""
        base = dict(reference_compat=False, association="nearest",
                    localizer_type_bug=False, localizer_refine=True,
                    use_gps_prior=True, lm_info=100.0, odo_info=1.0,
                    periodic_gn_every=16, periodic_gn_window=64,
                    mapping_publish_refine=True)
        base.update(kw)
        if base["periodic_gn_every"] == 0 and \
                "mapping_publish_refine" not in kw:
            # publication refinement needs a periodically REFRESHED map;
            # against a never-optimized (odometry-drifted) map it measures
            # WORSE than the raw publish (0.210 vs 0.168 m trackdrive) —
            # auto-off unless the caller asks explicitly
            base["mapping_publish_refine"] = False
        return cls(**base)

    @classmethod
    def from_cli_args(cls, args: dict) -> "SlamConfig":
        """Build from reference-style --key=value flags (strings)."""
        m = {
            "cid": ("cid", int), "id": ("sender_id", int),
            "detectConeId": ("detect_cone_id", int),
            "estimationId": ("estimation_id", int),
            "gatheringTimeMs": ("gathering_time_ms", float),
            "sameConeThreshold": ("same_cone_threshold", float),
            "refLatitude": ("ref_latitude", float),
            "refLongitude": ("ref_longitude", float),
            "timeBetweenKeyframes": ("time_between_keyframes_ms", float),
            "coneMappingThreshold": ("cone_mapping_threshold", float),
            "conesPerPacket": ("cones_per_packet", int),
        }
        kw = {}
        for k, v in args.items():
            if k in m:
                name, conv = m[k]
                kw[name] = conv(v)
        return cls(**kw)

    @property
    def gps_reference(self):
        return (self.ref_latitude, self.ref_longitude)
