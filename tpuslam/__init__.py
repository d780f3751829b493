"""tpuslam — a landmark GraphSLAM framework in JAX, run on an NVIDIA GPU.

Brand-new JAX/XLA implementation with the capabilities of the CFSD18
Formula Student Driverless SLAM stack (reference:
cfsd/opendlv-logic-cfsd18-sensation-slam, surveyed in SURVEY.md).

Subpackages
-----------
geometry   SE(2) ops, spherical->Cartesian sensor model, WGS84 Mercator geodesy
frontend   frame assembly, keyframe gating, EKF motion model, map state
ops        dense data association (the semantics reference)
backend    factor-graph state + Gauss-Newton optimizer (landmark-Schur)
core       the Slam orchestrator (ingest API mirroring the reference service)
parallel   mesh setup, sharded association, distributed Schur reduction
io         OD4 envelope codec, .rec replay, UDP multicast session, exporters
sim        synthetic tracks, noise models, VLP-16 cloud sim + cone detection
runtime    config, metrics, tracing, checkpointing, service shell
viz        map/trajectory/factor-graph rendering (replaces the Pangolin viewer)
cli        `slamctl` command-line interface
"""

__version__ = "0.1.0"
