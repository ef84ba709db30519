"""Parameter structures for loam-jax.

These mirror the reference library's three parameter structs — ``LidarParams``
(``loam/include/loam/common.h:29-41``), ``FeatureExtractionParams``
(``loam/include/loam/features.h:37-66``) and ``RegistrationParams``
(``loam/include/loam/registration.h:40-75``) — with identical field names and
defaults so that configurations are drop-in compatible.

They are frozen (hashable) dataclasses so they can be passed as static
arguments to ``jax.jit``: every field participates in trace caching and shape
computation (feature capacities, sector sizes and iteration counts all
determine shapes or control flow of the compiled programs).
"""

from __future__ import annotations

import dataclasses



@dataclasses.dataclass(frozen=True)
class LidarParams:
    """Intrinsic LiDAR parameters (reference: ``common.h:29-41``).

    LOAM exploits the row-major range-image structure of spinning LiDAR
    scans; these parameters define that structure.
    """

    #: Number of scan lines (e.g. Ouster OS1-64 has 64).
    scan_lines: int
    #: Number of points per scan line (e.g. 1024).
    points_per_line: int
    #: Minimum valid range of the sensor.
    min_range: float
    #: Maximum valid range of the sensor.
    max_range: float

    def __post_init__(self):
        if self.scan_lines <= 0 or self.points_per_line <= 0:
            raise ValueError(
                f"LidarParams requires positive scan_lines/points_per_line, got "
                f"{self.scan_lines} x {self.points_per_line}"
            )

    @property
    def total_points(self) -> int:
        return self.scan_lines * self.points_per_line


@dataclasses.dataclass(frozen=True)
class FeatureExtractionParams:
    """Feature-extraction parameters (reference: ``features.h:37-66``).

    Field names, semantics and defaults match the reference exactly.
    """

    #: Number of neighbor points on either side used for curvature ([1] Eq. 1).
    neighbor_points: int = 3
    #: Number of sectors each scan line is split into for feature detection.
    number_sectors: int = 6
    #: Max edge features detected per sector. NOTE: like the reference
    #: (``features-inl.h:155``) up to ``max_edge_feats_per_sector + 1``
    #: features are actually admitted (the break fires only after the cap is
    #: exceeded).
    max_edge_feats_per_sector: int = 10
    #: Max planar features per sector (same off-by-one admission as above).
    max_planar_feats_per_sector: int = 50
    #: Unnormalized curvature must exceed this to be an edge feature.
    edge_feat_threshold: float = 100.0
    #: Unnormalized curvature must be below this to be a planar feature.
    planar_feat_threshold: float = 1.0
    #: Range jump between consecutive points flagged as occlusion boundary.
    occlusion_thresh: float = 0.5
    #: Range difference (as proportion of range) for beam-parallel surfaces.
    parallel_thresh: float = 1.0
    #: Extension (not in reference): compute the selection-critical
    #: quantities (curvature values for sorting/thresholds, range-gate /
    #: occlusion / parallel comparisons) in compensated double-float f32, so
    #: f32 feature SELECTION is bit-faithful to the reference's f64 math
    #: (~49-bit decisions; see ``loam_jax.ops.twofloat``). The selected
    #: points themselves stay f32 either way. Only affects f32 scans; f64
    #: scans already match the oracle directly.
    precise_selection: bool = True

    def __post_init__(self):
        if self.neighbor_points < 1:
            raise ValueError("neighbor_points must be >= 1")
        if self.number_sectors < 1:
            raise ValueError("number_sectors must be >= 1")

    # ---- derived static shapes -------------------------------------------------
    def points_per_sector(self, lidar: LidarParams) -> int:
        return lidar.points_per_line // self.number_sectors

    def max_sector_size(self, lidar: LidarParams) -> int:
        """Size of the largest sector (the last sector absorbs the remainder,
        reference ``features-inl.h:32-35``)."""
        pps = self.points_per_sector(lidar)
        return lidar.points_per_line - (self.number_sectors - 1) * pps

    def edge_capacity(self, lidar: LidarParams) -> int:
        """Fixed per-scan edge feature capacity (honors the reference's +1
        admission quirk, ``features-inl.h:155``)."""
        return lidar.scan_lines * self.number_sectors * (self.max_edge_feats_per_sector + 1)

    def planar_capacity(self, lidar: LidarParams) -> int:
        return lidar.scan_lines * self.number_sectors * (self.max_planar_feats_per_sector + 1)


@dataclasses.dataclass(frozen=True)
class RegistrationParams:
    """Registration (ICF) parameters (reference: ``registration.h:40-75``).

    Field names, semantics and defaults match the reference exactly.  A few
    extra fields control fixed-shape execution and are marked as such; they do not change observable behavior at their defaults.
    """

    #: k for the edge-point neighbor search in the target.
    num_edge_neighbors: int = 5
    #: Radius filter on edge neighbors (<= 0 disables).
    max_edge_neighbor_dist: float = 1.0
    #: Minimum neighbors required to fit a line.
    min_line_fit_points: int = 3
    #: Minimum line condition number.  NOTE: dead code in the reference —
    #: ``fitLine`` never assigns the computed ratio (``geometry.cpp:55-56``)
    #: so the guard at ``registration.cpp:49`` never rejects.  We replicate
    #: that effective behavior (guard disabled) unless
    #: ``enforce_line_condition`` is set.
    min_line_condition_number: float = 10.0

    #: k for the planar-point neighbor search in the target.
    num_plane_neighbors: int = 5
    #: Radius filter on plane neighbors (<= 0 disables).
    max_plane_neighbor_dist: float = 2.0
    #: Minimum neighbors required to fit a plane.
    min_plane_fit_points: int = 4
    #: Maximum average (signed, matching reference ``geometry.cpp:71``)
    #: point-to-plane distance for a valid plane fit.  NOTE: structurally
    #: inert in this implementation — the PCA plane fit's signed mean
    #: residual is exactly 0 by construction (``geometry.fit_plane``), so
    #: this guard can never fire at any threshold >= 0.  The reference's own
    #: guard compares the signed mean of a least-squares fit, which hovers
    #: at ~0 and almost never fires either (SURVEY §2.3(2)); behavior pinned
    #: in ``tests/test_registration.py::test_plane_avg_dist_guard_is_inert``.
    max_avg_point_plane_dist: float = 0.1

    #: Maximum outer ICF iterations.
    max_iterations: int = 10
    #: Convergence threshold on the rotation update magnitude (radians).
    rotation_convergence_thresh: float = 1e-3
    #: Convergence threshold on the translation update magnitude.
    position_convergence_thresh: float = 1e-2
    #: Minimum total associations required to attempt a solve.
    min_associations: int = 100

    # ---- extensions (not in reference) ------------------------------------------
    #: Inner Levenberg-Marquardt iterations per outer ICF iteration.  The
    #: reference hard-codes Ceres ``max_num_iterations = 4``
    #: (``registration-inl.h:52-53``); same default here.
    inner_iterations: int = 4
    #: Huber loss delta. The reference hard-codes ``HuberLoss(1.0)``
    #: (``registration.cpp:56,97``).
    huber_delta: float = 1.0
    #: If True, actually enforce the line condition-number guard the
    #: reference intended but dead-coded (see ``min_line_condition_number``).
    enforce_line_condition: bool = False
    #: Quadratic prior pulling the per-iteration delta toward zero (i.e.
    #: toward the initialization). 0 disables (reference behavior). With
    #: degenerate geometry (e.g. a single wall in view: no edges, planes
    #: constraining only one direction) the normal equations are rank
    #: deficient and an unregularized solve wanders along the unobservable
    #: directions; a prior of ~1e2-1e3 (units: residual-squared per rad^2 /
    #: m^2) keeps those components at the motion prior while perturbing
    #: well-observed solves by <1%.
    prior_weight: float = 0.0
    #: Implementation of the inner LM solve. Both values take the XLA
    #: op-chain path (one residual sweep per damped step, unrolled 6x6
    #: Cholesky); the field is kept for config compatibility.
    lm_impl: str = "auto"
    #: Neighbor-search backend: "bruteforce" (exact, every target visited;
    #: best for feature-set-sized targets) or "grid" (voxel-hash, best for
    #: map-scale targets; exact up to ``grid_max_per_cell`` occupancy).
    search_backend: str = "bruteforce"
    #: Per-voxel candidate cap for the "grid" backend.
    grid_max_per_cell: int = 64

    def __post_init__(self):
        for field, allowed in (
            ("lm_impl", ("auto", "xla")),
            ("search_backend", ("bruteforce", "grid")),
        ):
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field} must be one of {allowed}")


@dataclasses.dataclass(frozen=True)
class TerminationType:
    """Registration termination codes (reference ``registration.h:83``).

    Encoded as int32 codes in jit-compatible outputs.
    """

    CONVERGED = 0
    MAX_ITER = 1
    INSUFFICIENT_ASSOCIATIONS = 2
