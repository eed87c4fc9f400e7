"""Configuration tree.

Mirrors the reference's namespaced global config (reference:
orb_slam2/include/orb_slam/config.h:11-142, src/config.cpp:7-137, YAML files
orb_ros/cfg/euroc_mono.yaml / tsukuba.yaml) as immutable dataclasses instead
of mutable globals.  Defaults below are the compiled defaults of
src/config.cpp overridden where the shipped YAMLs pin tuned values.

The port keeps its own copy of the JAX package's config tree: the same
dataclasses, defaults and YAML schema.  `yaml` is imported only when a file
is read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics of the (rectified) input stream.

    Reference: config.h `namespace camera`; shipped YAMLs store *rectified*
    intrinsics matching the loader's remap (cfg/euroc_mono.yaml:7-18).
    """

    width: int = 752
    height: int = 480
    fx: float = 356.1094055175781
    fy: float = 418.0326843261719
    cx: float = 362.7542616160936
    cy: float = 250.18023338917374
    # radial/tangential distortion of the *raw* stream (applied by the loader
    # when rectifying; the SLAM core always sees undistorted pixels).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 20.0
    is_rgb: bool = True   # parsed for YAML parity; inert here (loaders
    #                       decode straight to grayscale; the reference
    #                       only uses it to pick RGB2GRAY vs BGR2GRAY,
    #                       tracker.cpp:122)


@dataclass(frozen=True)
class DustConfig:
    """Direct dustbin-alignment coarse tracker thresholds.

    Reference: config.cpp `tracking::dust`, cfg/euroc_mono.yaml dust block.
    """

    c2_thresh: float = 81.0
    gather: str = "kf_local"  # candidate source, selecting the reference's
    #                           retained coarse-tracker variants
    #                           (tracker_dust.cpp): "kf_local" =
    #                           trackFrameDustKFLocal (:22-228, production),
    #                           "last" = trackFrameDust (last frame only,
    #                           :406+), "kf" = trackFrameDustKF (reference
    #                           KF only, :230-404)
    th_ratio: float = 0.35
    th_ninlier: int = 20
    th_nmatch: int = 20
    iters: int = 40          # LM iterations of the dust alignment (optimizer_dust.cpp:254)
    huber_delta: float = 0.9  # robust kernel delta (optimizer_dust.cpp:227)
    chi2_inlier: float = 0.9  # inlier gate on dust chi2 (optimizer_dust.cpp:262)


@dataclass(frozen=True)
class MotionConfig:
    """Constant-velocity projection tracker thresholds (config.cpp tracking::motion)."""

    th_window_size: int = 15
    th_nmatch_proj: int = 20
    th_nmatch_opt: int = 10
    th_nn_ratio: float = 1.0  # parity-dead, as in the reference: mfNNratio
    #                           is only read by SearchForInitialization
    #                           (sp_matcher.cpp:715), whose call site passes
    #                           an explicit 0.9; the motion/map projection
    #                           matchers never consult it


@dataclass(frozen=True)
class LocalMapTrackConfig:
    """TrackLocalMap thresholds (config.cpp tracking::map)."""

    th_view_cos: float = 0.5
    th_window_size: int = 1
    th_window_retry: float = 5.0  # widened window for the starvation retry
    #                               (reference precedent: th=5 after reloc)
    th_window_reloc: float = 10.0  # windowed frame<->KF growth pass inside
    #                                relocalization (SearchByProjection
    #                                overload, sp_matcher.cpp:1545-1634;
    #                                stock ORB-SLAM2 passes th=10)
    th_ninlier_high: int = 50
    th_ninlier_low: int = 6
    th_nn_ratio: float = 1.0  # parity-dead (see MotionConfig.th_nn_ratio)
    match_adaptive: bool = True


@dataclass(frozen=True)
class TrackingConfig:
    """Reference: config.cpp `namespace tracking` + YAML tracking block."""

    num_features: int = 800
    scale_check: bool = False  # parity no-op: gates octave filtering in
    #                            GetFeaturesInArea (sp_matcher.cpp:369-372)
    #                            which is inert with the 1-level SP pyramid
    #                            (every keypoint is octave 0); False in both
    #                            shipped configs
    # coarse tracker variant: "dust" (1/8 dustbin alignment, the production
    # path, tracker_dust.cpp:22-228) or "heat" (full-resolution heat
    # alignment, the retained experimental trackFrameHeat variant,
    # tracker_dust.cpp:405-446)
    coarse_method: str = "dust"
    # OK-path fast lane (TPU-native; no reference counterpart): run the
    # dust coarse stage and the local-map fine stage as ONE device program
    # per frame with the coarse->fine handoff in-graph and the local-map
    # candidate set speculated from the previous frame's final bindings
    # (tracking._try_fused / kernels.fused_track_body).  Halves the
    # per-frame device roundtrips on the success path; False restores the
    # two-call path (the fallback cascade always uses it).
    fused_ok_path: bool = True
    heat_chi2_inlier: float = 0.02  # optimizer_dust.cpp:~500 (heat variant)
    create_kf_tracked_over_ref: float = 0.5
    create_kf_tracked_over_curr: float = 0.4
    create_kf_ref_ratio: float = 0.7
    create_kf_nmatch: int = 5
    # Offline-mode KF pacing (NOTES.md round 2, open item 4).  In the
    # reference's online mode the mapper is busy for ~1 KF of work after
    # each insert, so the always-idle branch of NeedNewKeyFrameOverride
    # (tracker.cpp:643 `bLocalMappingIdle`) cannot fire back-to-back; the
    # deterministic offline drive (spinOnce after every frame,
    # system.cpp:176-178) makes it fire every frame that passes c2, which
    # bursts low-parallax KFs onto a young map and destabilizes BA.  These
    # two gates apply ONLY to the bare-idle creation path (never to the
    # weak-tracking c1b or starvation c3 paths).  0 disables either.
    # Default 5 (round-5 A/B, measured on BOTH rails): 10-seed sweep ATE
    # mean 0.0084 -> 0.0070 / max 0.020 -> 0.0141 with fewer KFs
    # (17.6 -> 15.3); rendered image rail ATE 0.0707 -> 0.0667 (50 -> 46
    # KFs), loop still closes, 0 LOST.  gap 3 and baseline-ratio gates
    # measured as no-ops.  At 20 fps this is 4 KF/s max on the idle path —
    # the reference's online regime gets the same pacing implicitly from
    # mapper busyness.
    create_kf_min_gap: int = 5          # min frames since the last KF
    create_kf_min_baseline_ratio: float = 0.0  # min baseline(frame, refKF)
    #   / refKF scene median depth; below ~0.01 local mapping skips the
    #   pair for triangulation anyway (local_mapper.cpp baseline gate), so
    #   such a KF adds BA load without adding depth information
    init_min_parallax_deg: float = 2.0  # two-view init gate: median parallax
    #   of the accepted triangulations must exceed this before the initial
    #   map is created.  DEVIATION from the reference (which accepts any
    #   Initialize() success): a near-zero-baseline init births the whole
    #   initial cloud with 1/parallax-amplified depth error and the map
    #   starts life poisoned (measured: init at frame 3 of the synthetic
    #   rail -> Sim3-to-scene p50 residual 0.38; gated init -> 0.1).
    #   0 disables.
    dust: DustConfig = field(default_factory=DustConfig)
    motion: MotionConfig = field(default_factory=MotionConfig)
    map: LocalMapTrackConfig = field(default_factory=LocalMapTrackConfig)


@dataclass(frozen=True)
class DepthFilterConfig:
    """Depth-uncertainty gating + SVO-style seed delayed insertion.

    The reference ships a *vestigial* DepthFilter/Seed (src/cv/
    depth_filter.cpp:35-60, Vogiatzis Beta-Gaussian inverse-depth seeds)
    that is never wired into the mapper; here it is a working subsystem
    because near-zero-baseline keyframe pairs amplify depth error by
    1/parallax and poison the pose fit (the dominant mono-drift mode —
    see tests/test_depth_filter.py).

    Semantics: triangulation candidates whose relative depth uncertainty
    tau/z (SVO computeTau, one-pixel disparity propagated through the
    triangulation geometry) exceeds `max_rel_sigma` are NOT inserted as
    map points; instead they update Bayesian inverse-depth seeds on the
    current keyframe and are promoted once the posterior converges.
    """

    enabled: bool = True             # (the reference's is vestigial-off;
    #                                  ours measurably de-poisons the map —
    #                                  NOTES.md round-2)
    max_rel_sigma: float = 0.15      # direct-insert gate on tau/z
    seed_px_noise: float = 1.0       # pixel disparity std driving tau
    convergence_div: float = 30.0    # promote when sigma < z_range/div
    promote_rel_sigma: float = 0.15  # ... or posterior sqrt(sigma2)/mu below
    #                                  (= max_rel_sigma: a fused estimate as
    #                                  certain as a direct insert qualifies)
    max_seed_age: int = 7            # drop seeds unpromoted after N KFs
    min_direct_inserts: int = 20     # starvation guard: if a keyframe gains
    #                                  fewer direct inserts than this, admit
    #                                  the least-uncertain deferred candidates
    #                                  (rel order) up to the floor — gating
    #                                  must not starve tracking through a
    #                                  degenerate segment
    starve_bound_th: int = 150       # ... but only when the keyframe is
    #                                  actually starving: rescue fires only if
    #                                  its bound map-point count is below this
    #                                  (a healthy KF with 300+ bindings that
    #                                  happens to triangulate little new does
    #                                  NOT need uncertain points force-fed)


@dataclass(frozen=True)
class MappingConfig:
    """Reference: config.cpp `namespace mapping` + YAML mapping block."""

    culling_kf: bool = True
    kf_culling_method: str = "override"  # "override" =
    #   KeyFrameCullingOverride (local_mapper.cpp:979-1032, production:
    #   iteratively cull the worst redundancy ratio); "override2" =
    #   KeyFrameCullingOverride2 (:906-977: among above-ratio candidates
    #   cull the minimum parent-distance KF, repeat); "plain" =
    #   KeyFrameCulling (:1034-1097: single pass, strict > num_obs)
    kf_culling_cov_ratio: float = 0.95
    kf_culling_num_obs: int = 5
    triangulation_nn_ratio: float = 1.0  # parity-dead, as in the reference:
    #                                      SearchForTriByFlann hardcodes its
    #                                      0.7 ratio (sp_matcher.cpp:202-207)
    #                                      and ignores the constructed value
    triangulation_num_kfs: int = 8
    matching_method: int = 1  # 1 = ANN/dense (flann in ref), 2 = epipolar walk
    offline_kf_pace: int = 3  # offline mode: frames the mapper reports
    #   not-accepting after ingesting a KF, emulating the online backend's
    #   processing latency (~100-160 ms/KF at 20 fps = 2-3 frames,
    #   local_mapper.cpp:129-229).  Offline spinOnce makes the mapper
    #   always-idle, which lets the KF policy's `idle` term fire every
    #   frame and create consecutive near-zero-baseline keyframe bursts
    #   (measured: 5 KFs in frames 17-21 of the synthetic rail re-poison
    #   the BA-repaired map).  0 restores always-idle.
    depth_filter: DepthFilterConfig = dataclasses.field(
        default_factory=DepthFilterConfig)


@dataclass(frozen=True)
class ExtractorConfig:
    """Learned frontend operating point.

    Reference: SPExtractor ctor + nms call site (src/cv/sp_extractor.cpp:342-357,
    502-503) and SPFrontend forward (conf threshold hardcoded 0.007 at :122).
    """

    cell_size: int = 8
    conf_thresh: float = 0.007
    nms_dist: int = 4
    border: int = 8
    nms_iters: int = 16        # rounds of the NMS commit/reject fixed point
    nms_method: str = "auto"   # "auto" = "cuda" on a CUDA device, "xla" on
    #                            the CPU; both run the same fixed point
    #                            (ops/cuda_nms.py kernel vs ops/nms.py)
    cov_window: int = 8        # flood-fill window radius for covariance
    cov_iters: int = 16        # propagation rounds of the flood fill
    cov_method: str = "auto"   # "auto" = "cuda" on a CUDA device,
    #                            "windowed" on the CPU; both run the same
    #                            windowed fill (ops/cuda_cov.py kernel vs
    #                            ops/covariance.py)
    desc_method: str = "auto"  # descriptor bilinear sampling: "auto" =
    #                            "pallas_sparse" (the sparse sampling
    #                            kernel, ops/cuda_desc.py) on a CUDA device,
    #                            "gather" (plain 4-corner gather) on the
    #                            CPU; "pallas" / "dense" sample every cell's
    #                            candidate (kernel / plain stencil) and pick
    #                            each keypoint's row
    conv_packing: str = "auto"  # "auto" = the fused first-conv-pair kernel
    #                             ("pair1", ops/cuda_pair1.py, the
    #                             persistent design) on the bfloat16 path
    #                             on a CUDA device, "none" (cuDNN / CPU
    #                             convs) elsewhere; "pair1t"
    #                             (ops/cuda_pair1t.py, the transposed
    #                             design of the same function) on request;
    #                             "s2d" / "s2d2" / "s2d3" (the JAX
    #                             package's space-to-depth lowerings of
    #                             the same function) run as "none", the
    #                             faster of the two on the H100 (PERF.md)
    dtype: str = "float32"     # compute dtype of the conv net ("bfloat16" for speed)


@dataclass(frozen=True)
class LoopConfig:
    """VLAD loop closer knobs (reference: loop_closer_vlad.cpp)."""

    use_loop: bool = False
    min_score_floor: float = 0.2       # loop_closer_vlad.cpp:165
    covisibility_consistency_th: int = 3
    kf_gap: int = 10                   # skip if <10 KFs since last loop (:132)
    global_desc_dim: int = 4096
    # Place-recognition descriptor source.  The reference's NetVLAD is an
    # empty stub — descriptors come from precomputed .bin files
    # (data_loader.cc:87-109); here they are computed in-process
    # (models/netvlad.py) when the dataset doesn't provide them:
    #   "auto"    — dataset-provided if present, else computed per keyframe
    #   "dataset" — only dataset-provided (reference Export-loader parity)
    #   "vlad"    — always computed (ignore dataset descriptors)
    global_desc_source: str = "auto"
    netvlad_weights: str = ""          # .npz (centroids/proj/alpha); seeded
    #                                    random init when empty
    netvlad_clusters: int = 64


@dataclass(frozen=True)
class RuntimeConfig:
    """Capacity caps turning the dynamic reference structures into static shapes.

    The reference already caps everything (150 dust points, 80 local KFs,
    8 triangulation KFs); these are the padded array capacities.
    """

    max_keypoints: int = 896            # >= num_features+1, MXU-aligned
    dust_points_cap: int = 256          # >= the 150-point dust gather target
    local_points_cap: int = 4096        # local-map points in TrackLocalMap
    local_kfs_cap: int = 80             # tracker.cpp:936
    ba_kfs_cap: int = 32                # local-BA camera block cap
    ba_points_cap: int = 4096           # local-BA point cap
    ba_obs_cap: int = 16384             # local-BA observation cap
    init_ransac_iters: int = 200        # initializer.cpp RANSAC mMaxIterations
    streams: int = 1                    # batched parallel streams per chip
    prefetch_extract: bool = True       # single-stream spin: dispatch frame
    #   t+1's extraction before frame t's mapping/loop host work so device
    #   compute + the d2h roundtrip overlap the host spin (bit-identical:
    #   extraction is a pure jit function of the image)


@dataclass(frozen=True)
class Config:
    """Top-level config (reference: `namespace common` + everything above)."""

    seq: str = ""
    data_path: str = ""
    model_path: str = ""
    dataset: str = "euroc"
    output_path: str = "/tmp/sp_orb_slam_tpu"
    use_loop: bool = False
    verbose: bool = False
    online: bool = False
    # run counted FAILED when Sim3-APE mean or RMSE exceeds this
    # (1.0 m EuRoC, 100 for the cm-scale Tsukuba GT; evo_euroc.py:56,
    # evo_tsukuba.py:50)
    eval_failure_threshold: float = 1.0
    camera: CameraConfig = field(default_factory=CameraConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    extractor: ExtractorConfig = field(default_factory=ExtractorConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    @property
    def grid_h(self) -> int:
        return self.camera.height // self.extractor.cell_size

    @property
    def grid_w(self) -> int:
        return self.camera.width // self.extractor.cell_size


def _merge_dataclass(dc: Any, overrides: Mapping[str, Any]) -> Any:
    """Recursively apply a nested dict of overrides onto a frozen dataclass."""
    kwargs = {}
    names = {f.name: f for f in dataclasses.fields(dc)}
    for key, value in overrides.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {type(dc).__name__}")
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            kwargs[key] = _merge_dataclass(current, value)
        else:
            kwargs[key] = type(current)(value) if current is not None else value
    return dataclasses.replace(dc, **kwargs)


# Translation of the reference YAML schema (cfg/*.yaml) into our tree.
_REF_KEY_MAP = {
    "use_loop": ("use_loop",),
    "camera": ("camera",),
    "tracking": ("tracking",),
    "mapping": ("mapping",),
}


def _from_reference_yaml(raw: Mapping[str, Any]) -> dict:
    """Convert a reference-format YAML dict (cfg/euroc_mono.yaml schema) into
    our nested override dict."""
    out: dict = {}
    if "use_loop" in raw:
        out["use_loop"] = bool(raw["use_loop"])
    cam = raw.get("camera", {})
    if cam:
        c = {k: cam[k] for k in ("width", "height", "fx", "fy", "cx", "cy", "fps", "is_rgb") if k in cam}
        dist = cam.get("distortion")
        if dist:
            for i, name in enumerate(["k1", "k2", "p1", "p2", "k3"][: len(dist)]):
                c[name] = float(dist[i])
        out["camera"] = c
    tr = raw.get("tracking", {})
    if tr:
        t = {
            k: tr[k]
            for k in (
                "num_features",
                "scale_check",
                "create_kf_tracked_over_ref",
                "create_kf_tracked_over_curr",
                "create_kf_ref_ratio",
                "create_kf_nmatch",
            )
            if k in tr
        }
        for sub in ("dust", "motion", "map"):
            if sub in tr:
                t[sub] = dict(tr[sub])
        out["tracking"] = t
    mp = raw.get("mapping", {})
    if mp:
        out["mapping"] = {
            k: mp[k]
            for k in (
                "culling_kf",
                "kf_culling_cov_ratio",
                "kf_culling_num_obs",
                "triangulation_nn_ratio",
                "triangulation_num_kfs",
                "matching_method",
            )
            if k in mp
        }
    # our own extensions pass through verbatim
    for key in ("extractor", "runtime", "loop", "seq", "data_path", "model_path",
                "dataset", "output_path", "verbose", "online",
                "eval_failure_threshold"):
        if key in raw:
            out[key] = raw[key]
    return out


def load_config(path: str | None = None, overrides: Mapping[str, Any] | None = None) -> Config:
    """Build a Config from an (optional) YAML file + (optional) override dict.

    Accepts both the reference YAML schema (orb_ros/cfg/*.yaml) and our
    native nested schema.
    """
    cfg = Config()
    if path is not None:
        import yaml  # only needed to read a YAML file

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        cfg = _merge_dataclass(cfg, _from_reference_yaml(raw))
    if overrides:
        cfg = _merge_dataclass(cfg, overrides)
    return cfg


def euroc_config(**kw) -> Config:
    """The shipped EuRoC operating point (cfg/euroc_mono.yaml)."""
    return _merge_dataclass(Config(), kw) if kw else Config()


def tsukuba_config(**kw) -> Config:
    """The shipped New Tsukuba operating point (cfg/tsukuba.yaml)."""
    base = _merge_dataclass(
        Config(),
        {
            "dataset": "tsukuba",
            "camera": {"width": 640, "height": 480, "fx": 615.0, "fy": 615.0,
                       "cx": 320.0, "cy": 240.0},
            "tracking": {
                "create_kf_nmatch": 25,
                "dust": {"th_ratio": 0.3},
                "motion": {"th_nmatch_proj": 10, "th_nmatch_opt": 5},
            },
        },
    )
    return _merge_dataclass(base, kw) if kw else base
