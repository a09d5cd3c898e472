"""YAML configuration with the reference's key schema (counterpart of
``eqvio_tpu/io/config.py``): ``eqf:`` builds the filter :class:`Settings`,
``GIFT:`` the :class:`TrackerConfig`.  PyYAML is imported only by
:func:`load_config`, so the package runs where it is absent.
"""

from __future__ import annotations

import sys

from ..filter import Settings
from ..frontend.tracker import TrackerConfig

KLT_MODES = ("auto", "gather", "mxu", "pallas")  # the JAX package's KLT backends


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def template_config() -> dict:
    """``configs/config_template.yaml`` as a dict, for machines without PyYAML
    (a test keeps the two equal)."""
    return {
        "eqf": {
            "initialVariance": {
                "attitude": 1.0, "position": 1.0, "velocity": 1.0, "point": 5000.0,
                "pointDepth": -1.0, "cameraAttitude": 0.1, "cameraPosition": 0.1,
                "biasGyr": 1.0, "biasAcc": 1.0,
            },
            "processVariance": {
                "cameraPosition": 0.0001, "cameraAttitude": 0.0001, "biasGyr": 0.0001,
                "biasAcc": 0.0001, "attitude": 0.01, "position": 0.01, "velocity": 0.1,
                "point": 0.001,
            },
            "initialValue": {"sceneDepth": 1.0},
            "measurementNoise": {
                "feature": 2.0, "featureOutlierAbs": 100.0, "featureOutlierProb": 30.0,
                "featureRetention": 0.2,
            },
            "velocityNoise": {"gyr": 0.0001, "acc": 0.0001, "gyrBias": 0.0001, "accBias": 0.0001},
            "settings": {
                "fastRiccati": False, "useDiscreteInnovationLift": True,
                "useDiscreteVelocityLift": True, "coordinateChoice": "Euclidean",
                "useMedianDepth": True, "useFeaturePredictions": False,
                "useEquivariantOutput": True, "removeLostLandmarks": True,
                "useDiscreteStateMatrix": False,
            },
        },
        "GIFT": {
            "maxFeatures": 30, "featureDist": 20, "minHarrisQuality": 0.05,
            "featureSearchThreshold": 0.8, "maxError": 20.4, "winSize": 21, "maxLevel": 3,
            "trackedFeatureDist": 20.0, "equaliseImageHistogram": False,
            "ransacParams": {
                "inlierThreshold": 0.002, "maxIterations": 64, "minDataPoints": 8,
                "minInliers": 8,
            },
        },
        "main": {"writeState": True},
        "sim": {"maxFeatures": 30, "numPoints": 1000, "wallDistance": 2.0, "numWalls": 4},
    }


def racing_proxy_config() -> dict:
    """``configs/config_racing_proxy.yaml`` as a dict, for machines without
    PyYAML (a test keeps the two equal): the UZH-FPV tuned values with the
    proxy's measured scene depth, equalisation, 40 features, ``kltMode: mxu``
    and the epipolar gate off."""
    return {
        "eqf": {
            "initialValue": {"sceneDepth": 6.94},
            "initialVariance": {
                "pointDepth": -1.0, "attitude": 0.10282752317467045, "biasAcc": 1.2232071190499316,
                "biasGyr": 1.1673134780260075, "cameraAttitude": 1.727825980507864e-07,
                "cameraPosition": 3.349654391578276e-07, "point": 100.0, "position": 0.00011220184543019634,
                "velocity": 3.6517412725483775e-06,
            },
            "measurementNoise": {
                "feature": 3.7583740428844425, "featureOutlierAbs": 5.4509224619256385,
                "featureOutlierProb": 0.23374912831534894, "featureRetention": 0.2,
            },
            "processVariance": {
                "attitude": 6.219421634147766e-08, "biasAcc": 0.0, "biasGyr": 0.0,
                "cameraAttitude": 2.2630153511576583e-06, "cameraPosition": 6.853895838650084e-07,
                "point": 0.000530103448340995, "position": 1.2589961848499808e-05, "velocity": 0.012232071190499315,
            },
            "settings": {
                "coordinateChoice": "InvDepth", "fastRiccati": True, "useDiscreteStateMatrix": False,
                "useDiscreteInnovationLift": False, "useDiscreteVelocityLift": True, "useEquivariantOutput": True,
                "useFeaturePredictions": False, "useMedianDepth": False, "removeLostLandmarks": True,
            },
            "velocityNoise": {
                "acc": 3.262345818455677e-05, "accBias": 0.0063404671195099425, "gyr": 0.0011913242870580211,
                "gyrBias": 0.00020008996495836354,
            },
        },
        "GIFT": {
            "kltMode": "mxu", "equaliseImageHistogram": True, "featureDist": 25.91373395034039,
            "featureSearchThreshold": 0.7, "maxError": 100.08998519259788, "maxFeatures": 40, "maxLevel": 3,
            "minHarrisQuality": 0.08859465154404257, "trackedFeatureDist": 9.995503774595479, "winSize": 21,
            "ransacParams": {"inlierThreshold": 0.0, "maxIterations": 20, "minDataPoints": 10, "minInliers": 37},
        },
        "main": {"cameraLag": 0.0, "limitRate": 0.0, "startTime": 0.0, "writeState": True},
    }


def _euroc_proxy_config(scene_depth: float) -> dict:
    """The EuRoC proxies' configuration: the reference's tuned stationary-init
    EuRoC values (InvDepth, fast Riccati, continuous innovation lift, fixed
    depth, 40 features, the epipolar gate on) with the proxy's measured
    start-scene depth."""
    return {
        "eqf": {
            "initialValue": {"sceneDepth": scene_depth},
            "initialVariance": {
                "pointDepth": -1.0, "attitude": 0.13565029126052572, "biasAcc": 1.5813333765300104,
                "biasGyr": 97162.79515771076, "cameraAttitude": 0.0010228558965517584,
                "cameraPosition": 0.023501400846134893, "point": 129.90415638150924, "position": 0.1,
                "velocity": 8.974852995731e-08,
            },
            "measurementNoise": {
                "feature": 1.9297839969591413, "featureOutlierAbs": 4.852186665580312,
                "featureOutlierProb": 0.03229809583062128, "featureRetention": 0.18594708334486176,
            },
            "processVariance": {
                "attitude": 6.025875320811407e-05, "biasAcc": 0.0, "biasGyr": 0.0,
                "cameraAttitude": 5.075382174045239e-06, "cameraPosition": 1.2188313140115635e-05,
                "point": 0.00029845436136043135, "position": 9.981466095928483e-06,
                "velocity": 0.025317333863551263,
            },
            "settings": {
                "coordinateChoice": "InvDepth", "fastRiccati": True, "useDiscreteStateMatrix": False,
                "useDiscreteInnovationLift": False, "useDiscreteVelocityLift": True, "useEquivariantOutput": True,
                "useFeaturePredictions": False, "useMedianDepth": False, "removeLostLandmarks": True,
            },
            "velocityNoise": {
                "acc": 0.012438843268295521, "accBias": 0.004462289865453429, "gyr": 0.000243153572917808,
                "gyrBias": 0.00013372703521098622,
            },
        },
        "GIFT": {
            "equaliseImageHistogram": False, "featureDist": 79.80937096082073, "maxError": 76.21556706799433,
            "maxFeatures": 40, "maxLevel": 3, "minHarrisQuality": 0.0792713927794865,
            "featureSearchThreshold": 0.8854861727179565, "trackedFeatureDist": 30.79127938908608, "winSize": 21,
            "ransacParams": {"inlierThreshold": 0.0023121620935037416, "maxIterations": 34, "minDataPoints": 5,
                             "minInliers": 30},
        },
        "main": {"limitRate": 0.0, "startTime": 0.0, "writeState": True},
    }


def mh03_proxy_config() -> dict:
    """``configs/config_mh03_proxy.yaml`` as a dict, for machines without
    PyYAML (a test keeps the two equal)."""
    return _euroc_proxy_config(9.0)


def v101_proxy_config() -> dict:
    """``configs/config_v101_proxy.yaml`` as a dict, for machines without
    PyYAML (a test keeps the two equal)."""
    return _euroc_proxy_config(3.36)


def bench_config(base: dict | None = None) -> dict:
    """The benchmark's configuration: the template (or ``base``) with the
    algorithm switches of the shipped EuRoC config (fast Riccati, InvDepth,
    continuous innovation lift, fixed 4.3 m initial depth), 30 features and a
    21 px window.  Square-root covariance is set explicitly, so a float64 run
    takes the same path that float32 enables by default."""
    import copy

    cfg = copy.deepcopy(base if base is not None else template_config())
    cfg["GIFT"]["maxFeatures"] = 30
    cfg["GIFT"]["winSize"] = 21
    cfg["eqf"]["initialValue"]["sceneDepth"] = 4.3
    cfg["eqf"]["settings"] = {
        **(cfg["eqf"].get("settings") or {}),
        "fastRiccati": True,
        "coordinateChoice": "InvDepth",
        "useDiscreteInnovationLift": False,
        "useMedianDepth": False,
        "useSqrtCovariance": True,
    }
    return cfg


def safe_get(node, path: str, default=None, warn: bool = True):
    """Colon-path access with a warning on missing keys."""
    cur = node
    for key in path.split(":"):
        if not isinstance(cur, dict) or key not in cur:
            if warn:
                print(f"[config] key not found: {path}", file=sys.stderr)
            return default
        cur = cur[key]
    return cur


def _se3_literal(value):
    """Parse ``["xw", x, y, z, qw, qx, qy, qz]`` (or ``"wx"`` order)."""
    if value is None:
        return (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    order = str(value[0])
    nums = [float(v) for v in value[1:]]
    if order == "xw":
        pos, quat = nums[0:3], nums[3:7]
    elif order == "wx":
        quat, pos = nums[0:4], nums[4:7]
    else:
        raise ValueError(f"unknown SE3 literal order {order!r}")
    return tuple(quat), tuple(pos)


_COORD_ALIAS = {"euclidean": "euclid", "invdepth": "invdepth", "normal": "normal"}


def settings_from_config(cfg: dict, warn: bool = False) -> Settings:
    """Filter settings from the ``eqf:`` section (same keys and defaults as
    ``eqvio_tpu.io.config.settings_from_config``)."""
    eqf = cfg.get("eqf", {})
    g = lambda p, d: safe_get(eqf, p, d, warn=warn)  # noqa: E731
    coord = str(g("settings:coordinateChoice", "Euclidean")).lower()
    quat, pos = _se3_literal(g("initialValue:cameraOffset", None))
    return Settings(
        bias_omega_process_var=g("processVariance:biasGyr", 0.001),
        bias_accel_process_var=g("processVariance:biasAcc", 0.001),
        attitude_process_var=g("processVariance:attitude", 0.001),
        position_process_var=g("processVariance:position", 0.001),
        velocity_process_var=g("processVariance:velocity", 0.001),
        point_process_var=g("processVariance:point", 0.001),
        camera_attitude_process_var=g("processVariance:cameraAttitude", 0.001),
        camera_position_process_var=g("processVariance:cameraPosition", 0.001),
        measurement_noise=g("measurementNoise:feature", 2.0),
        outlier_threshold_abs=g("measurementNoise:featureOutlierAbs", 1e8),
        outlier_threshold_prob=g("measurementNoise:featureOutlierProb", 1e8),
        feature_retention=g("measurementNoise:featureRetention", 0.3),
        vel_gyr_noise=g("velocityNoise:gyr", 1e-4),
        vel_acc_noise=g("velocityNoise:acc", 1e-3),
        vel_gyr_bias_walk=g("velocityNoise:gyrBias", 1e-5),
        vel_acc_bias_walk=g("velocityNoise:accBias", 1e-3),
        initial_attitude_var=g("initialVariance:attitude", 1e-4),
        initial_position_var=g("initialVariance:position", 1e-4),
        initial_velocity_var=g("initialVariance:velocity", 1e-2),
        initial_point_var=g("initialVariance:point", 1.0),
        initial_point_depth_var=g("initialVariance:pointDepth", -1.0),
        initial_bias_omega_var=g("initialVariance:biasGyr", 0.1),
        initial_bias_accel_var=g("initialVariance:biasAcc", 0.1),
        initial_camera_attitude_var=g("initialVariance:cameraAttitude", 1e-5),
        initial_camera_position_var=g("initialVariance:cameraPosition", 1e-4),
        initial_scene_depth=g("initialValue:sceneDepth", 1.0),
        use_discrete_innovation_lift=g("settings:useDiscreteInnovationLift", True),
        use_discrete_velocity_lift=g("settings:useDiscreteVelocityLift", True),
        use_discrete_state_matrix=g("settings:useDiscreteStateMatrix", False),
        use_accurate_riccati=(
            not g("settings:fastRiccati", False)
            and not g("settings:useDiscreteStateMatrix", False)
        ),
        fast_riccati=g("settings:fastRiccati", False),
        use_median_depth=g("settings:useMedianDepth", True),
        use_feature_predictions=g("settings:useFeaturePredictions", False),
        use_equivariant_output=g("settings:useEquivariantOutput", True),
        remove_lost_landmarks=g("settings:removeLostLandmarks", True),
        sqrt_covariance=safe_get(eqf, "settings:useSqrtCovariance", False, warn=False),
        coordinate_choice=_COORD_ALIAS.get(coord, "euclid"),
        camera_offset_quat=quat,
        camera_offset_pos=pos,
    )


def tracker_config_from_config(cfg: dict) -> TrackerConfig:
    """Tracker config from the ``GIFT:`` section; ``maxError`` is on 0-255
    intensities and converts to the tracker's 0-1 images by /255.

    ``kltMode`` takes the JAX package's values (``auto``, ``gather``,
    ``mxu``, ``pallas``; another raises).  Every value runs this package's
    one KLT, the CUDA kernel on the card and its plain version on the CPU:
    both compute the gather path's semantics, which ``mxu`` matches to
    8e-6 px."""
    gift = cfg.get("GIFT", {})
    g = lambda k, d: gift.get(k, d)  # noqa: E731
    if g("kltMode", "auto") not in KLT_MODES:
        raise ValueError(f"unknown kltMode {g('kltMode', 'auto')!r} (use one of {', '.join(KLT_MODES)})")
    return TrackerConfig(
        max_features=int(g("maxFeatures", 30)),
        feature_dist=int(g("featureDist", 20)),
        min_harris_quality=float(g("minHarrisQuality", 0.05)),
        tracked_feature_dist=float(g("trackedFeatureDist", 20.0)),
        win_size=int(g("winSize", 21)),
        max_level=int(g("maxLevel", 3)),
        max_error=float(g("maxError", 1e8)) / 255.0,
        feature_search_threshold=float(g("featureSearchThreshold", 1.0)),
        equalize_histogram=bool(g("equaliseImageHistogram", False)),
        flow_outlier_threshold=float(g("flowOutlierThreshold", 0.0)),
        **_ransac_kwargs(gift),
    )


def _ransac_kwargs(gift: dict) -> dict:
    """``GIFT:ransacParams`` onto the batched gate: ``inlierThreshold`` is in
    normalised-camera units, scaled by a nominal 450 px focal length unless
    ``ransacInlierThresholdPx`` is given; ``maxIterations`` hypotheses run at
    once."""
    rp = gift.get("ransacParams", None)
    if not rp:
        return {}
    nominal_focal = 450.0
    thr_px = float(gift.get("ransacInlierThresholdPx",
                            float(rp.get("inlierThreshold", 1.0 / nominal_focal))
                            * nominal_focal))
    return {
        "ransac_inlier_threshold": thr_px,
        "ransac_hypotheses": max(int(rp.get("maxIterations", 64)), 16),
        "ransac_min_inliers": int(rp.get("minInliers", 8)),
    }


def sim_params_from_config(cfg: dict) -> dict:
    """The ``sim:`` section as ``prepare_sim_inputs`` keyword arguments
    (trajectory, duration, rates, features, points, walls, seed and the
    noise switches, in the reference's key names)."""
    sim = cfg.get("sim", {}) or {}
    mapping = {
        "trajectory": ("kind", str),
        "duration": ("end_time", float),
        "imuFreq": ("imu_freq", float),
        "imageFreq": ("frame_freq", float),
        "maxFeatures": ("max_features", int),
        "numPoints": ("num_points", int),
        "numWalls": ("num_walls", int),
        "randomSeed": ("seed", int),
        "initialNoise": ("initial_noise", bool),
        "inputNoise": ("input_noise", bool),
        "outputNoise": ("output_noise", bool),
    }
    return {name: cast(sim[key]) for key, (name, cast) in mapping.items() if key in sim}
