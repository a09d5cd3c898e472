from .detector import detect_features, equalize_histogram, harris_score
from .klt import track_features
from .pyramid import build_pyramid
from .tracker import TrackerConfig, TrackerState, tracker_init, tracker_step

__all__ = [
    "TrackerConfig",
    "TrackerState",
    "build_pyramid",
    "detect_features",
    "equalize_histogram",
    "harris_score",
    "track_features",
    "tracker_init",
    "tracker_step",
]
