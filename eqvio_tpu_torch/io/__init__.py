from .config import (
    bench_config,
    load_config,
    racing_proxy_config,
    safe_get,
    settings_from_config,
    template_config,
    tracker_config_from_config,
)
from .timing import LoopTimer
from .writer import VIOWriter, rotation_to_quaternion

__all__ = [
    "LoopTimer",
    "VIOWriter",
    "bench_config",
    "load_config",
    "racing_proxy_config",
    "rotation_to_quaternion",
    "safe_get",
    "settings_from_config",
    "template_config",
    "tracker_config_from_config",
]
