from .config import (
    bench_config,
    load_config,
    mh03_proxy_config,
    racing_proxy_config,
    safe_get,
    settings_from_config,
    sim_params_from_config,
    template_config,
    tracker_config_from_config,
    v101_proxy_config,
)
from .timing import LoopTimer
from .writer import VIOWriter, rotation_to_quaternion

__all__ = [
    "LoopTimer",
    "VIOWriter",
    "bench_config",
    "load_config",
    "mh03_proxy_config",
    "racing_proxy_config",
    "rotation_to_quaternion",
    "safe_get",
    "settings_from_config",
    "sim_params_from_config",
    "template_config",
    "tracker_config_from_config",
    "v101_proxy_config",
]
