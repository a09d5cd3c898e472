from .asl import ASLDatasetReader, CameraInfo, GroundTruth, ImageSeq, IMUSeq
from .server import DataServer, Measurement, create_dataset_reader
from .synthetic import (
    SyntheticASLReader,
    SyntheticUZHFPVReader,
    bench_scene,
    distractor_proxy,
    mh03_proxy,
    noised_lanes,
    racing_proxy,
    shifted_texture_pair,
    v101_proxy,
)
from .uzhfpv import UZHFPVDatasetReader

__all__ = [
    "ASLDatasetReader",
    "CameraInfo",
    "DataServer",
    "GroundTruth",
    "IMUSeq",
    "ImageSeq",
    "Measurement",
    "SyntheticASLReader",
    "SyntheticUZHFPVReader",
    "UZHFPVDatasetReader",
    "bench_scene",
    "create_dataset_reader",
    "distractor_proxy",
    "mh03_proxy",
    "noised_lanes",
    "racing_proxy",
    "shifted_texture_pair",
    "v101_proxy",
]
