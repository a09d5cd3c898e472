from .asl import ASLDatasetReader, CameraInfo, GroundTruth, ImageSeq, IMUSeq
from .server import DataServer, Measurement, create_dataset_reader
from .synthetic import SyntheticASLReader, bench_scene, shifted_texture_pair

__all__ = [
    "ASLDatasetReader",
    "CameraInfo",
    "DataServer",
    "GroundTruth",
    "IMUSeq",
    "ImageSeq",
    "Measurement",
    "SyntheticASLReader",
    "bench_scene",
    "create_dataset_reader",
    "shifted_texture_pair",
]
