from .asl import ASLDatasetReader, CameraInfo, GroundTruth, ImageSeq, IMUSeq
from .server import DataServer, Measurement, create_dataset_reader
from .synthetic import SyntheticASLReader, SyntheticUZHFPVReader, bench_scene, racing_proxy, shifted_texture_pair
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
    "racing_proxy",
    "shifted_texture_pair",
]
