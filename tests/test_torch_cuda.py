"""The CUDA kernels of the PyTorch port on the card (``cuda`` marker).

Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the repository's conftest (which configures
JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from eqvio_tpu_torch.data import SyntheticASLReader
from eqvio_tpu_torch.frontend import build_pyramid, tracker
from eqvio_tpu_torch.kernels import klt as K

WIN, ITERS, LEVELS = 21, 8, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _frame_pair(device):
    """Two consecutive moving frames of a small synthetic scene, their
    pyramids, and features in the interior and within 10 px of the borders."""
    reader = SyntheticASLReader(end_time=2.0, width=320, height=240, frame_freq=10.0, num_points=300)
    f0, f1 = (torch.tensor(reader.load_image_u8(i), device=device).float() / 255.0 for i in (10, 11))
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform([30, 30], [290, 210], (24, 2)),
                          [[5, 100], [314, 50], [160, 4], [100, 235], [8, 8], [311, 231]]])
    pos = torch.tensor(pts, dtype=torch.float32, device=device)
    return build_pyramid(f0, LEVELS), build_pyramid(f1, LEVELS), pos


@pytest.mark.cuda
def test_klt_kernel_matches_plain_on_card(cuda_device):
    pyr0, pyr1, pos = _frame_pair(cuda_device)
    guess = pos + 0.5
    before = K.klt_track_pyramid.launches
    pos_k, err_k = K.klt_track_pyramid(pyr0, pyr1, pos, guess, WIN, ITERS)
    torch.cuda.synchronize()
    assert K.klt_track_pyramid.launches == before + 1
    pos_p, err_p = K.klt_track_pyramid_plain(pyr0, pyr1, pos, guess, WIN, ITERS)
    ok = (err_p < 0.08) & torch.isfinite(pos_p).all(1)
    assert torch.equal(ok, (err_k < 0.08) & torch.isfinite(pos_k).all(1))
    assert int(ok.sum()) >= 20
    # block-reduction vs torch.sum order: float32 round-off only
    torch.testing.assert_close(pos_k[ok], pos_p[ok], atol=2e-4, rtol=0)
    torch.testing.assert_close(err_k[ok], err_p[ok], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_klt_wrapper_raises_instead_of_falling_back(cuda_device):
    pyr0, pyr1, pos = _frame_pair(cuda_device)
    with pytest.raises(ValueError):
        K.klt_track_pyramid(pyr0, pyr1, pos.double(), pos.double(), WIN, ITERS)
    with pytest.raises(ValueError):
        K.klt_track_pyramid([p.cpu() for p in pyr0], pyr1, pos, pos, WIN, ITERS)
    with pytest.raises(ValueError):
        K.klt_track_pyramid(pyr0, pyr1, pos, pos, 33, ITERS)  # 33 * 33 threads > 1024


@pytest.mark.cuda
def test_tracker_step_on_card_matches_cpu(cuda_device):
    """Three tracker frames on the card (kernel) and on the CPU (plain):
    the same tracked slots and ids, positions within 1e-3 px."""
    reader = SyntheticASLReader(end_time=1.0, width=320, height=240, frame_freq=10.0, num_points=300)
    cfg = tracker.TrackerConfig(max_features=20, win_size=15, max_error=0.08,
                                feature_search_threshold=0.8, ransac_inlier_threshold=0.9)
    s_gpu = tracker.tracker_init(cfg, (240, 320), cuda_device)
    s_cpu = tracker.tracker_init(cfg, (240, 320), "cpu")
    before = K.klt_track_pyramid.launches
    for i in range(3):
        img = torch.tensor(reader.load_image_u8(i)).float() / 255.0
        s_gpu = tracker.tracker_step(s_gpu, img.to(cuda_device), cfg)
        s_cpu = tracker.tracker_step(s_cpu, img, cfg)
        assert torch.equal(s_gpu.mask.cpu(), s_cpu.mask)
        assert torch.equal(s_gpu.ids.cpu(), s_cpu.ids)
        torch.testing.assert_close(s_gpu.positions.cpu(), s_cpu.positions, atol=1e-3, rtol=0)
    assert K.klt_track_pyramid.launches == before + 3
