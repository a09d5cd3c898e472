"""The CUDA kernels of the PyTorch port on the card (``cuda`` marker).

Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the repository's conftest (which configures
JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from eqvio_tpu_torch.app import run_opt as R
from eqvio_tpu_torch.data import SyntheticASLReader, mh03_proxy, noised_lanes, racing_proxy, shifted_texture_pair
from eqvio_tpu_torch.frontend import build_pyramid, prng, tracker
from eqvio_tpu_torch.graph import WARMUP_STEPS, broadcast_lanes
from eqvio_tpu_torch.io import bench_config, load_config, mh03_proxy_config, racing_proxy_config, template_config
from eqvio_tpu_torch.kernels import klt as K
from eqvio_tpu_torch.kernels import klt_bench as B
from eqvio_tpu_torch.kernels import ransac as RK
from eqvio_tpu_torch.kernels import ransac_bench as RB

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
    ok = _hold_to_plain(pyr0, pyr1, pos, pos + 0.5)
    assert int(ok.sum()) >= 20


def _hold_to_plain(pyr0, pyr1, pos, guess, truth=None, max_error=0.08):
    """Kernel against plain version: equal tracked masks, <= 2e-4 px (the
    reductions' order differs from torch.sum's: float32 round-off only).
    With ``truth``, positions are compared where the plain track lies within
    0.05 px of it: a lost track that passes the residual gate sits on a flat
    stretch of the cost, where round-off alone moves it further (the plain
    version in float32 and float64 differ by 7e-4 px on one such track)."""
    before = K.klt_track_pyramid.launches
    pos_k, err_k = K.klt_track_pyramid(pyr0, pyr1, pos, guess, WIN, ITERS)
    torch.cuda.synchronize()
    assert K.klt_track_pyramid.launches == before + 1
    pos_p, err_p = K.klt_track_pyramid_plain(pyr0, pyr1, pos, guess, WIN, ITERS)
    ok = (err_p < max_error) & torch.isfinite(pos_p).all(1)
    assert torch.equal(ok, (err_k < max_error) & torch.isfinite(pos_k).all(1))
    held = ok if truth is None else ok & ((pos_p - truth).norm(dim=1) < 0.05)
    torch.testing.assert_close(pos_k[held], pos_p[held], atol=2e-4, rtol=0)
    torch.testing.assert_close(err_k[held], err_p[held], atol=1e-5, rtol=0)
    return held


@pytest.mark.cuda
def test_klt_kernel_far_travel(cuda_device):
    """A large true motion with a zero-motion guess: the coarsest level's
    iterates travel more than 3 px, and the kernel equals the plain
    version."""
    shift = (48, -40)
    f0, f1 = shifted_texture_pair(480, 752, shift, device=cuda_device)
    pyr0, pyr1 = build_pyramid(f0, LEVELS), build_pyramid(f1, LEVELS)
    rng = np.random.default_rng(4)
    pos = torch.tensor(rng.uniform([120, 100], [632, 380], (30, 2)), dtype=torch.float32, device=cuda_device)
    truth = pos + torch.tensor(shift, dtype=torch.float32, device=cuda_device)
    ok = _hold_to_plain(pyr0, pyr1, pos, pos, truth=truth)
    top = LEVELS - 1
    coarse, _ = K.track_level(pyr0[top], pyr1[top], pos / 2**top, pos / 2**top, WIN, ITERS)
    travel = (coarse - pos / 2**top).abs().max(1).values
    assert int((ok & (travel > 3)).sum()) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64])
def test_klt_kernel_feature_counts(cuda_device, n):
    """One feature and 64 (more than the main path's 30) equal the plain
    version."""
    f0, f1 = shifted_texture_pair(240, 320, (3, -2), device=cuda_device)
    pyr0, pyr1 = build_pyramid(f0, LEVELS), build_pyramid(f1, LEVELS)
    rng = np.random.default_rng(n)
    pts = torch.tensor(rng.uniform([16, 16], [304, 224], (n, 2)), dtype=torch.float32, device=cuda_device)
    ok = _hold_to_plain(pyr0, pyr1, pts, pts)
    assert int(ok.sum()) >= (n + 1) // 2


@pytest.mark.cuda
def test_klt_kernel_matches_plain_at_racing_shape(cuda_device):
    """Frames 100 and 101 of the racing proxy, equalised, with its 40
    detected corners and its residual gate (``maxError`` 100 of 255): the
    fisheye main path's shape (640x480, 4 levels)."""
    case = B.klt_case(cuda_device, racing_proxy(end_time=3.8), config=racing_proxy_config())
    assert case.main.shape == (40, 2) and case.pyr0[0].shape == (480, 640)
    ok = _hold_to_plain(case.pyr0, case.pyr1, case.main, case.main, max_error=case.max_error)
    assert int(ok.sum()) >= 30


@pytest.mark.cuda
def test_klt_library_reload_keeps_ptxas_report(cuda_device):
    """The built library's ptxas report names the kernel; a reload from
    disk (as a second process would do) finds the same report."""
    K.build_kernel()
    summary = K.build.ptxas_summary(K._SOURCE)
    assert any("klt_pyramid_kernel" in name for name in summary)
    assert all(p["registers"] > 0 for p in summary.values())
    K.build._loaded.pop(K._SOURCE)
    K._fn.cache_clear()
    K.build_kernel()
    assert K.build.ptxas_summary(K._SOURCE) == summary


@pytest.mark.cuda
def test_klt_wrapper_raises_instead_of_falling_back(cuda_device):
    pyr0, pyr1, pos = _frame_pair(cuda_device)
    with pytest.raises(ValueError):
        K.klt_track_pyramid(pyr0, pyr1, pos.double(), pos.double(), WIN, ITERS)
    with pytest.raises(ValueError):
        K.klt_track_pyramid([p.cpu() for p in pyr0], pyr1, pos, pos, WIN, ITERS)
    with pytest.raises(ValueError):
        K.klt_track_pyramid(pyr0, pyr1, pos, pos, 33, ITERS)  # 33 * 33 threads > 1024


def _hold_gate(label, inputs, threshold, hypotheses, min_inliers) -> dict:
    """The gate kernel on the card, input by input: bit for bit its numpy
    float32 mirror (``kernels/ransac_bench.py:kernel_mirror``), one launch
    a call, and against the plain version equal masks, or a near tie
    (``ransac_bench.near_tie``).  Prints and returns the near-tie frames by
    kind."""
    ties = {}
    for i, g in enumerate(inputs):
        before = RK.ransac_mask.launches
        got = RK.ransac_mask(*g, threshold, hypotheses, 8, min_inliers)
        torch.cuda.synchronize()
        assert RK.ransac_mask.launches == before + 1
        mirror = RB.kernel_mirror(g, threshold, hypotheses, 8, min_inliers)
        assert torch.equal(got.cpu(), mirror), f"{label}, input {i}: kernel {got.int().tolist()}, mirror " \
                                               f"{mirror.int().tolist()}"
        want = RK.ransac_mask_plain(*g, threshold, hypotheses, 8, min_inliers)
        if not torch.equal(got, want):
            why = RB.near_tie(got, g, threshold, hypotheses, min_inliers)
            assert why is not None, f"{label}, input {i}: kernel {got.int().tolist()}, plain {want.int().tolist()}"
            ties[why] = ties.get(why, 0) + 1
    print(f"{label}: {len(inputs)} inputs, masks equal on {len(inputs) - sum(ties.values())}, near ties {ties}")
    return ties


def _proxy_gate_inputs(scene: str, frames: int):
    """The gate's inputs over the first ``frames`` frames of a proxy scene,
    tracked on the card by its benchmark configuration's tracker: MH_03
    with the EuRoC gate (34 hypotheses, 1.04 px, 30 inliers), racing with
    the UZH-FPV gate (20 hypotheses, 0.446 px, 37 inliers)."""
    if scene == "mh03":
        reader, config = mh03_proxy(frames / 20.0 + 0.5), mh03_proxy_config()
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        reader, config = racing_proxy(frames / 30.0 + 0.5), load_config(os.path.join(repo, "configs",
                                                                                    "config_UZHFPV.yaml"))
    return RB.gate_inputs(reader, config, frames, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["mh03", "racing"])
def test_ransac_kernel_matches_plain_on_proxy_frames(cuda_device, scene):
    """220 frames of each proxy scene, with the configuration's gate and
    again with ``min_inliers`` 0, where every frame's refit shows: the
    kernel's masks equal its mirror's bit for bit, and the plain version's
    or differ at a near tie (counted and printed)."""
    inputs, kw = _proxy_gate_inputs(scene, 220)
    assert len(inputs) == 220 and kw["hypotheses"] == {"mh03": 34, "racing": 20}[scene]
    assert sum(int(g.mask.sum()) >= 8 for g in inputs) >= 200
    _hold_gate(f"{scene}, its gate", inputs, kw["threshold"], kw["hypotheses"], kw["min_inliers"])
    _hold_gate(f"{scene}, min_inliers 0", inputs, kw["threshold"], kw["hypotheses"], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_ransac_kernel_matches_plain_on_two_views(cuda_device, seed):
    """The default 64 hypotheses on a scene with a real consensus (0.9 px):
    the outliers cut, the inliers kept, as the plain version does."""
    prev, curr, mask = (torch.tensor(a, device=cuda_device) for a in RB.two_view(seed, n=40))
    g = RB.GateInput(prev, curr, mask, prng.prng_key(7, cuda_device), torch.tensor(seed * 37, device=cuda_device))
    assert not _hold_gate(f"two views, seed {seed}", [g], 0.9, 64, 8)
    got = RK.ransac_mask(*g, 0.9, 64, 8, 8)
    assert got[5:-3].all() and int(got[:5].sum()) <= 2 and not got[-3:].any()


@pytest.mark.cuda
def test_ransac_kernel_edge_cases(cuda_device):
    """Fewer than 8 tracked and all masked give the mask back; a refit
    below ``min_inliers`` keeps the mask; 45 tracks (not a multiple of a
    warp), 300 (more than a block's threads) and 64 x 200 (past 48 kB of
    shared memory) equal the plain version."""
    key, nid = prng.prng_key(7, cuda_device), torch.tensor(5, device=cuda_device)
    prev, curr, mask = (torch.tensor(a, device=cuda_device) for a in RB.two_view(3, n=45))
    few = mask & (torch.arange(45, device=cuda_device) < 7)
    cases = [("fewer than 8 tracked", (prev, curr, few, key, nid), 64, 8, few),
             ("all masked", (prev, curr, torch.zeros_like(mask), key, nid), 64, 8, torch.zeros_like(mask)),
             ("refit below min_inliers", (prev, curr, mask, key, nid), 64, 43, mask),
             ("45 tracks", (prev, curr, mask, key, nid), 64, 8, None)]
    for n, k in ((300, 16), (200, 64)):
        p, c, m = (torch.tensor(a, device=cuda_device) for a in RB.two_view(n, n=n))
        cases.append((f"{k} x {n}", (p, c, m, key, nid), k, 8, None))
    assert RK.smem_bytes(200, 64) > 48 * 1024
    for label, g, k, min_inliers, expect in cases:
        assert not _hold_gate(label, [RB.GateInput(*g)], 0.9, k, min_inliers)
        if expect is not None:
            assert torch.equal(RK.ransac_mask(*g, 0.9, k, 8, min_inliers), expect), label


@pytest.mark.cuda
def test_ransac_kernel_lanes_equal_single_lanes(cuda_device):
    """Eight lanes in one launch, under vmap with a shared key and called
    with a key per lane: every lane bitwise its own single-lane launch."""
    views = [RB.two_view(b, n=40) for b in range(8)]
    prev, curr, mask = (torch.tensor(np.stack(a), device=cuda_device) for a in zip(*views))
    ids = torch.arange(8, device=cuda_device) * 11
    key = prng.prng_key(7, cuda_device)
    for min_inliers in (8, 0):
        gate = lambda p, c, m, i: RK.ransac_mask(p, c, m, key, i, 0.9, 34, 8, min_inliers)  # noqa: E731
        before = RK.ransac_mask.launches
        lanes = torch.func.vmap(gate)(prev, curr, mask, ids)
        direct = RK.ransac_mask(prev, curr, mask, key.expand(8, 2).contiguous(), ids, 0.9, 34, 8, min_inliers)
        torch.cuda.synchronize()
        assert RK.ransac_mask.launches == before + 2
        for b in range(8):
            one = gate(prev[b], curr[b], mask[b], ids[b])
            assert torch.equal(lanes[b], one) and torch.equal(direct[b], one), f"lane {b}"
        assert RK.ransac_mask.launches == before + 10


@pytest.mark.cuda
def test_ransac_wrapper_raises_instead_of_falling_back(cuda_device):
    prev, curr, mask = (torch.tensor(a, device=cuda_device) for a in RB.two_view(0, n=40))
    key, nid = prng.prng_key(7, cuda_device), torch.tensor(0, device=cuda_device)
    with pytest.raises(ValueError):
        RK.ransac_mask(prev.double(), curr.double(), mask, key, nid)
    with pytest.raises(ValueError):
        RK.ransac_mask(prev, curr, mask.cpu(), key, nid)
    with pytest.raises(ValueError):
        RK.ransac_mask(prev, curr, mask, key, nid, hypotheses=0)
    with pytest.raises(ValueError):
        RK.ransac_mask(prev, curr, mask, key, nid, hypotheses=2000)  # 2000 x 40 draws: past a block's shared memory


@pytest.mark.cuda
def test_fused_step_holds_one_gate_kernel(cuda_device):
    """The captured frame step holds one gate kernel with the gate on (the
    benchmark config's 64 hypotheses) and none with it off."""
    reader = SyntheticASLReader(end_time=2.0, width=320, height=240, frame_freq=10.0, num_points=300)
    off = bench_config()
    off["GIFT"]["ransacParams"]["inlierThreshold"] = 0.0
    for config, want in ((bench_config(), 1), (off, 0)):
        _, s = R.run_dataset(reader, config, device="cuda", chunk_size=8, limit_frames=16)
        assert s["ransac_kernels_per_step"] == want


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


def fused_inputs(reader, config, frames: int, device: str, dtype=torch.float32):
    """The fused path's inputs for the first ``frames`` frames, assembled and
    packed as ``run_dataset`` does (``collect_fused_inputs``): ``(uint8
    images [T, H, W], meta [T, 8K+2], attitude-initialised state, tracker,
    settings, tracker config, camera, K)``, the images and meta on ``device``."""
    inp = R.collect_fused_inputs(reader, config, frames, dtype, device)
    dev = torch.device(device)
    return (torch.as_tensor(inp.imgs).to(dev), torch.as_tensor(inp.meta, dtype=dtype).to(dev),
            inp.state, inp.tracker, inp.settings, inp.tcfg, inp.camera, inp.imu_window)


def _fused_case(device, frames: int = 10, config: dict | None = None, dtype=torch.float32):
    """The fused path's inputs for ``frames`` frames of a small scene on the
    card, and a chunk runner from its attitude-initialised state."""
    reader = SyntheticASLReader(end_time=2.0, width=320, height=240, frame_freq=10.0, num_points=300)
    config = bench_config() if config is None else config
    imgs, meta, state, trk, settings, tcfg, camera, win = fused_inputs(reader, config, frames, "cuda", dtype)
    runner = R.ChunkRunner(tcfg, settings, settings.suite, camera, win, dtype, state, trk, device)
    step = R._make_frame_fn(tcfg, settings, settings.suite, camera, win, dtype)
    return imgs, meta, runner, step, (state, trk), tcfg.max_features


@pytest.mark.cuda
def test_graph_replay_matches_eager_steps(cuda_device):
    """Ten frames replayed from the captured graph equal the same frame step
    run eagerly on the card: the same tracked ids and masks, positions
    within 1e-5 m (the same float32 kernels run in both; round-off only).
    The KLT wrapper counts the eager warm-up launches alone: the capture
    records the kernel and the replays launch it outside the wrapper."""
    imgs, meta, runner, step, carry, N = _fused_case(cuda_device)
    before = K.klt_track_pyramid.launches
    outs = runner.run(imgs, meta)
    assert runner.step.graph is not None and runner.step.pool_bytes >= 0
    assert K.klt_track_pyramid.launches == before + WARMUP_STEPS
    for i in range(imgs.shape[0]):
        carry, ref = step(carry, imgs[i], meta[i])
        assert torch.equal(outs[i, 34 + 7 * N:], ref[34 + 7 * N:]), f"frame {i} ids or masks"
        assert torch.equal(outs[i, 34 + 3 * N:34 + 5 * N], ref[34 + 3 * N:34 + 5 * N]), f"frame {i} landmarks"
        torch.testing.assert_close(outs[i, 9:12], ref[9:12], atol=1e-5, rtol=0)
    assert int(outs[-1, 34 + 8 * N:].sum()) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["sqrt-f32", "dense-f64"])
def test_accurate_riccati_replay_matches_eager_steps(cuda_device, dtype):
    """The template config's frame step (accurate Riccati with the on-device
    expm, Euclidean, median depth; square-root in float32, dense in float64)
    replayed from the graph equals the same step run eagerly: the same ids
    and masks, positions within 1e-5 m."""
    imgs, meta, runner, step, carry, N = _fused_case(cuda_device, frames=4, config=template_config(), dtype=dtype)
    outs = runner.run(imgs, meta)
    assert runner.step.graph is not None
    for i in range(imgs.shape[0]):
        carry, ref = step(carry, imgs[i], meta[i])
        assert torch.equal(outs[i, 34 + 7 * N:], ref[34 + 7 * N:]), f"frame {i} ids or masks"
        torch.testing.assert_close(outs[i, 9:12], ref[9:12], atol=1e-5, rtol=0)
    assert bool(torch.isfinite(outs).all())


@pytest.mark.cuda
def test_replay_runs_without_host_sync(cuda_device):
    """After the capture, a chunk's replays and copies run under
    ``set_sync_debug_mode("error")``, which raises on any synchronising call."""
    imgs, meta, runner, _, _, _ = _fused_case(cuda_device, frames=6)
    runner.run(imgs[:2], meta[:2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = runner.run(imgs[2:], meta[2:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs).all())


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device, monkeypatch):
    """A step that syncs the host runs eagerly in the warm-up, but its
    capture fails, and the runner raises instead of running eagerly."""
    real = R._make_frame_fn

    def with_host_sync(*args):
        fn = real(*args)

        def frame_fn(carry, img, meta):
            carry, out = fn(carry, img, meta)
            out.sum().item()  # a host sync: a CUDA graph cannot capture it
            return carry, out
        return frame_fn

    monkeypatch.setattr(R, "_make_frame_fn", with_host_sync)
    imgs, meta, runner, _, _, _ = _fused_case(cuda_device, frames=2)
    with pytest.raises(RuntimeError):
        runner.run(imgs, meta)
    assert runner.step.graph is None


def _sim_runner(device, dtype, **opts):
    from eqvio_tpu_torch import filter as F
    from eqvio_tpu_torch import runner as SR

    settings = F.Settings(measurement_noise=0.5, coordinate_choice="invdepth", fast_riccati=True,
                          use_discrete_innovation_lift=False, use_median_depth=False, initial_scene_depth=2.5)
    inputs = SR.prepare_sim_inputs(settings, capacity=16, max_features=12, end_time=2.0, num_points=200,
                                   dtype=dtype)
    return SR.build_sim_runner(settings, inputs, device=device, **opts)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(consistency=True), dict(augment_true_landmarks=False, compute_nees=False)],
                         ids=["augmented-consistency", "self-init"])
def test_sim_graph_replay_matches_eager_steps(cuda_device, opts):
    """The simulation's frame step captured once and replayed per frame
    equals the same step run eagerly on the card, frame by frame (float64;
    the same kernels in and outside the graph), and the CPU run within 1e-9 m."""
    runner = _sim_runner("cuda", torch.float64, **opts)
    replayed = runner()
    assert runner.step.graph is not None
    runner.reset()
    for _ in range(runner.frames):
        runner.step._body()  # the uncaptured step on the same static buffers
    eager = runner.result()
    for a, b in zip(replayed[:9], eager[:9]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12, equal_nan=True)
    cpu = _sim_runner("cpu", torch.float64, **opts)()
    torch.testing.assert_close(replayed.est_position, cpu.est_position, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_sim_batch_lanes_match_single_on_card(cuda_device):
    """Every lane of a captured batch of 8 lanes of one sequence equals the
    captured single-lane run (float32, 1e-4 m)."""
    single = _sim_runner("cuda", torch.float32, augment_true_landmarks=False, compute_nees=False)()
    batch = _sim_runner("cuda", torch.float32, augment_true_landmarks=False, compute_nees=False, batch=8)()
    assert batch.est_position.shape == (8,) + tuple(single.est_position.shape)
    for lane in batch.est_position:
        torch.testing.assert_close(lane, single.est_position, rtol=0, atol=1e-4)


def _lane_pairs(device, lanes: int):
    """``lanes`` noised copies of a moving frame pair of a small scene, as
    ``[B, H_l, W_l]`` pyramid levels, and 24 features per lane."""
    reader = SyntheticASLReader(end_time=2.0, width=320, height=240, frame_freq=10.0, num_points=300)
    pair = torch.as_tensor(noised_lanes(np.stack([reader.load_image_u8(i) for i in (10, 11)]), lanes)).to(device)
    pair = pair.float() / 255.0
    pyrs = [[torch.stack(lv) for lv in zip(*[build_pyramid(pair[b, k], LEVELS) for b in range(lanes)])]
            for k in range(2)]
    pts = np.random.default_rng(5).uniform([30, 30], [290, 210], (24, 2))
    pos = torch.tensor(pts, dtype=torch.float32, device=device).expand(lanes, 24, 2).contiguous()
    return pyrs[0], pyrs[1], pos


@pytest.mark.cuda
def test_klt_batched_launch_matches_single_lanes_and_plain(cuda_device):
    """One launch for 8 lanes: every lane bitwise its own single-lane
    launch (each block does a single lane's arithmetic), within 2e-4 px of
    the plain version with equal masks; so does the op under vmap."""
    pyr0, pyr1, pos = _lane_pairs(cuda_device, 8)
    before = K.klt_track_pyramid.launches
    out_pos, out_err = K.klt_track_pyramid(pyr0, pyr1, pos, pos + 0.5, WIN, ITERS)
    torch.cuda.synchronize()
    assert K.klt_track_pyramid.launches == before + 1
    for b in range(8):
        one = K.klt_track_pyramid([t[b] for t in pyr0], [t[b] for t in pyr1], pos[b], pos[b] + 0.5, WIN, ITERS)
        assert torch.equal(one[0], out_pos[b]) and torch.equal(one[1], out_err[b]), f"lane {b}"
    pos_p, err_p = K.klt_track_pyramid_plain(pyr0, pyr1, pos, pos + 0.5, WIN, ITERS)
    ok = err_p < 0.08
    assert torch.equal(ok, out_err < 0.08) and int(ok.sum()) >= 8 * 20
    torch.testing.assert_close(out_pos[ok], pos_p[ok], atol=2e-4, rtol=0)
    vm = torch.func.vmap(lambda a, b, p: K.klt_track_pyramid(list(a), list(b), p, p + 0.5, WIN, ITERS))
    v_pos, v_err = vm(tuple(pyr0), tuple(pyr1), pos)
    assert torch.equal(v_pos, out_pos) and torch.equal(v_err, out_err)


@pytest.mark.cuda
def test_klt_one_lane_equals_single_lane_entry(cuda_device):
    """B = 1 through the op, with and without a lane axis, is bitwise the
    single-lane C entry (``klt_track_pyramid_f32``, the earlier releases'
    entry point, kept beside the lanes entry)."""
    import ctypes

    pyr0, pyr1, pos = _lane_pairs(cuda_device, 1)
    p0, p1, q = [t[0].contiguous() for t in pyr0], [t[0].contiguous() for t in pyr1], pos[0].contiguous()
    fn = K.build.load(K._SOURCE).klt_track_pyramid_f32
    fn.argtypes = [K._P, K._P, K._P, K._P, K._I, K._P, K._P, K._P, K._P, K._I, K._I, K._I, K._P]
    out_pos, out_err = torch.empty_like(q), torch.empty(q.shape[0], device=cuda_device)
    u64, i32 = ctypes.c_uint64 * LEVELS, ctypes.c_int * LEVELS
    rc = fn(u64(*[t.data_ptr() for t in p0]), u64(*[t.data_ptr() for t in p1]), i32(*[t.shape[0] for t in p0]),
            i32(*[t.shape[1] for t in p0]), LEVELS, q.data_ptr(), q.data_ptr(), out_pos.data_ptr(),
            out_err.data_ptr(), q.shape[0], WIN, ITERS, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    for got in (K.klt_track_pyramid(p0, p1, q, q, WIN, ITERS), K.klt_track_pyramid(pyr0, pyr1, pos, pos, WIN, ITERS)):
        assert torch.equal(got[0].reshape(-1, 2), out_pos) and torch.equal(got[1].reshape(-1), out_err)


@pytest.mark.cuda
def test_klt_one_lane_equals_parent_kernel(cuda_device, tmp_path):
    """B = 1 through the op is bitwise the kernel of the commit before the
    lanes entry, built from a checkout of it: ``EQVIO_PARENT_CHECKOUT``
    (default ``build/parent``, made with ``git archive <commit> | tar -x -C
    build/parent``); skips without one."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.environ.get("EQVIO_PARENT_CHECKOUT", os.path.join(repo, "build", "parent"))
    if not os.path.isdir(os.path.join(parent, "eqvio_tpu_torch")):
        pytest.skip(f"no parent checkout at {parent}")
    pyr0, pyr1, pos = _lane_pairs(cuda_device, 1)
    p0, p1, q = [t[0].cpu() for t in pyr0], [t[0].cpu() for t in pyr1], pos[0].cpu()
    torch.save({"p0": p0, "p1": p1, "pos": q}, tmp_path / "in.pt")
    code = ("import sys, torch; from eqvio_tpu_torch.kernels import klt as K; d = torch.load(sys.argv[1]); "
            "c = lambda t: t.cuda(); o = K.klt_track_pyramid([c(t) for t in d['p0']], [c(t) for t in d['p1']], "
            f"c(d['pos']), c(d['pos']), {WIN}, {ITERS}); torch.save([t.cpu() for t in o], sys.argv[2])")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "in.pt"), str(tmp_path / "out.pt")], cwd=parent,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = torch.load(tmp_path / "out.pt")
    got = K.klt_track_pyramid(pyr0, pyr1, pos, pos, WIN, ITERS)
    assert torch.equal(got[0][0].cpu(), ref[0]) and torch.equal(got[1][0].cpu(), ref[1])


def _batch_case(device, lanes: int, frames: int = 6):
    reader = SyntheticASLReader(end_time=2.0, width=320, height=240, frame_freq=10.0, num_points=300)
    inp = R.collect_fused_inputs(reader, bench_config(), frames, torch.float32, "cuda")
    imgs = torch.as_tensor(noised_lanes(inp.imgs, lanes)).to(device)
    meta = torch.as_tensor(inp.meta, dtype=torch.float32).to(device)
    args = (inp.tcfg, inp.settings, inp.settings.suite, inp.camera, inp.imu_window, torch.float32)
    batch = R.BatchChunkRunner(*args, *broadcast_lanes((inp.state, inp.tracker), lanes), device)
    return inp, args, imgs, meta, batch


@pytest.mark.cuda
def test_batch_runner_lanes_match_single_sequences(cuda_device):
    """Four lanes with their own noised frames through one captured graph:
    each lane's tracked ids equal its own single-sequence ChunkRunner run,
    positions within 1e-4 m (float32; batched and single products round
    apart); the KLT wrapper counts the eager warm-ups alone."""
    inp, args, imgs, meta, batch = _batch_case(cuda_device, 4)
    before = K.klt_track_pyramid.launches
    outs = batch.run(imgs, meta.expand(4, *meta.shape))
    assert batch.step.graph is not None and K.klt_track_pyramid.launches == before + WARMUP_STEPS
    N = inp.tcfg.max_features
    for b in range(4):
        one = R.ChunkRunner(*args, inp.state, inp.tracker, cuda_device).run(imgs[b], meta)
        assert torch.equal(outs[b, :, 34 + 7 * N:], one[:, 34 + 7 * N:]), f"lane {b} ids or masks"
        torch.testing.assert_close(outs[b, :, 9:12], one[:, 9:12], atol=1e-4, rtol=0)
    assert bool(torch.isfinite(outs).all())


@pytest.mark.cuda
def test_batch_graph_launches_one_klt_per_frame(cuda_device):
    """Under the profiler, each replay of the batched graph runs one
    ``klt_pyramid_kernel`` and one ``ransac_gate_kernel`` for all lanes."""
    from torch.profiler import ProfilerActivity, profile

    _, _, imgs, meta, batch = _batch_case(cuda_device, 8)
    meta_b = meta.expand(8, *meta.shape)
    batch.run(imgs[:, :2], meta_b[:, :2])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batch.run(imgs[:, 2:6], meta_b[:, 2:6])
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    launches = [ev.name for ev in prof.events() if ev.name == "cudaGraphLaunch"]
    assert len(launches) == 4
    assert sum("klt_pyramid_kernel" in n for n in names) == 4
    assert sum("ransac_gate_kernel" in n for n in names) == 4


@pytest.mark.cuda
def test_stamp_kernel_and_clock_offset(cuda_device):
    """Two stamps on the card run in order, and the offset from the card's
    timer to the host clock is bracketed to within a millisecond, twice
    alike."""
    from eqvio_tpu_torch import stamps as S
    from eqvio_tpu_torch.kernels import stamp as KS

    row = torch.zeros(len(S.STAMPS), dtype=torch.int64, device=cuda_device)
    KS.frame_stamp(row, 0)
    KS.frame_stamp(row, 1)
    torch.cuda.synchronize()
    assert 0 < int(row[0]) <= int(row[1])
    (o1, w1), (o2, w2) = KS.clock_offset(cuda_device), KS.clock_offset(cuda_device)
    print(f"clock offset {o1} ns, bracket {w1} ns; again {o2 - o1:+d} ns, {w2} ns")
    assert 0 < max(w1, w2) < 1_000_000 and abs(o2 - o1) < max(w1, w2)


def _replay_events(monkeypatch) -> list:
    """Every graph replay from here on between two CUDA timing events on its
    stream: ``[(before, after)]``, in replay order."""
    events = []
    replay = torch.cuda.CUDAGraph.replay

    def timed(self):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        replay(self)
        b.record()
        events.append((a, b))

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", timed)
    return events


def _traced_pass_against_profiler(reader, events: list) -> dict:
    """One short traced pass under the profiler, its graph replays between
    CUDA events: the worst disagreement of its stamps with the profiler's
    stamp kernels within a frame (aligned at the frame's begin) and of its
    end stamps with the events after the replays (each against the first
    frame's), and what else the stamps must satisfy."""
    from benchmark import tracing
    from eqvio_tpu_torch import stamps as S

    got = {}
    events.clear()
    rec = tracing.capture(lambda: got.update(s=R.run_dataset(reader, bench_config(), device="cuda", chunk_size=8,
                                                             limit_frames=24, trace=True)[1]))
    tb = got["s"]["trace"]
    col = {f: i for i, f in enumerate(tb["frame_fields"])}
    launches = sorted((r for r in rec["host"] if r[1] == tracing.GRAPH_LAUNCH), key=lambda r: r[2])
    assert len(tb["frames"]) == 24 and len(launches) >= 24 and len(events) >= 24
    # the frames' replays follow the set-up's; the event after a replay runs
    # after its graph's last node (the carry's copy-back after the end
    # stamp), while the one before it can run early by the launch's latency
    ev0 = events[-24][1]
    ev_ns = np.asarray([[ev0.elapsed_time(a) * 1e6, ev0.elapsed_time(b) * 1e6] for a, b in events[-24:]])
    by_corr: dict = {}
    for r in rec["device"]:
        if r[0] == "kernel":
            by_corr.setdefault(r[4], []).append((r[2], r[3], r[1]))
    out = {"worst": 0, "counts": set(), "offset": [], "after_launch": [], "before_in_hand": [], "copy_back": []}
    for row, launch in zip(tb["frames"], launches[-24:]):
        kernels = sorted(by_corr.get(launch[4], []))
        out["counts"].add(len(kernels))
        ker = np.asarray([k[0] for k in kernels if "frame_stamp" in k[2]])
        assert len(ker) == len(S.STAMPS) and "frame_stamp" in kernels[0][2], [k[2] for k in kernels[:2]]
        dev = np.asarray(row[col["frame_begin"]:col["frame_end"] + 1])
        out["worst"] = max(out["worst"], int(np.abs((dev - dev[0]) - (ker - ker[0])).max()))
        out["offset"].append(int(ker[0] - dev[0]))
        out["after_launch"].append(int(dev[0]) - launch[2])
        out["before_in_hand"].append(row[col["in_hand_ns"]] - int(dev[-1]))
        out["copy_back"].append(max(k[1] for k in kernels) - int(ker[-1]))
    st = np.asarray([[r[col["frame_begin"]], r[col["frame_end"]]] for r in tb["frames"]], dtype=np.int64)
    st = (st - st[0, 1]).astype(np.float64)
    out["events_worst"] = float(np.abs(st[:, 1] - ev_ns[:, 1]).max())
    slack = (ev_ns[:, 1] - ev_ns[:, 0]) - (st[:, 1] - st[:, 0])  # the events' span less the stamps'
    out["events_span"], out["events_slack_max"] = float(slack.min()), float(slack.max())
    # the profiler's host records are on the tracer's clock: each of the
    # pass's host-only spans is the profiler's record of the same name
    spans = [sp for sp in tb["spans"] if sp[0] in R.HOST_SPANS and sp[7] == "main"]
    starts = sorted(r[2] for r in rec["host"] if r[1].startswith("eqvio."))
    out["host_ns_apart"] = float(np.median([min(abs(sp[1] - t) for t in starts[max(0, i - 2):i + 2])
                                            for sp in spans for i in [int(np.searchsorted(starts, sp[1]))]]))
    out["clock"] = tb["clock"]
    print(f"stamps against the profiler: worst {out['worst']} ns over {sorted(out['counts'])} kernels a launch; "
          f"end stamps against the CUDA events after the replays: worst {out['events_worst']:.0f} ns; event span "
          f"less stamp span {out['events_span']:.0f} to {out['events_slack_max']:.0f} ns; the profiler's begin stamp kernel less the frame's begin stamp "
          f"{min(out['offset'])} to {max(out['offset'])} ns; begin after the launch call {min(out['after_launch'])} "
          f"ns, in hand after the end {min(out['before_in_hand'])} ns; host spans {out['host_ns_apart']:.0f} ns "
          f"from the profiler's records; clock {tb['clock']}")
    return out


@pytest.mark.cuda
def test_stamps_match_the_profiler(cuda_device, monkeypatch):
    """A short traced pass's stamps against two witnesses of the same graph
    launches.  CUDA timing events around every replay, on the card's event
    clock: in every pass and every frame, the end stamp, against the first
    frame's, lies within 50 us of the event after the replay, against the
    first frame's, and no frame's stamps span more than its events (the
    event before a replay runs as soon as the stream is free, which can be
    before the launch reaches the card).  The
    profiler's records (the kernels carrying each launch's correlation id):
    the launch's first kernel is its begin stamp, and each stamp lies within
    50 us of the start of its stamp kernel once the two are aligned at the
    frame's begin; the carry's copy-back follows the end stamp.  On the host
    clock, by the pass's own offset, each frame begins after its launch call
    and ends before its row is in hand, and the profiler stamps its host
    records with the tracer's clock.  The profiler's device timeline moves
    against both the stamps and the events within some passes (PERF.md), so
    up to three passes are traced and one must match the profiler on every
    frame; every pass must hold the rest."""
    reader = SyntheticASLReader(end_time=4.0, width=320, height=240, frame_freq=10.0, num_points=300)
    R.run_dataset(reader, bench_config(), device="cuda", chunk_size=8, limit_frames=8, trace=True)  # builds
    events = _replay_events(monkeypatch)
    worst = []
    for _ in range(3):
        got = _traced_pass_against_profiler(reader, events)
        assert got["events_worst"] < 50_000 and got["events_span"] > -2_000, got["events_worst"]
        assert len(got["counts"]) == 1 and min(got["copy_back"]) >= 0
        assert min(got["after_launch"]) > 0 and min(got["before_in_hand"]) > 0 and got["host_ns_apart"] < 20_000
        worst.append(got["worst"])
        if got["worst"] < 50_000:
            break
    assert min(worst) < 50_000, worst
