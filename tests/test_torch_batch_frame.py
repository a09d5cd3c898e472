"""The port's tracker-inclusive sequence batch against ``eqvio_tpu``'s, on the
CPU.

- The KLT op under ``torch.func.vmap`` over 3 lanes (and nested, and with a
  pyramid shared by the lanes) equals 3 single calls exactly (plain path).
- ``tracker_step`` vmapped over 2 lanes with different images equals two
  single-lane steps: ids and masks exactly, positions to 1e-6 px.
- ``BatchChunkRunner`` in float64, 2 lanes of the scene of
  ``tests/test_torch_fused.py`` (320x240, 12 frames, chunk 8, so the second
  chunk is padded), each lane with its own ``integers(-3, 4)`` pixel noise,
  equals ``eqvio_tpu.app.run_opt._make_batch_chunk_runner`` on the same
  inputs from the same carry (``convert`` of the JAX package's batched
  state and tracker): positions to 1e-6 m, tracked ids exactly, pixels to
  1e-3 px, the tolerances of the fused parity test.
- The batched frame step passes the host-sync guard of
  ``tests/test_torch_fused.py``.
- ``collect_fused_inputs`` gives the JAX package's uint8 frames and meta rows.

Every vmapped run here has functorch's per-lane fallback turned into an
error, so an op without a batching rule fails instead of looping over lanes.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqvio_tpu.app.run_opt as jax_run_opt
import eqvio_tpu_torch.app.run_opt as torch_run_opt
from eqvio_tpu.data import generate_asl_dataset
from eqvio_tpu_torch import convert
from eqvio_tpu_torch.data import SyntheticASLReader, noised_lanes
from eqvio_tpu_torch.frontend import tracker as T
from eqvio_tpu_torch.graph import broadcast_lanes
from eqvio_tpu_torch.io import bench_config, tracker_config_from_config
from eqvio_tpu_torch.kernels import klt as K
from tests.test_torch_fused import SCENE, no_host_sync_or_host_data
from tests.test_torch_run_opt import one_torch_thread  # noqa: F401 (autouse fixture)

F64 = torch.float64
FRAMES, CHUNK, LANES = 12, 8, 2
CPU = torch.device("cpu")


@contextlib.contextmanager
def no_vmap_fallback():
    """Turn functorch's per-lane fallback (an op without a batching rule run
    once per lane) into an error."""
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)


def test_vmap_fallback_is_an_error():
    """The guard bites: an op without a batching rule (``histc``) runs
    through the fallback, and raises under the guard."""
    x = torch.arange(6.0).reshape(2, 3)
    hist = lambda v: torch.histc(v, 4)  # noqa: E731
    with pytest.warns(UserWarning, match="batching rule"):
        torch.func.vmap(hist)(x)
    with no_vmap_fallback(), pytest.raises(RuntimeError, match="fallback"):
        torch.func.vmap(hist)(x)


def _klt_lanes(lanes: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shapes = [(48, 64), (24, 32), (12, 16)]
    pyr = [[torch.tensor(rng.uniform(0, 1, (lanes, h, w)).astype(np.float32)) for h, w in shapes] for _ in range(2)]
    pos = torch.tensor(rng.uniform(12, 36, (lanes, 6, 2)).astype(np.float32))
    return pyr[0], pyr[1], pos, pos + torch.tensor(rng.uniform(-0.5, 0.5, (lanes, 6, 2)).astype(np.float32))


def test_klt_op_under_vmap_equals_single_calls():
    """Exactly equal: the op's vmap rule stacks the lanes and its CPU
    implementation (the plain version) does every lane's arithmetic as a
    single call does; nested vmap and a pyramid shared by the lanes too."""
    p0, p1, pos, guess = _klt_lanes(3)
    single = [K.klt_track_pyramid([t[b] for t in p0], [t[b] for t in p1], pos[b], guess[b], 9, 4) for b in range(3)]

    def track(a0, a1, a2, b0, b1, b2, p, g):
        return K.klt_track_pyramid([a0, a1, a2], [b0, b1, b2], p, g, 9, 4)

    before = K.klt_track_pyramid.launches
    with no_vmap_fallback():
        out = torch.func.vmap(track)(*p0, *p1, pos, guess)
        nested = torch.func.vmap(torch.func.vmap(track))(*[t.expand(2, *t.shape) for t in (*p0, *p1, pos, guess)])
        shared = torch.func.vmap(track, in_dims=(None,) * 3 + (0,) * 5)(*[t[0] for t in p0], *p1, pos, guess)
    assert K.klt_track_pyramid.launches == before  # the plain path launches nothing
    for b in range(3):
        assert torch.equal(out[0][b], single[b][0]) and torch.equal(out[1][b], single[b][1])
        for k in range(2):
            assert torch.equal(nested[0][k, b], single[b][0]) and torch.equal(nested[1][k, b], single[b][1])
        ref = K.klt_track_pyramid([t[0] for t in p0], [t[b] for t in p1], pos[b], guess[b], 9, 4)
        assert torch.equal(shared[0][b], ref[0]) and torch.equal(shared[1][b], ref[1])


def test_klt_op_takes_lane_dims_directly():
    """Leading lane dims without vmap: the same numbers as single calls."""
    p0, p1, pos, guess = _klt_lanes(2, seed=1)
    out = K.klt_track_pyramid(p0, p1, pos, guess, 9, 4)
    for b in range(2):
        ref = K.klt_track_pyramid([t[b] for t in p0], [t[b] for t in p1], pos[b], guess[b], 9, 4)
        assert torch.equal(out[0][b], ref[0]) and torch.equal(out[1][b], ref[1])


def test_lane_strides_of_the_batched_launch():
    """The batched launch's per-level lane stride: H*W for stacked lanes, 0
    for a pyramid every lane shares, and a copy where nested lane dims do
    not flatten to one stride; the checks still refuse what the kernel does
    not take (the CUDA entry's checks, run here on CPU tensors)."""
    p0, p1, pos, _ = _klt_lanes(3)
    h, w = p0[0].shape[-2:]
    assert K._lane_stride(p0[0], (3,)) == h * w
    assert K._lane_stride(p0[0][0].expand(3, h, w), (3,)) == 0
    assert K._lane_stride(p0[0][:1], (1,)) == 0
    nested = p0[0].expand(2, 3, h, w)  # strides (0, h*w, w, 1): no single lane stride
    assert K._lane_stride(nested, (2, 3)) is None
    assert K._lane_stride(p0[0].expand(2, 3, h, w).contiguous(), (2, 3)) == h * w
    lanes, key, copies = K._check_cuda_inputs(p0, p1, pos, pos)
    assert lanes == 3 and key[2::6] == tuple(t.shape[-1] * t.shape[-2] for t in p0) and not copies
    lanes, key, copies = K._check_cuda_inputs([t[0].expand(3, *t.shape[1:]) for t in p0], p1, pos, pos)
    assert key[2::6] == (0, 0, 0) and key[3::6] == tuple(t.shape[-1] * t.shape[-2] for t in p1) and not copies
    lanes, key, copies = K._check_cuda_inputs([t.expand(2, *t.shape) for t in p0], [t.expand(2, *t.shape) for t in p1],
                                              pos.expand(2, *pos.shape).contiguous(),
                                              pos.expand(2, *pos.shape).contiguous())
    # the nested lanes copy every level, and the key points at the copies the caller keeps
    assert lanes == 6 and len(copies) == 6 and key[0::6] == tuple(c.data_ptr() for c in copies[0::2])
    for bad in (lambda: K._check_cuda_inputs(p0, p1, pos[0], pos[0]),  # lanes differ
                lambda: K._check_cuda_inputs([t.double() for t in p0], p1, pos, pos),
                lambda: K._check_cuda_inputs([t.transpose(-1, -2) for t in p0], p1, pos, pos)):
        with pytest.raises(ValueError):
            bad()


def _lane_frames(reader, frames: int, lanes: int, seed: int = 3):
    imgs = np.stack([reader.load_image_u8(i) for i in range(frames)])
    return noised_lanes(imgs, lanes, seed)


def test_tracker_step_under_vmap_equals_single_lanes():
    """Two lanes with their own noised frames, bench tracker config (RANSAC
    gate, device-gated detection) and with equalisation and the median-flow
    gate: ids and masks exactly, positions to 1e-6 px."""
    reader = SyntheticASLReader(end_time=1.0, width=320, height=240, frame_freq=10.0, num_points=300)
    base = tracker_config_from_config(bench_config())
    lanes = torch.as_tensor(_lane_frames(reader, 4, 2)).float() / 255.0
    for cfg in (base, T.TrackerConfig(**{**base.__dict__, "equalize_histogram": True,
                                         "flow_outlier_threshold": 3.0, "feature_search_threshold": 0.7})):
        one = T.tracker_init(cfg, (240, 320), CPU)
        batched, singles = broadcast_lanes(one, 2), [one, one]
        step = torch.func.vmap(lambda s, im, cfg=cfg: T.tracker_step(s, im, cfg))
        for k in range(4):
            with no_vmap_fallback():
                batched = step(batched, lanes[:, k])
            singles = [T.tracker_step(s, lanes[b, k], cfg) for b, s in enumerate(singles)]
            for b in range(2):
                assert torch.equal(batched.ids[b], singles[b].ids) and torch.equal(batched.mask[b], singles[b].mask)
                assert int(batched.next_id[b]) == int(singles[b].next_id)
                torch.testing.assert_close(batched.positions[b], singles[b].positions, atol=1e-6, rtol=0)
        assert not torch.equal(batched.positions[0], batched.positions[1])  # the lanes saw different frames


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    base = tmp_path_factory.mktemp("batch")
    generate_asl_dataset(str(base / "asl"), **SCENE)
    return str(base / "asl")


@pytest.fixture(scope="module")
def collected(scene):
    """``(JAX collect_fused_inputs, port collect_fused_inputs)`` of the scene's
    first FRAMES frames, float64."""
    return (jax_run_opt.collect_fused_inputs(scene, bench_config(), FRAMES, dtype=jnp.float64),
            torch_run_opt.collect_fused_inputs(scene, bench_config(), FRAMES, F64, "cpu"))


def test_collect_fused_inputs_matches_jax(collected):
    (imgs_j, meta_j, state_j, tracker_j, *_, K_j), inp = collected
    assert inp.imu_window == K_j
    np.testing.assert_array_equal(inp.imgs, imgs_j)
    assert inp.imgs.dtype == np.uint8
    np.testing.assert_array_equal(inp.meta, meta_j)
    np.testing.assert_allclose(inp.state.X.A.R.numpy(), np.asarray(state_j.X.A.R), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(inp.tracker.ids.numpy(), np.asarray(tracker_j.ids))


def test_noised_lanes_draw_as_jax():
    """Lane b's frames carry the b-th draw of one generator, as in the JAX
    package's ``bench_batch_full_frame``: the lanes differ, and each is the
    frames plus its draw, clipped."""
    imgs = np.random.default_rng(0).integers(0, 256, (3, 5, 4), dtype=np.uint8)
    lanes = noised_lanes(imgs, 2, noise_seed=7)
    rng = np.random.default_rng(7)
    for b in range(2):
        noise = rng.integers(-3, 4, imgs.shape, dtype=np.int16)
        np.testing.assert_array_equal(lanes[b], np.clip(imgs.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    assert not np.array_equal(lanes[0], lanes[1])


def _padded_chunks(imgs_b: np.ndarray, meta: np.ndarray):
    """``[B, T, ...]`` frames and ``[T, 8K+2]`` meta cut into chunks of
    CHUNK, the last padded with zero frames (``valid = 0``)."""
    T = imgs_b.shape[1]
    n = -(-T // CHUNK) * CHUNK
    imgs = np.zeros(imgs_b.shape[:1] + (n,) + imgs_b.shape[2:], np.uint8)
    imgs[:, :T] = imgs_b
    rows = np.zeros((imgs_b.shape[0], n, meta.shape[1]))
    rows[:, :T] = meta
    return [(imgs[:, c:c + CHUNK], rows[:, c:c + CHUNK]) for c in range(0, n, CHUNK)]


@pytest.fixture(scope="module")
def batch_runs(collected):
    """The JAX batched chunk program and the port's BatchChunkRunner over
    the same noised lanes from the same carry: ``(JAX outputs, port
    outputs, port runner)``, outputs ``[B, T, 34 + 9N]``."""
    (imgs_j, meta_j, state_j, tracker_j, settings_j, tcfg_j, camera_j, suite_j, K_j), inp = collected
    chunks = _padded_chunks(noised_lanes(inp.imgs, LANES, 5), inp.meta)
    lanes_j = lambda a: jnp.broadcast_to(jnp.asarray(a)[None], (LANES,) + a.shape).copy()  # noqa: E731
    state_b, tracker_b = jax.tree.map(lanes_j, state_j), jax.tree.map(lanes_j, tracker_j)
    run_b = jax_run_opt._make_batch_chunk_runner(tcfg_j, settings_j, suite_j, camera_j, K_j, jnp.float64)
    # the port starts from the JAX package's batched carry, lane axis and all
    runner = torch_run_opt.BatchChunkRunner(
        inp.tcfg, inp.settings, inp.settings.suite, inp.camera, inp.imu_window, F64,
        convert.eqf_state_from_numpy(jax.device_get(state_b), F64, CPU),
        convert.tracker_state_from_numpy(jax.device_get(tracker_b), CPU), CPU)
    outs_j, outs_t = [], []
    for imgs, meta in chunks:
        (state_b, tracker_b), o = run_b(state_b, tracker_b, jnp.asarray(imgs), jnp.asarray(meta))
        outs_j.append(np.asarray(o))
        with no_vmap_fallback():
            outs_t.append(runner.run(torch.as_tensor(imgs), torch.as_tensor(meta)).numpy())
    return np.concatenate(outs_j, 1)[:, :FRAMES], np.concatenate(outs_t, 1), runner, chunks


def test_batch_chunk_runner_matches_jax_batch(batch_runs):
    outs_j, outs_t, runner, _ = batch_runs
    N = (runner.out_width - 34) // 9
    assert outs_t.shape == (LANES, -(-FRAMES // CHUNK) * CHUNK, runner.out_width)
    for b in range(LANES):
        for k in range(FRAMES):
            u_j = jax_run_opt._unpack_outputs(outs_j[b, k], N)
            u_t = torch_run_opt._unpack_outputs(outs_t[b, k], N)
            np.testing.assert_allclose(u_t[1], u_j[1], atol=1e-6, rtol=0, err_msg=f"lane {b} frame {k} position")
            fpx_j, fids_j, fvis_j = u_j[-3:]
            fpx_t, fids_t, fvis_t = u_t[-3:]
            np.testing.assert_array_equal(fvis_t, fvis_j, err_msg=f"lane {b} frame {k} tracked mask")
            np.testing.assert_array_equal(fids_t[fvis_t], fids_j[fvis_j], err_msg=f"lane {b} frame {k} ids")
            np.testing.assert_allclose(fpx_t[fvis_t], fpx_j[fvis_j], atol=1e-3, rtol=0)
        assert int(u_t[-1].sum()) >= 10
    assert np.abs(outs_t[0, :FRAMES, 9:12] - outs_t[1, :FRAMES, 9:12]).max() > 1e-6  # the lanes differ
    # padded frames repeat the carry's estimate
    np.testing.assert_array_equal(outs_t[:, FRAMES:, :33], np.repeat(outs_t[:, FRAMES - 1:FRAMES, :33], 4, 1))


def test_batch_lanes_equal_single_sequence_runs(batch_runs, collected):
    """Each lane equals the one-sequence ChunkRunner on its own frames: the
    same tracked ids, positions to 1e-9 m and pixels to 1e-6 px (batched
    products and QR sum in another order: float64 round-off only)."""
    _, outs_t, runner, chunks = batch_runs
    inp = collected[1]
    N = (runner.out_width - 34) // 9
    for b in range(LANES):
        one = torch_run_opt.ChunkRunner(inp.tcfg, inp.settings, inp.settings.suite, inp.camera, inp.imu_window, F64,
                                        inp.state, inp.tracker, CPU)
        o = np.concatenate([one.run(torch.as_tensor(i[b]), torch.as_tensor(m[b])).numpy() for i, m in chunks])
        for k in range(FRAMES):
            u_b, u_1 = torch_run_opt._unpack_outputs(outs_t[b, k], N), torch_run_opt._unpack_outputs(o[k], N)
            np.testing.assert_allclose(u_b[1], u_1[1], atol=1e-9, rtol=0, err_msg=f"lane {b} frame {k} position")
            np.testing.assert_array_equal(u_b[-1], u_1[-1])
            np.testing.assert_array_equal(u_b[-2], u_1[-2])
            np.testing.assert_allclose(u_b[-3], u_1[-3], atol=1e-6, rtol=0)


def test_batch_frame_step_has_no_host_sync(batch_runs):
    """The batched step, padded lanes included, runs under the guard."""
    _, _, runner, chunks = batch_runs
    imgs, meta = (torch.as_tensor(a) for a in chunks[-1])
    with no_host_sync_or_host_data(), no_vmap_fallback():
        outs = runner.run(imgs[:, 2:6], meta[:, 2:6])  # two real frames, two padded
    assert torch.isfinite(outs).all()


def test_bench_batch_full_frame_on_cpu():
    """The throughput run's keys and health on a tiny cut (CPU clock)."""
    reader = SyntheticASLReader(end_time=1.6, width=160, height=120, frame_freq=10.0, num_points=150)
    res = torch_run_opt.bench_batch_full_frame(reader, bench_config(), 2, dtype=torch.float32, limit_frames=9,
                                               chunk_size=4, reps=1, device="cpu")
    assert set(res) == {"full_frame_batch_fps", "full_frame_batch_per_seq_fps", "full_frame_batch_B",
                        "full_frame_batch_frames", "full_frame_batch_finite", "full_frame_batch_gflops_per_s"}
    assert res["full_frame_batch_B"] == 2 and res["full_frame_batch_frames"] == 8 and res["full_frame_batch_finite"]
    assert res["full_frame_batch_fps"] == pytest.approx(2 * res["full_frame_batch_per_seq_fps"])
    assert res["full_frame_batch_gflops_per_s"] > 0
