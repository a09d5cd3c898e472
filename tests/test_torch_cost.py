"""The port's operation and byte counter (``eqvio_tpu_torch.cost``), the
counterpart of XLA's cost analysis, on the CPU.

- Hand counts: a matrix product (``2 m n k`` operations, every operand's
  bytes once), an elementwise chain (one per output element), a reduction
  (one per input element), a broadcast operand counted once, a view none,
  the QR by its textbook count, the KLT op by ``klt_work`` and the RANSAC
  gate's op by ``ransac_work``, which equals the plain gate's count.
- The B-lane fused frame step counts B times one lane's operations within 1%.
- The fused summary carries ``flops_per_frame``, ``hbm_bytes_per_frame``,
  ``achieved_gflops`` and ``achieved_hbm_gbps``; the simulation runner has
  ``cost_analysis()``, and its B-lane count is B times one lane's within 1%.
- ``test_ratio_to_xla_cost_analysis`` prints the ratio of the port's count
  of one fused frame step to XLA's ``cost_analysis`` of the JAX package's
  same step on the same inputs (``-s`` shows it); the two decompose the
  step into different ops, so the ratio is recorded, not held to a bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqvio_tpu.app.run_opt as jax_run_opt
import eqvio_tpu_torch.app.run_opt as torch_run_opt
from eqvio_tpu_torch import cost
from eqvio_tpu_torch import filter as TF
from eqvio_tpu_torch import runner as SR
from eqvio_tpu_torch.data import SyntheticASLReader
from eqvio_tpu_torch.frontend import prng
from eqvio_tpu_torch.frontend import ransac as plain_ransac
from eqvio_tpu_torch.graph import broadcast_lanes
from eqvio_tpu_torch.io import bench_config
from eqvio_tpu_torch.kernels import klt as K
from eqvio_tpu_torch.kernels import ransac as RK
from eqvio_tpu_torch.kernels.ransac_bench import two_view
from tests.test_torch_run_opt import one_torch_thread  # noqa: F401 (autouse fixture)

F64 = torch.float64
CPU = torch.device("cpu")


def test_matmul_count():
    a, b = torch.ones(5, 7, dtype=F64), torch.ones(7, 3, dtype=F64)
    c = cost.count(lambda: a @ b)
    assert c["flops"] == 2 * 5 * 7 * 3
    assert c["bytes accessed"] == (5 * 7 + 7 * 3 + 5 * 3) * 8
    assert cost.count(lambda: torch.ones(4, 5, 7) @ torch.ones(4, 7, 3))["flops"] >= 4 * 2 * 5 * 7 * 3


def test_elementwise_reduction_broadcast_and_view_counts():
    x = torch.ones(100)
    c = cost.count(lambda: ((x * 2 + 1).exp()).sum())
    assert c["flops"] == 3 * 100 + 100  # three elementwise ops, one sum over 100 inputs
    row = torch.ones(1, 50)
    c = cost.count(lambda: torch.ones(40, 50) + row.expand(40, 50))
    # expand is a view (no bytes); its 40 x 50 operand holds 50 values in memory
    assert c["flops"] == 40 * 50  # the add (a fill is no operation)
    assert c["bytes accessed"] == 4 * (40 * 50 + (40 * 50 + 50 + 40 * 50))
    assert cost.count(lambda: x.reshape(10, 10).T)["bytes accessed"] == 0


def test_qr_and_cholesky_textbook_counts():
    m, n = 12, 5
    a = torch.randn(3, m, n, dtype=F64)
    assert cost.count(lambda: torch.linalg.qr(a, mode="r"))["flops"] == pytest.approx(3 * 2 * n * n * (m - n / 3))
    spd = a.transpose(-1, -2) @ a + torch.eye(n, dtype=F64)
    assert cost.count(lambda: torch.linalg.cholesky_ex(spd))["flops"] == pytest.approx(3 * n**3 / 3)


def test_klt_op_counts_klt_work():
    rng = np.random.default_rng(0)
    shapes = [(48, 64), (24, 32)]
    pyr = [torch.tensor(rng.uniform(0, 1, (3, h, w)).astype(np.float32)) for h, w in shapes]
    pos = torch.tensor(rng.uniform(12, 36, (3, 5, 2)).astype(np.float32))
    c = cost.count(lambda: K.klt_track_pyramid(pyr, pyr, pos, pos, 9, 4))
    assert c["flops"] == K.klt_work(5, shapes, 9, 4, lanes=3)[1] == 3 * K.klt_work(5, shapes, 9, 4)[1]
    assert c["ops"] == 1  # one op: its plain arithmetic inside is not counted again
    vm = cost.count(lambda: torch.func.vmap(lambda a, b, p: K.klt_track_pyramid([a, b], [a, b], p, p, 9, 4))(
        *pyr, pos))
    assert vm["flops"] == c["flops"]


@pytest.mark.parametrize("hypotheses,n", [(20, 40), (34, 40), (64, 30), (16, 8), (5, 100)])
def test_ransac_op_counts_ransac_work(hypotheses, n):
    """``ransac_work`` is what the plain gate (``fold_in`` and
    ``frontend.ransac``'s function) counts op by op, operations and bytes;
    the op counts as one op of its operations, and under vmap as many times
    as it has lanes."""
    prev, curr, mask = (torch.tensor(a) for a in two_view(0, n=n))
    key, nid = prng.prng_key(7, "cpu"), torch.tensor(17)
    ref = cost.count(lambda: plain_ransac.ransac_epipolar_mask(prev, curr, mask, prng.fold_in(key, nid), 0.9,
                                                               hypotheses, 8, 8))
    assert RK.ransac_work(hypotheses, n) == (ref["bytes accessed"], ref["flops"])
    op = cost.count(lambda: RK.ransac_mask(prev, curr, mask, key, nid, 0.9, hypotheses))
    assert op["flops"] == ref["flops"] and op["ops"] == 1
    gate = lambda p, c, m, i: RK.ransac_mask(p, c, m, key, i, 0.9, hypotheses)  # noqa: E731
    batch = [t.expand(3, *t.shape).contiguous() for t in (prev, curr, mask, nid)]
    lanes = cost.count(lambda: torch.func.vmap(gate)(*batch))
    assert lanes["flops"] == 3 * ref["flops"] and RK.ransac_work(hypotheses, n, 3)[1] == lanes["flops"]


@pytest.fixture(scope="module")
def small_inputs():
    reader = SyntheticASLReader(end_time=1.6, width=160, height=120, frame_freq=10.0, num_points=150)
    return torch_run_opt.collect_fused_inputs(reader, bench_config(), 4, F64, "cpu")


def _runner(inp, lanes=None):
    carry = (inp.state, inp.tracker) if lanes is None else broadcast_lanes((inp.state, inp.tracker), lanes)
    cls = torch_run_opt.ChunkRunner if lanes is None else torch_run_opt.BatchChunkRunner
    r = cls(inp.tcfg, inp.settings, inp.settings.suite, inp.camera, inp.imu_window, F64, *carry, CPU)
    imgs, meta = torch.as_tensor(inp.imgs[:2]), torch.as_tensor(inp.meta[:2])
    if lanes is None:
        r.run(imgs, meta)
    else:
        r.run(imgs.expand(lanes, *imgs.shape), meta.expand(lanes, *meta.shape))
    return r


@pytest.mark.parametrize("lanes", [2, 3])
def test_batched_fused_step_counts_lanes_times_one(small_inputs, lanes):
    one = _runner(small_inputs).step.cost_analysis()
    many = _runner(small_inputs, lanes).step.cost_analysis()
    assert one["flops"] > 1e6 and one["bytes accessed"] > 1e6
    assert many["flops"] == pytest.approx(lanes * one["flops"], rel=0.01)


def test_cost_analysis_leaves_the_carry(small_inputs):
    r = _runner(small_inputs)
    before = [t.clone() for t in r.step.carry]
    r.step.cost_analysis()
    assert all(torch.equal(a, b) for a, b in zip(before, r.step.carry))


def test_fused_summary_has_flops_and_bytes():
    reader = SyntheticASLReader(end_time=1.6, width=160, height=120, frame_freq=10.0, num_points=150)
    _, s = torch_run_opt.run_dataset(reader, bench_config(), device="cpu", chunk_size=4, limit_frames=8)
    assert s["flops_per_frame"] > 1e6 and s["hbm_bytes_per_frame"] > 1e6
    assert s["achieved_gflops"] == pytest.approx(s["flops_per_frame"] / (s["device_ms_per_frame"] * 1e6), rel=1e-2)
    assert s["achieved_hbm_gbps"] == pytest.approx(s["hbm_bytes_per_frame"] / (s["device_ms_per_frame"] * 1e6),
                                                   rel=1e-2)


def test_sim_runner_cost_analysis():
    settings = TF.Settings(measurement_noise=0.5)
    inputs = SR.prepare_sim_inputs(settings, capacity=8, max_features=6, end_time=1.0, num_walls=4, num_points=200)
    one = SR.build_sim_runner(settings, inputs, device="cpu")
    many = SR.build_sim_runner(settings, inputs, batch=3, device="cpu")
    c1, c3 = one.cost_analysis(), many.cost_analysis()
    assert c1["frames"] == one.frames and c1["flops"] == pytest.approx(c1["flops_per_frame"] * one.frames)
    assert c1["flops_per_frame"] > 0 and c1["bytes_per_frame"] > 0
    assert c3["flops"] == pytest.approx(3 * c1["flops"], rel=0.01)
    res = one()  # the count did not disturb a run
    assert np.isfinite(res.est_position.numpy()).all()


def test_ratio_to_xla_cost_analysis(tmp_path, capsys):
    """One fused frame step, the port's count against XLA's cost analysis
    of the JAX package's frame step (``_make_frame_fn``) on the same
    float64 carry and inputs; printed, not gated."""
    from eqvio_tpu.data import generate_asl_dataset

    generate_asl_dataset(str(tmp_path), end_time=1.6, width=160, height=120, frame_freq=10.0, num_points=150)
    imgs, meta, state_j, tracker_j, settings_j, tcfg_j, camera_j, suite_j, K_j = jax_run_opt.collect_fused_inputs(
        str(tmp_path), bench_config(), 4, dtype=jnp.float64)
    inp = torch_run_opt.collect_fused_inputs(str(tmp_path), bench_config(), 4, F64, "cpu")
    port = _runner(inp).step.cost_analysis()
    frame_fn = jax_run_opt._make_frame_fn(tcfg_j, settings_j, suite_j, camera_j, K_j, jnp.float64)
    xs = (jnp.asarray(imgs[1], jnp.float32) / 255.0, jnp.asarray(meta[1]))
    ca = jax.jit(frame_fn).lower((state_j, tracker_j), xs).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    flops_ratio = port["flops"] / ca["flops"]
    bytes_ratio = port["bytes accessed"] / ca["bytes accessed"]
    with capsys.disabled():
        print(f"\nport/XLA per frame step (160x120, N=30, float64, CPU): flops {port['flops']:.6g} / "
              f"{ca['flops']:.6g} = {flops_ratio:.4f}; bytes {port['bytes accessed']:.6g} / "
              f"{ca['bytes accessed']:.6g} = {bytes_ratio:.4f}")
    assert np.isfinite(flops_ratio) and np.isfinite(bytes_ratio) and flops_ratio > 0 and bytes_ratio > 0
