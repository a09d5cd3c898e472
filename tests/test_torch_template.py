"""EqVIO's default filter (``configs/config_template.yaml``: Euclidean
landmarks, a matrix-exponential Riccati step per IMU sample, discrete
lifts) in the port.

- ``propagate_window`` over a padded window, square root and dense, held to
  the plain reference of ``benchmark/plain_riccati.py`` (live samples only,
  ``torch.linalg.matrix_exp``, dense float64): to 1e-9 in float64, and in
  float32 to a tolerance that the same window with its matmul inputs
  rounded to bfloat16 (coarser than TF32) does not meet.
- The fused path's counters: Riccati steps and live IMU samples counted on
  the host from the packed windows, the steps as many as
  ``propagate_window`` runs; the frame step's ops are those of the bare
  step (and, stamped, the stamps).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import plain_riccati
from benchmark.convert import to_frozen
from benchmark.frozen.matrices import get_suite as frozen_suite
from eqvio_tpu_torch import filter as TF
from eqvio_tpu_torch.app import run_opt
from eqvio_tpu_torch.data import SyntheticASLReader
from eqvio_tpu_torch.group import VIOAlgebra, group_exp
from eqvio_tpu_torch.io import settings_from_config, template_config
from eqvio_tpu_torch.states import IMU
from tests.test_torch_run_opt import one_torch_thread  # noqa: F401 (autouse fixture)

N, K = 4, 16
# float32 against the float64 plain reference: the largest gap over the
# largest entry, of the covariance and of the observer.  Over windows like
# these (seeds 1-5 and 8, both forms) the port in float32 reads at most 2.3e-6
# and 1.0e-6 (ten or eleven expm and QR steps, each rounding at 6e-8); with
# its matmul inputs rounded to bfloat16 (8 significant bits; TF32 keeps 11,
# float32 24) the larger of the two reads 4.3e-3 to 5.7e-2.  1e-4 sits 40
# times above the one and 40 times below the other.
F32_TOL = 1e-4


class _Bf16Matmuls(TorchDispatchMode):
    """Every matrix product's inputs rounded to bfloat16 (kept in float32)."""

    OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.mv.default,
           torch.ops.aten.addmm.default, torch.ops.aten.dot.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            args = tuple(a.to(torch.bfloat16).to(a.dtype) if isinstance(a, torch.Tensor) and a.is_floating_point()
                         else a for a in args)
        return func(*args, **(kwargs or {}))


def _settings(sqrt: bool):
    s = settings_from_config(template_config())
    assert s.use_accurate_riccati and not s.fast_riccati and s.coordinate_choice == "euclid"
    return dataclasses.replace(s, sqrt_covariance=sqrt)


def _case(seed: int, sqrt: bool):
    """A state with N active landmarks, an observer away from identity and a
    full covariance, and a window of K entries of which 10 or 11 are live
    (the first a partial interval), the rest zero-dt pads."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    settings = _settings(sqrt)
    state = TF.init_state(settings, N, torch.float64, "cpu")
    pts = np.c_[r.uniform(-1, 1, (N, 2)), r.uniform(2, 6, N)]
    state = TF.set_landmarks(state, t(pts), torch.arange(N), torch.ones(N, dtype=torch.bool), settings)
    sensor = state.xi0.sensor._replace(velocity=t(r.normal(size=3) * 0.5), bias=t(r.normal(size=6) * 0.01))
    X = group_exp(VIOAlgebra(*(t(r.normal(size=n) * 0.1) for n in (6, 6, 3, 6)), t(r.normal(size=(N, 4)) * 0.1)))
    D = state.xi0.dim()
    G = t(r.normal(size=(D, D))) * 0.1
    Sigma = torch.diag(TF.dense_sigma(state, settings).diagonal()) + G @ G.T
    state = state._replace(xi0=state.xi0._replace(sensor=sensor), X=X,
                           Sigma=torch.linalg.cholesky(Sigma) if sqrt else Sigma)
    live = 10 + seed % 2
    dts = np.zeros(K)
    dts[:live] = 0.005
    dts[0] = 0.0031
    stamps = 0.005 * np.arange(K) + 0.0019
    gyr = r.normal(size=(K, 3)) * 0.3
    acc = r.normal(size=(K, 3)) * 0.5 + [0.0, 0.0, 9.81]
    gyr[live:], acc[live:] = gyr[live - 1], acc[live - 1]  # pads repeat the last reading, as the packer does
    z = torch.zeros(K, 3, dtype=torch.float64)
    return settings, state, IMU(t(stamps), t(gyr), t(acc), z, z), t(dts)


def _plain(settings, state, imu, dts):
    """The plain reference over the live samples, from the frozen copy of
    the float64 state: ``(X, Sigma)``."""
    fz = to_frozen(state)
    Sigma = fz.Sigma @ fz.Sigma.T if settings.sqrt_covariance else fz.Sigma
    fimu = to_frozen(imu)
    samples = [(type(fimu)(*(f[k] for f in fimu)), float(dts[k])) for k in range(K) if dts[k] > 0]
    q = settings.input_gain_diag(torch.float64, "cpu")
    p = settings.state_gain_diag(N, torch.float64, "cpu")
    return plain_riccati.propagate(fz.X, fz.xi0, Sigma, samples, q, p, frozen_suite(settings.coordinate_choice))


def _rel_gaps(settings, port, plain) -> tuple[float, float]:
    """The port's covariance and observer against the plain reference's,
    each the largest gap over the largest entry."""
    X_ref, Sig_ref = plain
    Sig = TF.dense_sigma(port, settings).to(torch.float64)
    cov = float((Sig - Sig_ref).abs().max() / Sig_ref.abs().max())
    mine = torch.cat([x.reshape(-1).to(torch.float64) for x in torch.utils._pytree.tree_flatten(port.X)[0]])
    ref = torch.cat([x.reshape(-1) for x in torch.utils._pytree.tree_flatten(X_ref)[0]])
    return cov, float((mine - ref).abs().max() / ref.abs().max())


CASES = [(prec, sqrt, seed) for prec in ("float64", "float32", "bf16-matmuls") for sqrt in (True, False)
         for seed in (3, 8)]


@pytest.mark.parametrize("precision,sqrt,seed", CASES,
                         ids=[f"{p}-{'sqrt' if s else 'dense'}-{seed}" for p, s, seed in CASES])
def test_per_sample_propagation_matches_the_plain_reference(precision, sqrt, seed):
    settings, state, imu, dts = _case(seed, sqrt)
    assert 10 <= int((dts > 0).sum()) <= 11
    plain = _plain(settings, state, imu, dts)
    if precision == "float64":
        cov, obs = _rel_gaps(settings, TF.propagate_window(state, imu, dts, settings), plain)
        assert cov < 1e-9 and obs < 1e-9, (cov, obs)
        return
    f32 = lambda tree: torch.utils._pytree.tree_map(  # noqa: E731
        lambda x: x.to(torch.float32) if x.is_floating_point() else x, tree)
    state32, imu32, dts32 = f32(state), f32(imu), dts.to(torch.float32)
    if precision == "float32":
        cov, obs = _rel_gaps(settings, TF.propagate_window(state32, imu32, dts32, settings), plain)
        assert cov < F32_TOL and obs < F32_TOL, (cov, obs)
    else:
        with _Bf16Matmuls():
            out = TF.propagate_window(state32, imu32, dts32, settings)
        cov, obs = _rel_gaps(settings, out, plain)
        assert max(cov, obs) > F32_TOL, (cov, obs)  # the tolerance sees TF32-class rounding


SCENE = dict(end_time=1.0, width=160, height=120, frame_freq=20.0, imu_freq=200.0, num_points=200)
FRAMES, CHUNK = 8, 4


@pytest.fixture(scope="module")
def template_runs():
    reader = SyntheticASLReader(**SCENE)
    cfg = template_config()
    runs = {trace: run_opt.run_dataset(reader, cfg, device="cpu", chunk_size=CHUNK, limit_frames=FRAMES,
                                       dtype=torch.float32, trace=trace)[1] for trace in (False, True)}
    packed = run_opt.collect_fused_inputs(reader, cfg, FRAMES, torch.float32, device="cpu")
    return runs, packed


def test_counters_count_the_packed_windows(template_runs):
    """Per frame K Riccati steps, and the live samples are the packed
    windows' entries with dt > 0; the same traced or not."""
    runs, packed = template_runs
    Kw = packed.imu_window
    live = int(np.count_nonzero(packed.meta[:FRAMES, 7 * Kw:8 * Kw] > 0))
    for s in runs.values():
        assert s["counters"] == {"frames": FRAMES, "riccati_steps": Kw * FRAMES, "imu_samples_live": live}
    assert 0 < live < Kw * FRAMES


def test_fast_riccati_counts_one_step_a_frame():
    from eqvio_tpu_torch.io import bench_config

    reader = SyntheticASLReader(**SCENE)
    _, s = run_opt.run_dataset(reader, bench_config(), device="cpu", chunk_size=CHUNK, limit_frames=8, trace=True)
    assert s["counters"]["riccati_steps"] == s["counters"]["frames"] == 8
    assert 0 < s["counters"]["imu_samples_live"]


RICCATI = {"fast": "integrate_riccati_fast", "accurate": "integrate_riccati_accurate",
           "discrete": "integrate_riccati_discrete"}


@pytest.mark.parametrize("mode", sorted(RICCATI))
def test_riccati_steps_is_what_propagate_window_runs(mode, monkeypatch):
    """``filter.riccati_steps``, which the counter adds up, is the number of
    Riccati steps ``propagate_window`` runs over a padded window."""
    settings, state, imu, dts = _case(3, True)
    settings = dataclasses.replace(settings, fast_riccati=mode == "fast", use_accurate_riccati=mode == "accurate",
                                   use_discrete_state_matrix=mode == "discrete")
    calls = []
    for name in RICCATI.values():
        fn = getattr(TF, name)
        monkeypatch.setattr(TF, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    TF.propagate_window(state, imu, dts, settings)
    assert calls == [RICCATI[mode]] * TF.riccati_steps(settings, K)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_untraced_propagation_issues_the_frozen_copys_ops():
    """The per-sample propagation issues op for op what the benchmark's
    frozen copy of it issues: counting it adds nothing to the step the card
    replays."""
    from benchmark.frozen import filter as frozen

    settings, state, imu, dts = _case(3, True)
    fsettings = frozen.Settings(**dataclasses.asdict(settings))
    ops = []
    for fn, args in ((TF.propagate_window, (state, imu, dts, settings)),
                     (frozen.propagate_window, (to_frozen(state), to_frozen(imu), dts, fsettings))):
        fn(*args)  # the constants both cache on a first call
        with _Ops() as rec:
            fn(*args)
        ops.append(rec.ops)
    assert len(ops[0]) > 1000 and ops[0] == ops[1]


def test_step_issues_no_counter_op(template_runs):
    """The step the fused path runs untraced issues the ops of the bare
    frame step, in order; stamped, those and the stamps alone."""
    _, packed = template_runs
    p = packed
    dev = torch.device("cpu")
    bare = run_opt._make_frame_fn(p.tcfg, p.settings, p.settings.suite, p.camera, p.imu_window, torch.float32)
    runners = {mode: run_opt.ChunkRunner(p.tcfg, p.settings, p.settings.suite, p.camera, p.imu_window,
                                         torch.float32, p.state, p.tracker, dev, stamps=mode == "stamps")
               for mode in ("off", "stamps")}
    imgs, meta = torch.from_numpy(p.imgs[:2]).unbind(), torch.from_numpy(p.meta[:2]).to(torch.float32).unbind()
    ops = {}
    for mode, r in runners.items():
        r.step(imgs[0], meta[0])
        with _Ops() as rec:
            r.step(imgs[1], meta[1])
        ops[mode] = rec.ops
    carry = tuple(runners["off"].step.value())
    with _Ops() as rec:
        bare(carry, imgs[1], meta[1])
    stamp = torch.ops.eqvio_tpu_torch.frame_stamp.default
    n_in = 2  # the inputs' copies into the step's buffers; after the step, the carry's copies
    assert ops["off"][n_in:n_in + len(rec.ops)] == rec.ops
    assert set(ops["off"][:n_in] + ops["off"][n_in + len(rec.ops):]) == {torch.ops.aten.copy_.default}
    assert [op for op in ops["stamps"] if op != stamp] == ops["off"]
    assert ops["stamps"].count(stamp) == len(run_opt.STAMPS)
