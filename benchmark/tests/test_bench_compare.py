"""The comparison matches tracks by their birth, not by their ids: a sound
run whose tracker detected a batch of corners frames before the
reference's (after a RANSAC flip left it with fewer tracks) gives the same
ids to other corners, and those are not compared with each other; a shift
of the tracks both hold still shows."""

from __future__ import annotations

import numpy as np

from benchmark import compare

S, N = 12, 16


def _rows(rng_seed: int = 3) -> dict:
    """Ten tracks (ids 0-9) born at frame 0 on a 40 px grid, moving."""
    rng = np.random.default_rng(rng_seed)
    ids = np.full((S, N), -1, dtype=np.int64)
    px = np.zeros((S, N, 2))
    base = np.stack([40.0 + 40.0 * np.arange(10), 50.0 + 40.0 * np.arange(10)], axis=-1)
    vel = rng.uniform(-1.0, 1.0, size=(10, 2))
    for f in range(S):
        ids[f, :10] = np.arange(10)
        px[f, :10] = base + f * vel
    return {"position": np.zeros((S, 3)), "ids": ids, "pixels": px}


def _detect(rows: dict, frame: int, corners: np.ndarray, first_id: int) -> dict:
    """New corners from ``frame`` on in slots 10.., ids from ``first_id``."""
    for f in range(frame, S):
        for k, c in enumerate(corners):
            rows["ids"][f, 10 + k] = first_id + k
            rows["pixels"][f, 10 + k] = c + 0.5 * (f - frame)
    return rows


def test_same_ids_on_other_corners_are_not_compared():
    prog = _detect(_rows(), 3, np.array([[500.0, 60.0], [560.0, 200.0], [450.0, 300.0]]), 100)
    ref = _detect(_rows(), 5, np.array([[80.0, 400.0], [300.0, 420.0], [200.0, 460.0]]), 100)
    s = compare.stretch(prog, ref)
    assert s["px_gap_median"] == 0.0 and s["px_gap_q99"] == 0.0 and s["px_gap"] == 0.0
    assert s["split"] == 3 and 0.0 < s["id_mismatch"] < compare.ID_SHARE
    # compared by ids, corners hundreds of pixels apart would stand as one track
    assert np.max(np.abs(prog["pixels"][6, 10] - ref["pixels"][6, 10])) > 100.0


def test_one_corner_under_two_ids_is_compared():
    corners = np.array([[500.0, 60.0], [560.0, 200.0]])
    prog = _detect(_rows(), 4, corners, 100)
    ref = _detect(_rows(), 4, corners, 103)
    ref["pixels"][6:, 11] += 0.25
    s = compare.stretch(prog, ref)
    assert compare.match(prog, ref)[101] == 104
    assert s["id_mismatch"] == 0.0 and s["px_gap"] == 0.25


def test_a_tenth_shifted_shows():
    prog, ref = _rows(), _rows()
    prog["pixels"][:, 0] += 0.25
    s = compare.stretch(prog, ref)
    assert s["px_gap_q99"] > 0.2 and s["id_mismatch"] == 0.0


def test_nothing_in_common_is_not_finite():
    prog, ref = _rows(), _rows()
    prog["pixels"][:, :10] += 20.0
    s = compare.stretch(prog, ref)
    assert s["id_mismatch"] == 1.0
    assert not np.isfinite(s["px_gap_median"]) and not np.isfinite(s["px_gap_q99"])
    ok, _ = compare.judge(s, {"px_gap_median": 1.0, "px_gap_q99": 1.0})
    assert not ok
