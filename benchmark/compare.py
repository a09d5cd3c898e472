"""The comparison that decides ``correct``: a stretch of frames of the
program's outputs against the reference's, from the same state.

Every frame of a stretch is compared: the estimated position, and the
pixels of every track both sides hold.  A track is one corner from its
birth, the frame in which it first shows in the stretch and its pixel
there.  A RANSAC pick that float32 rounding flips makes the two sides keep
a track or three apart from some frame on (the first such frame is the
stretch's ``split``); the side left with fewer tracks then falls under the
tracker's search threshold and detects new corners frames before the other,
and from then on the two give the same new ids to different corners.  So a
track is matched by its birth, not by its id: the same frame, and pixels
within ``BIRTH_PX``, under half the least spacing of the corners one frame
detects; the same id first.  Tracks both hold then agree whatever their
ids, and ``id_mismatch`` is the share of the stretch's track-frames that
one side alone holds.  A stretch in which more than ``ID_SHARE`` of them
are one side's alone, or in which no track is held by both, has too little
in common for its pixel numbers to say anything: they are then infinite.
Of the gaps of the tracks both hold, ``px_gap_median`` sees a shift of most
tracks and ``px_gap_q99``, the 99th percentile, one of more than a
hundredth of the track-frames: a tenth of the tracks moved shows in it as
plainly as all of them.  The widest gap, ``px_gap``, is kept for the
record: one fast track's solve in a thousand can carry a last-bit
difference between the program and the reference to a tenth of a pixel.
"""

from __future__ import annotations

import numpy as np

ID_SHARE = 0.75  # of a stretch's track-frames one side's alone; sound runs read at most 0.233
BIRTH_PX = 10.0  # the corners one frame detects lie featureDist (25 px and more) apart


def _births(rows: dict) -> dict:
    """``{id: (first frame, pixel there)}`` of every track of a stretch."""
    out = {}
    for f, (ids, px) in enumerate(zip(rows["ids"], rows["pixels"])):
        for i, p in zip(ids, px):
            if i >= 0 and int(i) not in out:
                out[int(i)] = (f, np.asarray(p, dtype=np.float64))
    return out


def match(prog: dict, ref: dict) -> dict:
    """``{program id: reference id}`` of the tracks both sides hold: the
    same id where its birth is the same on both sides, else the reference's
    track born in the same frame within ``BIRTH_PX``."""
    bp, br = _births(prog), _births(ref)

    def same(a, b):
        return a[0] == b[0] and float(np.max(np.abs(a[1] - b[1]))) <= BIRTH_PX

    m = {i: i for i, b in bp.items() if i in br and same(b, br[i])}
    free = {j: b for j, b in br.items() if j not in m}
    for i, b in bp.items():
        if i in m:
            continue
        near = [(float(np.max(np.abs(b[1] - c[1]))), j) for j, c in free.items() if same(b, c)]
        if near:
            j = min(near)[1]
            m[i] = j
            del free[j]
    return m


def stretch(prog: dict, ref: dict) -> dict:
    """Gaps of one stretch.  ``prog`` and ``ref`` hold per frame
    ``position [S, 3]``, ``ids [S, N]`` (-1 where a slot is not visible)
    and ``pixels [S, N, 2]`` (slot-aligned with ``ids``).  Returns
    ``pos_gap_m`` and ``px_gap`` (the widest over all frames and tracks),
    ``px_gap_median``, ``px_gap_q99``, ``id_mismatch`` (the share of the
    stretch's track-frames that one side alone holds), ``split`` (the first
    frame whose tracks differ), ``frames`` and ``px_worst`` (frame,
    reference id and both pixels of the widest)."""
    S = len(ref["position"])
    m = match(prog, ref)
    split, one_sided, union, px_gap, gaps, worst = S, 0, 0, 0.0, [], None
    for f in range(S):
        pa = {m.get(int(i), ("program", int(i))): p for i, p in zip(prog["ids"][f], prog["pixels"][f]) if i >= 0}
        pb = {int(i): p for i, p in zip(ref["ids"][f], ref["pixels"][f]) if i >= 0}
        diff = len(pa.keys() ^ pb.keys())
        one_sided, union = one_sided + diff, union + len(pa.keys() | pb.keys())
        if diff:
            split = min(split, f)
        for i in pa.keys() & pb.keys():
            g = float(np.max(np.abs(np.asarray(pa[i], dtype=np.float64) - pb[i])))
            gaps.append(g)
            if g >= px_gap:
                px_gap, worst = g, [f, i, [float(v) for v in pa[i]], [float(v) for v in pb[i]]]
    mism = one_sided / max(union, 1)
    pos = np.abs(np.asarray(prog["position"], dtype=np.float64) - ref["position"])
    pos_gap = float(np.max(pos)) if np.isfinite(pos).all() else float("inf")
    if mism > ID_SHARE or not gaps:
        px_gap = median = q99 = float("inf")
    else:
        median, q99 = float(np.median(gaps)), float(np.quantile(gaps, 0.99))
    return {"pos_gap_m": pos_gap, "px_gap": px_gap, "px_gap_median": median, "px_gap_q99": q99,
            "id_mismatch": mism, "split": split, "frames": S, "px_worst": worst}


def combine(stretches: list[dict]) -> dict:
    """The widest of each gap over the stretches, and the stretches."""
    out = {k: max(s[k] for s in stretches) for k in ("pos_gap_m", "px_gap", "px_gap_median", "px_gap_q99",
                                                        "id_mismatch")}
    out["stretches"] = stretches
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [[name, value, limit], ...])`` for every number that has
    a limit: correct where each is at most its limit (a value that is not a
    number fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = float(numbers[name])
        rows.append([name, v, limit])
        ok = ok and np.isfinite(v) and v <= limit
    return ok, rows
