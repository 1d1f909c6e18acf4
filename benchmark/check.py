"""The comparison that decides `correct`.

A sample of the window's steps, drawn from the seed, is run again through
the plain reference (`reference/track.py`) on the same host inputs, once
the window has closed.  Five numbers are compared, each with its limit
from `limits/<workload>.json`:

- kp_diff_pct: keypoint slots whose validity, position, octave or
  descriptor differ from the reference's, in % of all slots (front end);
- match_diff_pct: slots whose matched map point differs, in % of the
  slots that either side matched (matching, after the pose's inliers);
- pose_err_p90 and pose_err_max: the 90th percentile and the largest,
  over the sampled agent frames, of the largest |Tcw - Tcw_ref| entry
  (pose; the reference's LM runs in float64).  After the fixed 2 x 8
  schedule a rare frame is left unconverged along a flat direction of its
  cost, and there float32 rounding alone decides an accept or a reject
  and moves the pose by some 1e-3, as far as the TF32 control moves a
  frame.  So the percentile, which a rare frame cannot move, separates
  the control and a pose wrong in many frames; the largest, with its
  wider limit, catches one frame's pose that is grossly wrong;
- inlier_gap: the largest |n_inliers - n_inliers_ref| (pose).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

LIMITS = Path(__file__).resolve().parent / "limits"
NUMBERS = ("kp_diff_pct", "match_diff_pct", "pose_err_p90", "pose_err_max", "inlier_gap")


class Reservoir:
    """A uniform sample of `k` of the steps seen so far (Algorithm R),
    drawn from `rng`: the same seed and step count pick the same steps."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _worst(a: float, b) -> float:
    """The larger of a and b, NaN if either is NaN."""
    b = float(b)
    return b if (b != b or b > a) else a


def _quantile(per_step: list, q: float) -> float:
    """Quantile q of every agent frame's value, NaN if any is NaN."""
    x = np.concatenate(per_step) if per_step else np.zeros(1)
    return float("nan") if np.isnan(x).any() else float(np.quantile(x, q))


def frame_gaps(prog: dict, ref: dict) -> np.ndarray:
    """[A] largest |Tcw - Tcw_ref| entry of each agent frame of a step."""
    return np.abs(prog["Tcw"].astype(np.float64) - ref["Tcw"]).max((-1, -2))


def compare(prog: list[dict], ref: list[dict]) -> dict:
    """The five numbers over pairs of host outputs: dicts of numpy [A, ...]
    arrays xy, octave, desc, valid, match_mp, Tcw and n_inliers."""
    slots = kp_bad = matched = match_bad = 0
    inlier_gap = 0.0
    pose = []
    for p, r in zip(prog, ref, strict=True):
        both = p["valid"] & r["valid"]
        same = ((p["xy"] == r["xy"]).all(-1) & (p["octave"] == r["octave"])
                & (p["desc"] == r["desc"]).all(-1))
        kp_bad += int(((p["valid"] != r["valid"]) | (both & ~same)).sum())
        slots += p["valid"].size
        matched += int(((p["match_mp"] >= 0) | (r["match_mp"] >= 0)).sum())
        match_bad += int((p["match_mp"] != r["match_mp"]).sum())
        pose.append(frame_gaps(p, r))
        inlier_gap = _worst(inlier_gap, np.abs(p["n_inliers"].astype(np.int64)
                                               - r["n_inliers"]).max())
    return {"kp_diff_pct": 100.0 * kp_bad / max(slots, 1),
            "match_diff_pct": 100.0 * match_bad / max(matched, 1),
            "pose_err_p90": _quantile(pose, 0.9), "pose_err_max": _quantile(pose, 1.0),
            "inlier_gap": inlier_gap}


def limits(workload: str) -> dict:
    return json.loads((LIMITS / f"{workload}.json").read_text())["limits"]


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers[k], "limit": lim[k]} for k in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
