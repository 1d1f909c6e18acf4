"""Dynamic-object handling (reference: code/src/{DynamicExtractor,
DynamicRunner}.cc — Dynamic_ORB_SLAM2 heritage, §2.8 of SURVEY.md).

Port of swarmmap_tpu/core/dynamic.py.  The reference runs mask-RCNN
through cv::dnn with optical-flow mask propagation, then votes MapPoints
dynamic (MapPoint.h:129-132).  Like the reference's monocular entry
points, this subsystem is OPTIONAL and not wired into the default
pipeline.

The same architecture with a pluggable segmenter:
  - `segment_fn(image) -> bool mask [H,W]` — any model; the shipped one
    is `ConvSegmenter`, a 3-layer conv on the tracker's device
    (`load_segmenter`).  Without one, keypoints whose reprojection
    residuals repeatedly disagree with the rigid-motion estimate
    accumulate dynamic votes.
  - `DynamicRunner` — priority-ordered batch worker over keyframes
    voting their observed MapPoints dynamic/static.

Copied line for line from the JAX package (numpy on the host): the LK
flow and mask propagation, the stripe texture, `DynamicExtractor`,
`DynamicVotes`, `DynamicRunner` (its mask vote as `mask_hits`, so a
harness can recompute a keyframe's votes from another mask).  `ConvSegmenter` is an `nn.Module`
instead of the JAX package's numpy im2col: the same cross-correlation,
one upload, three convolutions and one fetch per image.
"""
from __future__ import annotations

import heapq
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..utils.device import default_device, fetch
from .map_store import NO_MP, MapStore

DYNAMIC_VOTE_TH = 3       # votes needed to flag a point dynamic
VOTE_RATIO = 2.0          # dynamic votes must dominate static by this


# ---------------------------------------------------------------------------
# Optical flow (pyramidal Lucas-Kanade) + mask propagation
# (reference: DynamicExtractor.h:40-53 propagates Mask-RCNN masks with
# optical flow between segmented frames)
# ---------------------------------------------------------------------------

def _downsample(img: np.ndarray) -> np.ndarray:
    h, w = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    x = img[:h, :w].astype(np.float32)
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def _grad(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def _patch(img: np.ndarray, x: float, y: float, r: int) -> np.ndarray | None:
    """Bilinear window of half-size r centered at (x, y); None off-image."""
    h, w = img.shape
    if not (r + 1 <= x < w - r - 2 and r + 1 <= y < h - r - 2):
        return None
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    ax, ay = x - x0, y - y0
    win = img[y0 - r: y0 + r + 2, x0 - r: x0 + r + 2]
    top = (1 - ax) * win[:-1, :-1] + ax * win[:-1, 1:]
    bot = (1 - ax) * win[1:, :-1] + ax * win[1:, 1:]
    return (1 - ay) * top + ay * bot


def lk_flow(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray,
            win: int = 7, iters: int = 8, levels: int = 3,
            ) -> tuple[np.ndarray, np.ndarray]:
    """Pyramidal Lucas-Kanade at [N,2] (x, y) points.
    Returns ([N,2] flow, [N] converged)."""
    prev_pyr = [prev.astype(np.float32)]
    next_pyr = [nxt.astype(np.float32)]
    for _ in range(levels - 1):
        prev_pyr.append(_downsample(prev_pyr[-1]))
        next_pyr.append(_downsample(next_pyr[-1]))
    r = win // 2
    n = len(pts)
    flow = np.zeros((n, 2), np.float32)
    ok = np.zeros(n, bool)
    grads = [_grad(p) for p in prev_pyr]
    for i in range(n):
        g = np.zeros(2, np.float32)  # accumulated flow (finest scale)
        good = False
        for lvl in range(levels - 1, -1, -1):
            s = 0.5 ** lvl
            x, y = pts[i, 0] * s, pts[i, 1] * s
            P = _patch(prev_pyr[lvl], x, y, r)
            if P is None:
                continue
            Gx = _patch(grads[lvl][0], x, y, r)
            Gy = _patch(grads[lvl][1], x, y, r)
            A = np.array([[np.sum(Gx * Gx), np.sum(Gx * Gy)],
                          [np.sum(Gx * Gy), np.sum(Gy * Gy)]])
            if np.linalg.det(A) < 1e-4:
                continue
            Ainv = np.linalg.inv(A)
            d = g * s
            conv = False
            for _ in range(iters):
                Q = _patch(next_pyr[lvl], x + d[0], y + d[1], r)
                if Q is None:
                    break
                e = Q - P
                step = Ainv @ np.array([np.sum(Gx * e), np.sum(Gy * e)])
                d -= step
                if np.abs(step).max() < 0.03:
                    conv = True
                    break
            g = d / s
            good = good or conv
        flow[i] = g
        ok[i] = good and np.abs(g).max() < 0.5 * min(prev.shape)
    return flow, ok


def propagate_mask(prev_img: np.ndarray, next_img: np.ndarray,
                   mask: np.ndarray, grid_step: int = 8) -> np.ndarray:
    """Warp a boolean object mask to the next frame: track a grid of
    in-mask points with LK and re-stamp disks at their new positions
    (reference: the optical-flow mask propagation of
    DynamicExtractor.h:40-53)."""
    ys, xs = np.mgrid[grid_step // 2: mask.shape[0]: grid_step,
                      grid_step // 2: mask.shape[1]: grid_step]
    inside = mask[ys, xs]
    pts = np.stack([xs[inside], ys[inside]], 1).astype(np.float32)
    if not len(pts):
        return np.zeros_like(mask)
    flow, ok = lk_flow(prev_img, next_img, pts)
    if ok.sum() < 3:
        return mask.copy()  # flow failed: reuse the last mask
    moved = pts[ok] + flow[ok]
    out = np.zeros_like(mask)
    r = grid_step  # disk radius covers the grid spacing
    h, w = mask.shape
    for x, y in moved:
        x0, x1 = int(max(x - r, 0)), int(min(x + r + 1, w))
        y0, y1 = int(max(y - r, 0)), int(min(y + r + 1, h))
        if x0 < x1 and y0 < y1:
            out[y0:y1, x0:x1] = True
    return out


# ---------------------------------------------------------------------------
# Shipped tiny segmenter.  The reference's DynamicExtractor runs an
# appearance-based Mask-RCNN through cv::dnn for known dynamic classes
# (DynamicExtractor.cc); the synthetic analogue is a 3-layer conv (~1.3k
# params, tools/train_dyn_segmenter.py) that segments the STRIPED texture
# family the synthetic worlds use for dynamic objects — static landmarks
# are ring/wedge disks, a distinct appearance class.
# ---------------------------------------------------------------------------

def stripe_texture(size: int, rng) -> np.ndarray:
    """The dynamic-object appearance class: high-contrast diagonal
    stripes (period 5-8 px, random phase/orientation sign)."""
    yy, xx = np.mgrid[0:size, 0:size]
    period = rng.uniform(5.0, 8.0)
    sgn = 1.0 if rng.rand() < 0.5 else -1.0
    phase = rng.uniform(0, 2 * np.pi)
    wave = np.sin(2 * np.pi * (xx + sgn * yy) / period + phase)
    lo, hi = rng.uniform(10, 60), rng.uniform(190, 250)
    return (lo + (hi - lo) * (wave > 0)).astype(np.float32)


class ConvSegmenter(nn.Module):
    """The shipped 3-layer conv on one device: same-padded convolutions
    with a ReLU between them, in float32 (TF32 stays off, as the package
    pins it; no autocast).  `__call__` follows the `segment_fn(image) ->
    bool mask` hook contract; `logits` gives the map before the
    threshold.  Built from the JAX package's arrays by
    `convert.segmenter_from_numpy`."""

    def __init__(self, shapes: list[tuple[int, ...]], device: torch.device | str):
        """`shapes`: each layer's weight shape (cout, cin, kh, kw).  The
        parameters are left uninitialised (no draw from torch's global
        generator): the caller loads them."""
        super().__init__()
        self.device = torch.device(device)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, (kh, kw), padding=(kh // 2, kw // 2), device="meta")
            for cout, cin, kh, kw in shapes).to_empty(device=self.device)

    @torch.no_grad()
    def logits(self, image: np.ndarray) -> torch.Tensor:
        """[H, W] image (uint8 or float) -> [H, W] float32 logits on the
        module's device (one upload)."""
        x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        # a true division, as numpy's: a Python divisor makes the card's
        # kernel multiply by its reciprocal
        x = (x.to(torch.float32) / torch.full((), 255.0, device=self.device))[None, None]
        for li, conv in enumerate(self.convs):
            x = conv(x)
            if li + 1 < len(self.convs):
                x = torch.relu(x)
        return x[0, 0]

    def forward(self, image: np.ndarray) -> np.ndarray:
        """bool mask [H, W] on the host (one fetch)."""
        return fetch(self.logits(image) > 0.0)


# the JAX package's shipped weights, read by path: a data file, not an import
SHIPPED_SEGMENTER = (Path(__file__).resolve().parents[2] / "swarmmap_tpu" / "data"
                     / "dyn_segmenter.npz")


def load_segmenter(device: torch.device | str | None = None) -> ConvSegmenter:
    """The shipped dynamic-object segmenter on `device` (by default the
    card, `utils.device.default_device`)."""
    from ..convert import segmenter_from_numpy

    device = default_device() if device is None else device
    return segmenter_from_numpy(dict(np.load(SHIPPED_SEGMENTER)), device)


class DynamicExtractor:
    """Mask source with the reference's cadence (DynamicExtractor.cc):
    run the (expensive) segmenter every `segment_every` frames and
    propagate the mask with optical flow in between.

    `segment_fn(image) -> bool mask [H,W]` is the model hook — plug a
    cv2.dnn / ONNX Mask-RCNN here (the reference loads one through
    cv::dnn; no weights ship in this container).  Example:

        net = cv2.dnn.readNetFromONNX("maskrcnn.onnx")
        def segment(img): ...  # forward + threshold person/vehicle ids
        ex = DynamicExtractor(segment, segment_every=5)
    """

    def __init__(self, segment_fn: Callable[[np.ndarray], np.ndarray],
                 segment_every: int = 5):
        self.segment_fn = segment_fn
        self.segment_every = segment_every
        self._count = 0
        self._mask: np.ndarray | None = None
        self._prev: np.ndarray | None = None

    def mask_for(self, image: np.ndarray) -> np.ndarray:
        if self._mask is None or self._count % self.segment_every == 0:
            self._mask = np.asarray(self.segment_fn(image), bool)
        else:
            self._mask = propagate_mask(self._prev, image, self._mask)
        self._prev = image
        self._count += 1
        return self._mask


class DynamicVotes:
    """Per-map dynamic/static vote ledger (MapPoint.h:129-132 analogue)."""

    def __init__(self, store: MapStore):
        self.store = store
        self.dyn = np.zeros(len(store.mp_alive), np.int32)
        self.stat = np.zeros(len(store.mp_alive), np.int32)

    def _ensure(self):
        n = len(self.store.mp_alive)
        if len(self.dyn) < n:
            self.dyn = np.resize(self.dyn, n)
            self.stat = np.resize(self.stat, n)

    def vote(self, mp_slots: np.ndarray, dynamic: np.ndarray):
        self._ensure()
        np.add.at(self.dyn, mp_slots[dynamic], 1)
        np.add.at(self.stat, mp_slots[~dynamic], 1)

    def is_dynamic(self, mp_slots: np.ndarray) -> np.ndarray:
        self._ensure()
        d = self.dyn[mp_slots]
        s = self.stat[mp_slots]
        return (d >= DYNAMIC_VOTE_TH) & (d > VOTE_RATIO * np.maximum(s, 1))


def mask_hits(mask: np.ndarray, uv: np.ndarray, mp: np.ndarray,
              valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A keyframe's votes from one mask: (its keypoints that observe a
    map point, whether each of those hits the mask)."""
    has = (mp != NO_MP) & valid
    xs = np.clip(uv[has, 0].astype(int), 1, mask.shape[1] - 2)
    ys = np.clip(uv[has, 1].astype(int), 1, mask.shape[0] - 2)
    # 3x3 max: keypoint centers are sub-pixel, and a corner
    # sits exactly where the segmenter is least confident —
    # count a hit anywhere in the pixel neighborhood
    hit = np.zeros(len(xs), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            hit |= mask[ys + dy, xs + dx]
    return has, hit


class DynamicRunner:
    """Batch worker: processes keyframes by score priority, votes their
    points via the segmenter mask (reference: DynamicRunner singleton)."""

    def __init__(self, store: MapStore,
                 segment_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                 extractor: "DynamicExtractor | None" = None):
        self.store = store
        self.votes = DynamicVotes(store)
        self.segment_fn = segment_fn
        # a DynamicExtractor adds the reference's segment-every-N +
        # flow-propagate-in-between cadence on top of segment_fn
        self.extractor = extractor
        self._heap: list[tuple[float, int, np.ndarray]] = []
        self._seq = 0

    def enqueue(self, kf_slot: int, image: np.ndarray, score: float = 0.0):
        heapq.heappush(self._heap, (-score, self._seq, kf_slot, image))
        self._seq += 1

    def process(self, max_items: int = 4) -> int:
        """Run the segmenter over the highest-priority keyframes and vote
        their observed points."""
        if self.segment_fn is None and self.extractor is None:
            return 0
        st = self.store
        n = 0
        while self._heap and n < max_items:
            _, _, k, image = heapq.heappop(self._heap)
            if not st.kf_alive[k]:
                continue
            mask = (self.extractor.mask_for(image)
                    if self.extractor is not None else self.segment_fn(image))
            mp = st.kf_kp_mp[k]
            has, hit = mask_hits(mask, st.kf_kp_uv[k], mp, st.kf_kp_valid[k])
            self.votes.vote(mp[has], hit)
            n += 1
        return n

    def vote_from_residuals(self, mp_slots: np.ndarray, chi2: np.ndarray,
                            chi2_th: float = 5.991):
        """Model-free fallback: outlier residuals under the rigid-motion
        estimate count as dynamic evidence."""
        self.votes.vote(np.asarray(mp_slots), np.asarray(chi2) > 4 * chi2_th)

    def filter_static(self, mp_slots: np.ndarray) -> np.ndarray:
        """Mask of points safe to track (not voted dynamic)."""
        return ~self.votes.is_dynamic(np.asarray(mp_slots))
