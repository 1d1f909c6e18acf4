"""The port's dataset loaders and PNG codec against the JAX package's
loaders and cv2, on tests/test_datasets.py's trees (written with cv2 as
that file writes them), and the other host leftovers of the port's
utils: trajectory files, the stage CSV, the timers and `fetch_np`.

Exact throughout: the port's loaders give the JAX loaders' paths,
timestamps and arrays on the same tree; `utils/png.py` reads what
`cv2.imread` reads (gray 8-bit and 16-bit, and RGB / RGBA to gray, which
cv2's libpng build truncates from 9797 R + 19234 G + 3737 B over 2^15),
through each of the five scanline filters and split IDAT chunks; cv2
reads back what the port writes.
"""
import struct
import zlib

import numpy as np
import pytest
import torch

from swarmmap_tpu.utils import datasets as jds, trajectory as jtraj
from swarmmap_tpu_torch.utils import datasets as pds, png, stats, timer, trajectory as ptraj
from swarmmap_tpu_torch.utils.device import fetch_np
from test_datasets import N_FRAMES, _euroc_tree, _kitti_tree, _tum_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

cv2 = pytest.importorskip("cv2")

HW = (120, 160)


@pytest.fixture(scope="module")
def frames():
    w = pds.make_world(n_points=120, n_frames=N_FRAMES, hw=HW, seed=3)
    return [pds.render_frame(w, i) for i in range(N_FRAMES)]


def _same_sequence(p: pds.ImageSequence, j, reads=("read",)):
    assert p.paths == j.paths
    np.testing.assert_array_equal(p.timestamps, j.timestamps)
    assert p.timestamps.dtype == j.timestamps.dtype
    for name in reads:
        for i in range(len(j)):
            a, b = getattr(p, name)(i), getattr(j, name)(i)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_euroc_loader_matches_jax(tmp_path, frames):
    cam, times, stamps_ns = _euroc_tree(tmp_path, frames)
    seq = pds.load_euroc(str(cam), str(times))
    _same_sequence(seq, jds.load_euroc(str(cam), str(times)))
    np.testing.assert_allclose(seq.timestamps, np.asarray(stamps_ns) / 1e9, rtol=1e-9)
    np.testing.assert_array_equal(seq.read(0), frames[0])
    _same_sequence(pds.load_euroc(str(cam)), jds.load_euroc(str(cam)))


def test_tum_loader_matches_jax(tmp_path, frames):
    _tum_tree(tmp_path, frames)
    _same_sequence(pds.load_tum(str(tmp_path)), jds.load_tum(str(tmp_path)))
    seqd = pds.load_tum(str(tmp_path), with_depth=True)
    _same_sequence(seqd, jds.load_tum(str(tmp_path), with_depth=True),
                   reads=("read", "read_depth"))
    assert seqd.depth_paths == jds.load_tum(str(tmp_path), with_depth=True).depth_paths
    np.testing.assert_allclose(seqd.read_depth(0), 1.0, atol=0.01)


def test_kitti_loader_matches_jax(tmp_path, frames):
    _kitti_tree(tmp_path, frames)
    _same_sequence(pds.load_kitti(str(tmp_path)), jds.load_kitti(str(tmp_path)))
    _same_sequence(pds.load_kitti(str(tmp_path), with_right=True),
                   jds.load_kitti(str(tmp_path), with_right=True), reads=("read", "read_right"))


@pytest.mark.parametrize("dtype", ["euroc", "tum", "kitti"])
def test_load_sequence_matches_jax(tmp_path, frames, dtype):
    root = tmp_path / dtype
    if dtype == "euroc":
        cam, times, _ = _euroc_tree(root, frames)
        args = (str(cam), str(times))
    else:
        (_tum_tree if dtype == "tum" else _kitti_tree)(root, frames)
        args = (str(root), None)
    sensor = {"euroc": "mono", "tum": "rgbd", "kitti": "stereo"}[dtype]
    _same_sequence(pds.load_sequence(dtype, *args, sensor=sensor),
                   jds.load_sequence(dtype, *args, sensor=sensor))
    with pytest.raises(ValueError):
        pds.load_sequence("nope", *args)


def test_missing_image_raises(tmp_path):
    seq = pds.ImageSequence(paths=[str(tmp_path / "none.png")], timestamps=np.zeros(1))
    with pytest.raises(FileNotFoundError):
        seq.read(0)


# -- the PNG codec against cv2 ----------------------------------------------

def _encode(img: np.ndarray, filters, ctype: int, depth: int, n_idat: int = 3) -> bytes:
    """A PNG of `img` with the given scanline filter per row, its image
    data split over `n_idat` chunks (the filters computed on the whole
    image at once: the encoder knows every neighbour)."""
    h = img.shape[0]
    rows = (img.astype(">u2").view(np.uint8) if depth == 16 else img).reshape(h, -1)
    rows = rows.astype(np.int32)
    bpp = {0: 1, 2: 3, 6: 4}[ctype] * depth // 8
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    ul = np.zeros_like(rows)
    ul[1:, bpp:] = rows[:-1, :-bpp]
    p = left + up - ul
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    preds = [0 * rows, left, up, (left + up) >> 1, paeth]
    pred = np.stack([preds[f][r] for r, f in enumerate(filters)])
    raw = np.concatenate([np.asarray(filters, np.uint8)[:, None],
                          ((rows - pred) & 255).astype(np.uint8)], 1).tobytes()
    z = zlib.compress(raw)
    parts = [z[i * len(z) // n_idat:(i + 1) * len(z) // n_idat] for i in range(n_idat)]

    def chunk(kind, body):
        crc = struct.pack(">I", zlib.crc32(kind + body))
        return struct.pack(">I", len(body)) + kind + body + crc

    header = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + b"".join(chunk(b"IDAT", q) for q in parts) + chunk(b"IEND", b""))


LAYOUTS = {"gray8": (0, 8, (37, 53)), "rgb8": (2, 8, (29, 41, 3)),
           "rgba8": (6, 8, (23, 31, 4)), "gray16": (0, 16, (19, 27))}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("filt", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_filters_match_cv2(tmp_path, rng, layout, filt):
    ctype, depth, shape = LAYOUTS[layout]
    img = rng.randint(0, 256 if depth == 8 else 65536, shape).astype(
        np.uint8 if depth == 8 else np.uint16)
    names = ["none", "sub", "up", "average", "paeth"]
    filters = (rng.randint(0, 5, shape[0]) if filt == "mixed"
               else [names.index(filt)] * shape[0])
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, filters, ctype, depth))
    if ctype == 0:
        got, want = png.imread_unchanged(path), cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if depth == 8:
        got, want = png.imread_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reads_cv2_files(tmp_path, rng, channels):
    """Files cv2 writes itself (its own filter choice), full EuRoC size;
    colour to gray in every pixel of a random image."""
    shape = (480, 752) if channels == 1 else (480, 640, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(png.imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_writer_read_back_by_cv2(tmp_path, rng, frames, dtype):
    img = (frames[1] if dtype == np.uint8
           else rng.randint(0, 65536, HW).astype(np.uint16))
    path = str(tmp_path / "w.png")
    png.imwrite(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.imread_unchanged(path), img)


def test_png_unsupported_layouts_raise(tmp_path, rng):
    img = rng.randint(0, 256, (8, 8)).astype(np.uint8)
    base = _encode(img, [0] * 8, 0, 8, n_idat=1)
    for name, patch in [("palette", (25, 3)), ("interlaced", (28, 1))]:
        data = bytearray(base)
        data[patch[0]] = patch[1]
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        path = tmp_path / f"{name}.png"
        path.write_bytes(bytes(data))
        with pytest.raises(ValueError, match=f"{name}.png"):
            png.imread_gray(path)
    corrupt = tmp_path / "corrupt.png"
    corrupt.write_bytes(base[:40] + bytes([base[40] ^ 1]) + base[41:])
    with pytest.raises(ValueError, match="corrupt.png"):
        png.imread_gray(corrupt)
    deep = tmp_path / "deep.png"
    deep.write_bytes(_encode(img.astype(np.uint16), [0] * 8, 0, 16))
    with pytest.raises(ValueError, match="deep.png"):
        png.imread_gray(deep)


# -- the other host leftovers -------------------------------------------------

def test_trajectory_files_match_jax(tmp_path, rng):
    from scipy.spatial.transform import Rotation

    poses = np.stack([np.eye(4)] * 4)
    for T in poses:
        T[:3, :3] = Rotation.from_rotvec(rng.randn(3)).as_matrix()
        T[:3, 3] = rng.randn(3)
    stamps = np.arange(4) * 0.05 + 1403636579.76
    ptraj.save_tum(tmp_path / "p.txt", stamps, poses)
    for mod, name in ((ptraj, "pk.txt"), (jtraj, "jk.txt")):
        mod.save_kitti(tmp_path / name, poses)
    assert (tmp_path / "pk.txt").read_bytes() == (tmp_path / "jk.txt").read_bytes()
    (ps, pp), (js, jp) = ptraj.load_tum(tmp_path / "p.txt"), jtraj.load_tum(tmp_path / "p.txt")
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_allclose(pp, poses, atol=1e-5)


def test_stats_csv_and_timers(tmp_path):
    s = stats.StageStats()
    with s.stage("a"):
        pass
    s.bump("rpc_fetch", 3)
    s.save_csv(tmp_path / "s.csv")
    rows = (tmp_path / "s.csv").read_text().splitlines()
    assert rows[0] == "stage,count,total_s,mean_ms,p50_ms,max_ms"
    assert rows[1].startswith("a,1,") and rows[2].startswith("rpc_fetch,3,")
    t = timer.Timer("x")
    for _ in range(3):
        with t.scope():
            pass
    assert t.count == 3 and t.mean_ms() >= 0 and t.percentile_ms(50) >= 0
    assert timer.Timer().percentile_ms(90) == 0.0
    said = []
    with timer.ScopeTimer("label", emit=said.append):
        pass
    assert said and said[0].startswith("label: ") and said[0].endswith(" ms")


def test_fetch_np_gives_numpy_leaves():
    stats.STATS.reset()
    one = fetch_np(torch.arange(3))
    assert isinstance(one, np.ndarray) and one.tolist() == [0, 1, 2]
    a, (b, c) = fetch_np(torch.ones(2), (torch.zeros(1), 7))
    assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
    assert isinstance(c, np.ndarray) and c.shape == () and int(c) == 7
    assert stats.STATS.counts["rpc_fetch"] == 2
