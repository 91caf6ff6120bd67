"""Native framepipe tests: build, PNG decode correctness vs cv2, pipeline
ordering and prefetch behavior."""

import os

import numpy as np
import pytest

from rgbdslam.native import framepipe as fp

pytestmark = pytest.mark.skipif(
    not fp.native_available(), reason="native toolchain/libpng unavailable"
)

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def png_pair(tmp_path_factory):
    """Write an 8-bit RGB PNG and a 16-bit depth PNG like TUM's."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    depth = rng.integers(0, 30000, size=(48, 64), dtype=np.uint16)
    rgb_path = str(d / "rgb.png")
    depth_path = str(d / "depth.png")
    cv2.imwrite(rgb_path, rgb[:, :, ::-1])  # cv2 writes BGR
    cv2.imwrite(depth_path, depth)
    return rgb_path, depth_path, rgb, depth


def test_decode_gray_matches_luma(png_pair):
    rgb_path, _, rgb, _ = png_pair
    out = fp.decode_png_gray(rgb_path, 64, 48)
    ref = (
        0.299 * rgb[:, :, 0].astype(np.float32)
        + 0.587 * rgb[:, :, 1]
        + 0.114 * rgb[:, :, 2]
    )
    np.testing.assert_allclose(out, ref, atol=0.5)


def test_decode_depth_16bit(png_pair):
    _, depth_path, _, depth = png_pair
    factor = 5000.0
    out = fp.decode_png_gray(depth_path, 64, 48, scale=1.0 / factor)
    np.testing.assert_allclose(out, depth.astype(np.float32) / factor, atol=1e-6)


def test_pipeline_order_and_content(png_pair):
    rgb_path, depth_path, rgb, depth = png_pair
    pipe = fp.FramePipe(64, 48, n_workers=2, capacity=4)
    items = [(rgb_path, depth_path, 5000.0)] * 10
    tags = []
    for gray, dpt, tag in pipe.stream(items):
        tags.append(tag)
        assert gray.shape == (48, 64)
        assert abs(float(dpt[0, 0]) - depth[0, 0] / 5000.0) < 1e-5
    assert tags == list(range(10))  # submission order preserved


def test_pipeline_bad_file_raises():
    pipe = fp.FramePipe(64, 48, n_workers=1, capacity=2)
    pipe.submit("/nonexistent/a.png", "/nonexistent/b.png", 5000.0, 0)
    pipe.close()
    with pytest.raises(IOError):
        pipe.next()


def test_wrong_size_fails(png_pair):
    rgb_path, _, _, _ = png_pair
    with pytest.raises(IOError):
        fp.decode_png_gray(rgb_path, 32, 32)


def test_interlaced_png_rejected(tmp_path):
    """Adam7-interlaced PNGs are rejected at the header check (single-pass
    decode would silently produce garbage). PIL can't write interlaced PNGs,
    so flip the IHDR interlace flag by hand (re-CRC'd) — the rejection fires
    before any row is read."""
    import struct
    import zlib

    from PIL import Image

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(48, 64), dtype=np.uint8)
    p0 = tmp_path / "plain.png"
    Image.fromarray(img, mode="L").save(str(p0))
    data = bytearray(p0.read_bytes())
    # IHDR: bytes 8..: len(4) 'IHDR'(4) data(13) crc(4); interlace = data[12]
    assert data[12:16] == b"IHDR"
    data[16 + 12] = 1
    crc = zlib.crc32(bytes(data[12 : 16 + 13])) & 0xFFFFFFFF
    data[16 + 13 : 16 + 17] = struct.pack(">I", crc)
    p = tmp_path / "interlaced.png"
    p.write_bytes(bytes(data))
    with pytest.raises(IOError):
        fp.decode_png_gray(str(p), 64, 48)
