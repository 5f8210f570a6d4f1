"""The port's JPEG codec (align3r_tpu_torch.utils.jpeg, csrc/jpeg_decode.cpp)
against libjpeg-turbo as cv2.imread / cv2.imdecode and Pillow run it.

The decoder must give the same bits as both (they agree with each other):
files written by Pillow at quality 75 with 4:2:0 (the preprocess writer,
datasets_preprocess/common.py), 4:2:2, 4:4:4 and gray, by cv2.imwrite with
its defaults, with restart intervals and with 4:2:2, at sizes that are not
multiples of the MCU (1x1, 2x3, 17x33, 61x97, 288x512), and with every EXIF
orientation. The encoder's files must decode to the same bits in cv2 and in
the port. A progressive file is not read by the decoder: `read_rgb` hands it
to Pillow where Pillow is importable, and otherwise raises an ImportError
that names the file and its SOF marker. A source that does not compile
raises with the compiler's messages.
"""
import io
import os
import subprocess
import sys

import cv2
import numpy as np
import PIL.Image
import pytest
from PIL.ImageOps import exif_transpose

from align3r_tpu_torch.inference.images import read_l, read_rgb
from align3r_tpu_torch.utils import jpeg
from torch_data_fixtures import frame_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(1, 1), (2, 3), (17, 33), (61, 97), (288, 512)]


def _pil_bytes(img, **kw):
    b = io.BytesIO()
    PIL.Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _cv2_bytes(img, params=()):
    ok, enc = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img, list(params))
    assert ok
    return enc.tobytes()


WRITERS = {
    "pil_q75_420": lambda img: _pil_bytes(img),
    "pil_q90_422": lambda img: _pil_bytes(img, quality=90, subsampling=1),
    "pil_q75_444": lambda img: _pil_bytes(img, subsampling=0),
    "pil_gray": lambda img: _pil_bytes(img[..., 1]),
    "cv2_default": lambda img: _cv2_bytes(img),
    "cv2_restart_1": lambda img: _cv2_bytes(img, (cv2.IMWRITE_JPEG_RST_INTERVAL, 1)),
    "cv2_restart_3_q60": lambda img: _cv2_bytes(img, (cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
                                                      cv2.IMWRITE_JPEG_QUALITY, 60)),
    "cv2_422": lambda img: _cv2_bytes(img, (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
    "cv2_gray": lambda img: _cv2_bytes(img[..., 1]),
    "port_q75_420": lambda img: jpeg.encode_jpeg(img),
    "port_q95_444": lambda img: jpeg.encode_jpeg(img, 95, "4:4:4"),
    "port_q50_422": lambda img: jpeg.encode_jpeg(img, 50, "4:2:2"),
    "port_gray": lambda img: jpeg.encode_jpeg(img[..., 1]),
}


def _references(data):
    """(Pillow, cv2) decodes: (H, W, 3) RGB, or (H, W) for a gray file."""
    im = PIL.Image.open(io.BytesIO(data))
    gray = im.mode == "L"
    pil = np.asarray(exif_transpose(im))
    cv = cv2.imdecode(np.frombuffer(data, np.uint8),
                      cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return pil, (cv if gray else cv[..., ::-1])


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_decoder_bit_identical_to_cv2_and_pillow(writer, hw):
    img = frame_image(np.random.default_rng(hw[0] * 1000 + hw[1]), *hw)
    data = WRITERS[writer](img)
    pil, cv = _references(data)
    np.testing.assert_array_equal(cv, pil)               # one answer to match
    got = jpeg.decode_jpeg(data)
    assert got.shape == pil.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_exif_transpose_and_imread(tmp_path, orientation):
    img = frame_image(np.random.default_rng(7), 61, 97)
    exif = PIL.Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / "frame.jpg")
    PIL.Image.fromarray(img).save(path, exif=exif.tobytes())
    ref = np.asarray(exif_transpose(PIL.Image.open(path)).convert("RGB"))
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], ref)
    np.testing.assert_array_equal(read_rgb(path), ref)
    # read_l is PIL's convert("L"), without the transpose
    np.testing.assert_array_equal(read_l(path), np.asarray(PIL.Image.open(path).convert("L")))


def test_read_rgb_and_read_l_of_a_gray_file(tmp_path):
    path = str(tmp_path / "gray.jpg")
    PIL.Image.fromarray(frame_image(np.random.default_rng(3), 17, 33)[..., 0]).save(path)
    np.testing.assert_array_equal(read_rgb(path), np.asarray(PIL.Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(read_l(path), np.asarray(PIL.Image.open(path)))


def test_encoder_quality_and_tables(tmp_path):
    """Quality 95 stays within a mean of 2 levels of a smooth source; the file
    carries the standard tables scaled as Pillow scales them (q75: the same
    DQT and DHT segments Pillow writes)."""
    yy, xx = np.mgrid[0:288, 0:512]
    img = np.clip(np.stack([128 + 100 * np.sin(xx / (40 + 7 * c) + yy / 30) for c in range(3)],
                           -1), 0, 255).astype(np.uint8)
    path = str(tmp_path / "smooth.jpg")
    jpeg.write_jpeg(img, path, quality=95)
    assert np.abs(read_rgb(path).astype(int) - img).mean() <= 2

    def segments(data, marker):
        out, i = [], 2
        while data[i + 1] != 0xDA:
            n = int.from_bytes(data[i + 2:i + 4], "big")
            if data[i + 1] == marker:
                out.append(data[i + 4:i + 2 + n])
            i += 2 + n
        return b"".join(out)
    ours, pils = jpeg.encode_jpeg(img), _pil_bytes(img)
    for m in (0xDB, 0xC4, 0xC0):
        assert segments(ours, m) == segments(pils, m), hex(m)


def test_progressive_goes_to_pillow_or_names_its_sof(tmp_path):
    img = frame_image(np.random.default_rng(5), 61, 97)
    path = str(tmp_path / "progressive.jpg")
    PIL.Image.fromarray(img).save(path, progressive=True)
    with pytest.raises(jpeg.UnsupportedJPEG, match="0xC2"):
        jpeg.read_jpeg(path)
    np.testing.assert_array_equal(read_rgb(path), np.asarray(PIL.Image.open(path)))
    code = ("import sys\nsys.modules['PIL'] = sys.modules['cv2'] = None\n"
            "from align3r_tpu_torch.inference.images import read_rgb\n"
            "try:\n    read_rgb(sys.argv[1])\nexcept ImportError as e:\n    print(e)\n")
    res = subprocess.run([sys.executable, "-c", code, path], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert path in res.stdout and "SOF marker 0xC2" in res.stdout and "Pillow" in res.stdout


def test_failed_build_raises_with_compiler_messages(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int a3r_jpeg_header( { this is not C++\n")
    monkeypatch.setattr(jpeg, "SOURCE", src)
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="c\\+\\+ failed to build broken.cpp") as e:
        jpeg.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_builds_under_build_keyed_by_source():
    path, _ = jpeg.build()
    assert path.parent == jpeg.BUILD_DIR and path.exists()
    assert path.parent.parent.name == "build"
    assert path == jpeg.library_path() and path.name.startswith("libalign3r_jpeg-")
