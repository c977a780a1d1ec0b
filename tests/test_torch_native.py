"""The port's native library (``scan_tpu_torch/native``), on the CPU.

* Its PNG/JPEG decode against Pillow (PNG: equal; JPEG: the same libjpeg
  family, equal here) and against ``scan_tpu.native`` on the same bytes:
  equal byte for byte. Its uint8 resize and fused resize+normalise against
  PIL's bilinear resize and against ``scan_tpu.native``: equal byte for
  byte, down- and upscaling.
* The build: the library's name changes with the source, the flags and the
  host; a source that does not compile raises with g++'s message; builds
  started at once all land on one library.
* ``SCAN_TPU_NO_NATIVE=1`` switches the library off and the loader's
  resize and decode to Pillow.
"""

import io
import threading

import numpy as np
import pytest
from PIL import Image

import scan_tpu.native as jax_native
from scan_tpu_torch import native
from scan_tpu_torch.data import transforms
from scan_tpu_torch.data.datasets import coco

SHAPES = [((80, 100), (56, 70)), ((97, 131), (200, 262)),
          ((1024, 2048), (666, 1332)), ((64, 48), (64, 48))]


def noise(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def encoded(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **(
        {"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_decode_matches_pillow_and_scan_tpu(fmt):
    assert native.has_codecs()
    arr = noise(61, 83, 0)
    data = encoded(arr, fmt)
    got = native.decode_image(data)
    np.testing.assert_array_equal(got, jax_native.decode_image(data))
    np.testing.assert_array_equal(got, coco.pil_decode(data))
    if fmt == "PNG":
        np.testing.assert_array_equal(got, arr)
    assert native.decode_image(b"GIF89a not a png") is None
    with pytest.raises(ValueError):
        native.decode_image(data[:40])


@pytest.mark.parametrize("src_hw,out_hw", SHAPES)
def test_resize_u8_matches_pil_and_scan_tpu(src_hw, out_hw):
    src = noise(*src_hw, seed=1)
    oh, ow = out_hw
    got = np.zeros((oh + 5, ow + 7, 3), np.uint8)
    want = np.zeros_like(got)
    native.resize_image_u8(src, got, oh, ow)
    assert jax_native.resize_image_u8(src, want, oh, ow)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:oh, :ow],
                                  transforms.pil_resize(src, oh, ow))
    assert not got[oh:].any() and not got[:, ow:].any()


@pytest.mark.parametrize("to_bgr255", [True, False])
def test_preprocess_matches_scan_tpu(to_bgr255):
    src = noise(97, 131, 2)
    mean, std = [102.98, 115.95, 122.77], [1.0, 2.0, 0.5]
    got = np.zeros((96, 128, 3), np.float32)
    want = np.zeros_like(got)
    native.preprocess_image(src, got, 70, 95, mean, std, to_bgr255)
    assert jax_native.preprocess_image(src, want, 70, 95, mean, std,
                                       to_bgr255)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):  # larger than its buffer
        native.preprocess_image(src, got, 97, 131, mean, std, to_bgr255)
    with pytest.raises(ValueError):  # not a float32 buffer
        native.preprocess_image(src, want.astype(np.float64), 70, 95, mean,
                                std, to_bgr255)
    with pytest.raises(ValueError):  # not contiguous
        native.resize_image_u8(src, np.zeros((96, 256, 3), np.uint8)[:, ::2],
                               70, 95)


def test_build_key_changes_with_source_flags_and_host():
    src = native.SRC.read_bytes()
    flags = native.CXX_FLAGS + native.CODEC_FLAGS + native.CODEC_LIBS
    host = native.host_id()
    base = native.library_path(src, flags, host)
    assert native.get_lib().path == native.target()[0] == base  # codecs here
    assert native.library_path(src + b"\n", flags, host) != base
    assert native.library_path(src, native.CXX_FLAGS, host) != base
    assert native.library_path(src, flags, host + "x") != base
    assert base.parent == native.BUILD_DIR


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build(bad)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_concurrent_builds_land_on_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]


def test_no_native_selects_pillow(tmp_path, monkeypatch):
    monkeypatch.setenv("SCAN_TPU_NO_NATIVE", "1")
    assert not native.enabled()
    with pytest.raises(RuntimeError, match="SCAN_TPU_NO_NATIVE"):
        native.get_lib()
    calls = []
    for mod, name in ((transforms, "pil_resize"), (coco, "pil_decode")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    arr = noise(40, 50, 4)
    path = tmp_path / "x.png"
    path.write_bytes(encoded(arr, "PNG"))
    np.testing.assert_array_equal(coco._load_rgb(str(path)), arr)
    pre = transforms.Preprocessor([30], 100, [0, 0, 0], [1, 1, 1])
    out = np.zeros((32, 64, 3), np.uint8)
    pre.into_buffer_u8(arr, None, out)
    np.testing.assert_array_equal(out[:30, :37],
                                  transforms.pil_resize(arr, 30, 37))
    assert calls == ["pil_decode", "pil_resize", "pil_resize"]
