"""Native (C++) host-side runtime for the port's loader, bound via ctypes;
a copy of ``scan_tpu/native``, built apart from it.

``preprocess.cpp`` builds with ``g++`` at first use, never at import, into
``build/scan_tpu_torch/native/`` beside the package (listed in
``.gitignore``)::

    g++ -O3 -march=native -shared -fPIC -std=c++17 [-DSCAN_NATIVE_CODECS]
        preprocess.cpp -o libscan_native-<key>.so [-lpng -ljpeg -lz]

The key hashes the source, the flags and the host's CPU (``host_id``): a
``-march=native`` library built on one machine is never loaded on another
that shares the directory. A build writes a temporary file and renames it
into place, so processes that build at once do not see a torn library.

The PNG/JPEG decoders need libpng's and libjpeg's headers; the build
defines ``SCAN_NATIVE_CODECS`` only where the compiler finds them. Without
them ``decode_image`` returns None and the datasets decode with Pillow
(``has_codecs`` says which). A failed build or load raises with the
compiler's output; ``SCAN_TPU_NO_NATIVE=1`` is the only way to the Pillow
paths of resize and decode. Exposes:

  * preprocess_image: fused resize + BGR255 normalize + pad (loader hot path)
  * resize_image_u8:  PIL-exact resize into a padded uint8 buffer
  * decode_image:     PNG/JPEG bytes -> RGB uint8, the GIL released
"""

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("scan_tpu_torch.native")

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "scan_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
CODEC_FLAGS = ("-DSCAN_NATIVE_CODECS",)
CODEC_LIBS = ("-lpng", "-ljpeg", "-lz")
_CODEC_PROBE = "#include <cstdio>\n#include <png.h>\n#include <jpeglib.h>\n"
_CPU_FIELDS = ("vendor_id", "cpu family", "model", "model name", "flags")

_lock = threading.Lock()
_lib = None


def enabled() -> bool:
    """False when ``SCAN_TPU_NO_NATIVE=1`` asks for the Pillow paths."""
    return os.environ.get("SCAN_TPU_NO_NATIVE") != "1"


def host_id() -> str:
    """The CPU that ``-march=native`` compiles for: the machine and the
    first processor's vendor, family, model and feature flags."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                if key.strip() in _CPU_FIELDS:
                    fields[key.strip()] = value.strip()
    except OSError:
        pass
    return "|".join([platform.machine()] + [f"{k}={fields[k]}" for k in
                                            sorted(fields)])


def library_path(source: bytes, flags, host: str) -> Path:
    """Where the library built from ``source`` with ``flags`` (compile and
    link) for ``host`` lives."""
    h = hashlib.sha256(source)
    h.update("\0".join(flags).encode())
    h.update(b"\0" + host.encode())
    return BUILD_DIR / f"libscan_native-{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: set CXX or put g++ on PATH")
    return cxx


def target(src: Path = SRC):
    """(library path, compile flags, link flags) of ``src`` on this host:
    with the codecs where the compiler finds their headers."""
    probe = subprocess.run([_cxx(), "-x", "c++", "-fsyntax-only", "-"],
                           input=_CODEC_PROBE, capture_output=True, text=True)
    flags, libs = CXX_FLAGS, ()
    if probe.returncode == 0:
        flags, libs = CXX_FLAGS + CODEC_FLAGS, CODEC_LIBS
    return library_path(src.read_bytes(), flags + libs, host_id()), flags, libs


def build(src: Path = SRC) -> Path:
    """Build ``src`` for this host unless its library exists; returns the
    library's path. Raises with the compiler's output on failure."""
    out, flags, libs = target(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_cxx(), *flags, str(src), "-o", str(tmp), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    logger.info("built %s", out)
    return out


def _bind(lib):
    lib.preprocess_image.restype = ctypes.c_int
    lib.preprocess_image.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.resize_image_u8.restype = ctypes.c_int
    lib.resize_image_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.has_codecs.restype = ctypes.c_int
    lib.has_codecs.argtypes = []
    return lib


def get_lib():
    """The loaded library, built first if needed. Raises when it cannot be
    built or loaded, or when ``SCAN_TPU_NO_NATIVE=1`` switched it off."""
    global _lib
    if not enabled():
        raise RuntimeError("the native library is off (SCAN_TPU_NO_NATIVE=1)")
    with _lock:
        if _lib is None:
            path = build(SRC)
            _lib = _bind(ctypes.CDLL(str(path)))
            _lib.path = path
            logger.info("native library loaded: %s (codecs: %s)", path,
                        bool(_lib.has_codecs()))
        return _lib


def has_codecs() -> bool:
    """True when the library decodes PNG and JPEG itself."""
    return bool(get_lib().has_codecs())


def _check(src: np.ndarray, out: np.ndarray, dtype) -> np.ndarray:
    """``src`` as a contiguous (h, w, 3) uint8 array; ``out`` must be a
    contiguous (H, W, 3) buffer of ``dtype``, which the library writes."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"expected an (h, w, 3) image, got {src.shape}")
    if (out.dtype != dtype or not out.flags.c_contiguous or out.ndim != 3
            or out.shape[2] != 3):
        raise ValueError(f"expected a contiguous (H, W, 3) {np.dtype(dtype)} "
                         f"buffer, got {out.dtype} {out.shape}")
    return src


def preprocess_image(src: np.ndarray, out: np.ndarray, oh: int, ow: int,
                     mean, std, to_bgr255: bool) -> None:
    """Fused resize+normalize into the padded float32 ``out`` buffer."""
    lib = get_lib()
    src = _check(src, out, np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    ih, iw = src.shape[:2]
    dh, dw = out.shape[:2]
    rc = lib.preprocess_image(
        src.ctypes.data, ih, iw, out.ctypes.data, dh, dw, oh, ow,
        mean.ctypes.data, std.ctypes.data, int(to_bgr255),
    )
    if rc != 0:
        raise ValueError(f"preprocess_image: ({ih}, {iw}) -> ({oh}, {ow}) "
                         f"does not fit ({dh}, {dw})")


def resize_image_u8(src: np.ndarray, out: np.ndarray, oh: int, ow: int) -> None:
    """PIL-equivalent resize into the padded uint8 ``out`` buffer."""
    lib = get_lib()
    src = _check(src, out, np.uint8)
    ih, iw = src.shape[:2]
    dh, dw = out.shape[:2]
    rc = lib.resize_image_u8(
        src.ctypes.data, ih, iw, out.ctypes.data, dh, dw, oh, ow
    )
    if rc != 0:
        raise ValueError(f"resize_image_u8: ({ih}, {iw}) -> ({oh}, {ow}) "
                         f"does not fit ({dh}, {dw})")


def decode_image(data: bytes):
    """PNG/JPEG bytes -> an (h, w, 3) RGB uint8 array, decoded with the GIL
    released (PIL's PNG decode holds it ~50-100 ms per 2MP frame,
    serialising loader threads). None when the library has no codecs or
    the format is neither PNG nor JPEG; raises on corrupt data."""
    lib = get_lib()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.decode_image(data, len(data), None, ctypes.byref(h),
                          ctypes.byref(w), 1)
    if rc in (2, 3):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8) if rc == 0 else None
    if rc == 0:
        rc = lib.decode_image(data, len(data), out.ctypes.data,
                              ctypes.byref(h), ctypes.byref(w), 0)
    if rc != 0:
        raise ValueError(f"decode_image: corrupt image data (code {rc})")
    return out
