"""Build and load the port's CUDA kernels.

Each ``scan_tpu_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o build/scan_tpu_torch/<name>-<hash>.so <name>.cu

No PyTorch headers are included, so a build takes seconds. Libraries go to
``build/scan_tpu_torch/`` beside the package (listed in ``.gitignore``), keyed
by a hash of the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited source or header rebuilds.
``--fmad=false`` keeps nvcc from contracting ``a*b + c`` into an FMA: the NMS
kernel's IoU and the int8 kernels' dequant epilogues must round exactly as
the plain PyTorch versions do. Kernels that want an FMA write ``__fmaf_rn``. Division stays IEEE (no fast math). Nothing
here runs at import; the first launch builds, and ``build_all`` builds every
source at once, one ``nvcc`` each, all started together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "scan_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("nms", "stem", "phase_max", "pair_phase_max", "conv0", "stem_int8",
           "group_norm", "bias_relu")

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    """The library's path, keyed by its source, every ``csrc/*.cuh`` header
    (any source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (out, tmp), proc


def _finish(name: str, target, proc) -> str:
    """Wait for nvcc; returns its output (register and spill report)."""
    if proc is None:
        return ""
    out, tmp = target
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Compile every source in parallel; returns name -> nvcc log."""
    with _lock:
        started = {n: _start(n) for n in SOURCES if n not in _libs}
        return {n: _finish(n, *started[n]) for n in started}


def dump_sass(name: str) -> str:
    """``cuobjdump --dump-sass`` of the built library for ``csrc/<name>.cu``
    (built first if needed): the instructions the card runs."""
    load(name)
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "--dump-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, proc = _start(name)
            _finish(name, target, proc)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
