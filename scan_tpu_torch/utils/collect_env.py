"""Environment report logged at startup (counterpart of
``scan_tpu/utils/collect_env.py``; reference ``fcos_core/utils/collect_env.py:1-14``).

Python, torch and its CUDA, ``nvcc``, and each card's name and power limit
as ``nvidia-smi`` reports them, plus numpy's and Pillow's versions.
"""

import platform
import shutil
import subprocess
import sys


def _ver(mod_name: str) -> str:
    try:
        mod = __import__(mod_name)
        return getattr(mod, "__version__", "unknown")
    except Exception:
        return "not installed"


def _run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return out.stdout.strip() if out.returncode == 0 else "unavailable"


def collect_env_info() -> str:
    import torch

    from ..ops.cuda.build import _nvcc

    try:
        nvcc = _run([_nvcc(), "--version"]).splitlines()[-1]
    except RuntimeError as e:
        nvcc = str(e)
    lines = [
        f"sys.platform: {sys.platform}",
        f"Python: {sys.version.replace(chr(10), ' ')}",
        f"machine: {platform.machine()}",
        f"torch: {torch.__version__} (CUDA {torch.version.cuda})",
        f"CUDA available: {torch.cuda.is_available()}",
        f"nvcc: {nvcc}",
    ]
    if shutil.which("nvidia-smi"):
        cards = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"])
        lines.append("cards (name, power limit): " + "; ".join(cards.splitlines()))
    for mod in ("numpy", "PIL"):
        lines.append(f"{mod}: {_ver(mod)}")
    return "\n".join(lines)
