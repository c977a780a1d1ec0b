"""Strip the solver state from a checkpoint, keeping the model (counterpart
of ``tools/remove_solver_states.py``; reference
``tools/remove_solver_states.py``).

    python -m scan_tpu_torch.tools.remove_solver_states <ckpt or dir> <out>

Reads a port checkpoint, or the file that a directory's
``last_checkpoint`` names, drops its ``optimizer`` and ``scheduler``
entries, keeps the rest (the model and the iteration), and writes the
result atomically to ``<out>``: a temporary file renamed into place, as
``Checkpointer.save`` writes. The slim file starts a new run from these
weights without the old run's momentum and schedule (the EPM CA configs'
``MODEL.WEIGHT: ./model_GA.pth``), or evaluates with ``test_net``.
"""

import argparse
import os

SOLVER_KEYS = ("optimizer", "scheduler")


def source_file(src: str) -> str:
    """``src`` itself, or for a directory the file its pointer names."""
    if not os.path.isdir(src):
        return src
    pointer = os.path.join(src, "last_checkpoint")
    if not os.path.exists(pointer):
        raise FileNotFoundError(f"{src} is a directory without a "
                                "last_checkpoint pointer")
    with open(pointer) as f:
        return f.read().strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("src", help="a port checkpoint, or a directory "
                                    "with a last_checkpoint pointer")
    parser.add_argument("dst", help="the slim checkpoint to write")
    args = parser.parse_args(argv)

    import torch

    path = source_file(args.src)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or "model" not in state:
        raise ValueError(f"{path} is not a scan_tpu_torch checkpoint (no "
                         "'model' entry)")
    slim = {k: v for k, v in state.items() if k not in SOLVER_KEYS}
    dst = os.path.abspath(args.dst)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    torch.save(slim, tmp)
    os.replace(tmp, dst)
    dropped = sorted(set(state) - set(slim))
    print(f"wrote {dst} from {path} (dropped {dropped}); keys: "
          f"{sorted(slim)}", flush=True)
    return dst


if __name__ == "__main__":
    main()
