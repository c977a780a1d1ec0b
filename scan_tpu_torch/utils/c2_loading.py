"""Detectron (Caffe2) ``.pkl`` weights for the ResNet body (counterpart of
``scan_tpu/utils/c2_loading.py``; reference
``fcos_core/utils/c2_model_loading.py``).

A Detectron ImageNet pickle (``R-101.pkl``, the ``catalog://`` weights of
the EPM R-101 configs) is a dict of numpy blobs, possibly under ``blobs``,
with ``_momentum`` entries to drop. Their names map onto the port's ResNet
as ``scan_tpu``'s ``convert_c2_resnet`` maps them onto its tree::

  conv1_w                      -> stem_conv1.weight
  res_conv1_bn_{s,b}           -> stem_bn1.{weight,bias}
  res{S}_{B}_branch2{a,b,c}_w  -> layer{S-1}_block{B}.conv{1,2,3}.weight
  res{S}_{B}_branch2{a,b,c}_bn_{s,b} -> ....bn{1,2,3}.{weight,bias}
  res{S}_{B}_branch1_w / _bn_{s,b}   -> ....downsample_conv / downsample_bn

Both sides are OIHW, so a conv needs no transpose (``scan_tpu`` transposes
to HWIO). The pickles fold each BatchNorm into a scale and a bias, so a
FrozenBatchNorm that gets them takes mean 0 and variance 1 (``fill_bn``,
``c2_loading.py:85-96``). Other blobs (the classifier, ``lr``,
``model_iter``) are not read, as in ``scan_tpu``.

The file is read by ``RestrictedUnpickler``, which admits numpy's array
reconstruction, ``_codecs.encode`` (how pickle protocol 2 stores bytes)
and a few builtin containers, and refuses any other global: the
``weights_only`` rule of the port's ``Checkpointer``, where ``scan_tpu``
calls bare ``pickle.load`` (``c2_loading.py:22-24``).
"""

import codecs
import pickle
import zipfile
from typing import Dict, Optional

import numpy as np


def _multiarray():
    try:
        from numpy._core import multiarray
    except ImportError:  # numpy < 2
        from numpy.core import multiarray
    return multiarray


def _numeric():
    try:
        from numpy._core import numeric
    except ImportError:  # numpy < 2
        from numpy.core import numeric
    return numeric


def _allowed_globals():
    ma = _multiarray()
    allowed = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype,
               ("_codecs", "encode"): codecs.encode,
               ("builtins", "set"): set, ("builtins", "frozenset"): frozenset,
               ("builtins", "bytearray"): bytearray,
               ("__builtin__", "set"): set,
               ("__builtin__", "frozenset"): frozenset}
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        allowed[(mod, "_reconstruct")] = ma._reconstruct
        allowed[(mod, "scalar")] = ma.scalar
    for mod in ("numpy.core.numeric", "numpy._core.numeric"):
        allowed[(mod, "_frombuffer")] = _numeric()._frombuffer  # protocol 5
    return allowed


class RestrictedUnpickler(pickle.Unpickler):
    """An unpickler for numpy arrays in plain containers; any other global
    raises ``pickle.UnpicklingError``."""

    _ALLOWED = None

    def find_class(self, module, name):
        if RestrictedUnpickler._ALLOWED is None:
            RestrictedUnpickler._ALLOWED = _allowed_globals()
        try:
            return RestrictedUnpickler._ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"refusing to load the global {module}.{name} from a weight "
                "pickle: only numpy arrays in plain containers are read"
            ) from None


def _is_c2_name(name) -> bool:
    return isinstance(name, str) and (
        name in ("conv1_w", "res_conv1_bn_s", "res_conv1_bn_b")
        or (name.startswith("res") and "_branch" in name))


def load_c2_pickle(path: str) -> Optional[Dict[str, np.ndarray]]:
    """The blobs of a Detectron pickle, ``_momentum`` entries dropped; None
    when ``path`` holds something else (a torch file, whose first pickled
    object is not such a dict). A pickle naming a global other than
    numpy's array reconstruction raises ``pickle.UnpicklingError``."""
    if zipfile.is_zipfile(path):
        return None  # torch's file format
    with open(path, "rb") as f:
        try:
            data = RestrictedUnpickler(f, encoding="latin1").load()
        except pickle.UnpicklingError as e:
            if "refusing" in str(e):
                raise
            return None
        except (EOFError, ValueError, TypeError, IndexError, KeyError):
            return None
    if not isinstance(data, dict):
        return None
    if isinstance(data.get("blobs"), dict):
        data = data["blobs"]
    if not any(_is_c2_name(k) for k in data):
        return None
    return {k: np.asarray(v) for k, v in data.items()
            if isinstance(k, str) and not k.endswith("_momentum")}


_BRANCH2 = {"a": ("conv1", "bn1"), "b": ("conv2", "bn2"), "c": ("conv3", "bn3")}


def c2_name_to_port(name: str) -> Optional[str]:
    """A Detectron blob name -> the ResNet body's state-dict key, or None
    for a blob ``scan_tpu``'s converter does not read."""
    if name == "conv1_w":
        return "stem_conv1.weight"
    if name in ("res_conv1_bn_s", "res_conv1_bn_b"):
        return "stem_bn1." + ("weight" if name.endswith("_s") else "bias")
    if not (name.startswith("res") and "_branch" in name):
        return None
    head, branch = name.split("_branch")  # branch: 1_w, 2a_bn_s, ...
    block = f"layer{int(head[3]) - 1}_block{int(head.split('_')[1])}"
    if branch[:1] == "1":
        (conv, bn), rest = ("downsample_conv", "downsample_bn"), branch[1:]
    elif branch[:1] == "2" and branch[1:2] in _BRANCH2:
        (conv, bn), rest = _BRANCH2[branch[1]], branch[2:]
    else:
        return None
    return {"_w": f"{block}.{conv}.weight", "_bn_s": f"{block}.{bn}.weight",
            "_bn_b": f"{block}.{bn}.bias"}.get(rest)


def convert_c2_resnet(blobs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Detectron blobs -> the ResNet body's state-dict entries (float32
    numpy), with mean 0 and variance 1 for every FrozenBatchNorm whose
    scale the file gives."""
    out = {}
    for name, v in blobs.items():
        key = c2_name_to_port(name)
        if key is not None:
            out[key] = np.asarray(v, np.float32)
    for key in list(out):
        module, leaf = key.rsplit(".", 1)
        if leaf == "weight" and "bn" in module.rsplit(".", 1)[-1]:
            c = out[key].shape[0]
            out[module + ".running_mean"] = np.zeros(c, np.float32)
            out[module + ".running_var"] = np.ones(c, np.float32)
    return out
