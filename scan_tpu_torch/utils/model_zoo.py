"""Weight URLs resolved to a local cache (counterpart of the cache half of
``scan_tpu/utils/model_zoo.py``; reference ``fcos_core/utils/model_zoo.py``).

An ``http(s)`` ``MODEL.WEIGHT`` (the ImageNet VGG16 of the configs) names a
file in the cache directory: ``$SCAN_TPU_CACHE_DIR`` > ``$TORCH_MODEL_ZOO``
> ``$TORCH_HOME/models`` > ``~/.torch/models``, under the URL's file name
(Detectron's all-identical ``model_final.pkl`` names flattened from the
URL's path). A URL whose file is in the cache resolves to that file. The
port fetches nothing: a URL whose file is missing raises, and the error
names the path where the file should be put. This is the part of
``scan_tpu``'s behaviour that needs no network; its ``_download`` is not
ported, and nothing here creates a directory.

A ``catalog://`` name (``catalog://ImageNetPretrained/MSRA/R-101``) resolves
through ``config/paths_catalog.py::ModelCatalog`` to its Detectron URL, and
that URL to its file in the cache, as above (``R-101.pkl``). Such a file is
a Detectron pickle, which ``utils/c2_loading.py`` reads.
"""

import logging
import os
from urllib.parse import urlparse

logger = logging.getLogger("scan_tpu_torch.model_zoo")


def default_cache_dir() -> str:
    for var in ("SCAN_TPU_CACHE_DIR", "TORCH_MODEL_ZOO"):
        d = os.environ.get(var)
        if d:
            return d
    torch_home = os.path.expanduser(os.environ.get("TORCH_HOME", "~/.torch"))
    return os.path.join(torch_home, "models")


def url_to_filename(url: str) -> str:
    parts = urlparse(url)
    if parts.fragment:
        return parts.fragment
    filename = os.path.basename(parts.path)
    if filename == "model_final.pkl":
        # Detectron's pre-trained files all share this name; the full path
        # is the cache key (reference model_zoo.py:46-50)
        filename = parts.path.replace("/", "_")
    return filename


def is_uri(f: str) -> bool:
    return f.startswith(("catalog://", "http://", "https://"))


def resolve_weight_uri(f: str, model_dir: str = None) -> str:
    """A ``catalog://`` or ``http(s)://`` weight name -> its local file.
    Other names pass unchanged. Raises for a URL (a catalog name's too)
    whose file is not in the cache."""
    name = f
    if f.startswith("catalog://"):
        from ..config.paths_catalog import ModelCatalog

        f = ModelCatalog.get(f[len("catalog://"):])
        name = f"{name} ({f})"
    if not f.startswith(("http://", "https://")):
        return f
    from ..parallel.mesh import is_main_process, synchronize

    model_dir = model_dir or default_cache_dir()
    cached = os.path.join(model_dir, url_to_filename(f))
    if is_main_process():
        logger.info("%s -> %s (in the cache: %s)", name, cached,
                    os.path.isfile(cached))
    # the ranks meet here, as scan_tpu's cache_url does after the main
    # process's download; then each one that finds no file raises
    synchronize()
    if not os.path.isfile(cached):
        raise ValueError(
            f"{name} is not in the weight cache and scan_tpu_torch fetches "
            f"nothing: put the file at {cached} (the cache directory is "
            "$SCAN_TPU_CACHE_DIR, else $TORCH_MODEL_ZOO, else "
            "$TORCH_HOME/models, else ~/.torch/models)")
    return cached
