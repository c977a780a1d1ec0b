"""Debug visualisation utilities (counterpart of
``scan_tpu/utils/vis_tools.py``).

Parity target: reference ``fcos_core/vis_tools.py`` (``VIS_TOOLS``): dump
feature tensors, draw per-class activation / centerness maps, and t-SNE of
the semantic prototypes. Takes tensors (on any device) or arrays; maps are
NHWC, as the port's public functions return them. ``matplotlib`` and
``sklearn`` are imported only when a drawing is asked for.
"""

import os
from typing import Optional, Sequence

import numpy as np
import torch


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


class VisTools:
    def __init__(self, out_dir: str = "debug_vis"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def save_feat(self, tensors, tag: str = "feat"):
        """Dump tensors (or lists of tensors) as .npy files."""
        if not isinstance(tensors, (list, tuple)):
            tensors = [tensors]
        for i, t in enumerate(tensors):
            np.save(os.path.join(self.out_dir, f"{tag}_{i}.npy"), _numpy(t))

    def draw_maps(self, maps, level: int, name: str = "activation"):
        """Per-channel heatmaps of an NHWC map (reference debug_draw_maps)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        arr = _numpy(maps)
        if arr.ndim == 4:
            arr = arr[0]
        c = arr.shape[-1]
        cols = min(c, 5)
        rows = (c + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
        axes = np.atleast_1d(axes).reshape(-1)
        for ch in range(c):
            axes[ch].imshow(arr[..., ch], cmap="viridis")
            axes[ch].set_title(f"{name} c{ch}")
            axes[ch].axis("off")
        for ch in range(c, len(axes)):
            axes[ch].axis("off")
        path = os.path.join(self.out_dir, f"{name}_P{level + 3}.png")
        fig.savefig(path, bbox_inches="tight", dpi=80)
        plt.close(fig)
        return path

    def tsne_prototypes(self, prototype,
                        labels: Optional[Sequence[str]] = None,
                        name: str = "prototype_tsne"):
        """2-D t-SNE of the (C, ch[, ITER]) prototype buffer."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE

        p = _numpy(prototype)
        if p.ndim == 3:
            p = p.transpose(0, 2, 1).reshape(-1, p.shape[1])
        n = p.shape[0]
        emb = TSNE(
            n_components=2, perplexity=min(5, max(2, n - 1)), init="pca",
            random_state=0,
        ).fit_transform(p)
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(emb[:, 0], emb[:, 1], c=np.arange(n) % 10, cmap="tab10")
        if labels:
            for i, label in enumerate(labels[: len(emb)]):
                ax.annotate(label, emb[i])
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(path, bbox_inches="tight", dpi=80)
        plt.close(fig)
        return path


VIS_TOOLS = VisTools
