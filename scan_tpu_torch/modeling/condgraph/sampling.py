"""Graph-node sampling for the condgraph middle head (counterpart of
``scan_tpu/modeling/condgraph/sampling.py``; reference
``rpn/fcos/loss.py:239-527``, ``PrototypeComputation``).

* Source: FCOS point labelling over the middle-head features; every
  positive point becomes a node, plus as many background points picked
  evenly along the flattened negatives (``loss.py:437-458``).
* Target: candidate (location, class) pairs from the activation maps
  (``dbscan``, ``score_threshold``, ``kmeans``, ``mean_shift``), pseudo-labels
  from the argmax over the foreground channels, the same balanced
  background.

Everything is fixed-capacity and stays on the device, as in ``scan_tpu``:
node sets are ``TPU.MAX_NODES`` rows with a validity mask, candidates are
the top ``TPU.MAX_TARGET_POINTS`` per level, and the reference's sklearn
DBSCAN is the fixed-iteration density clustering of
``density_cluster_drop_first``. There is no ``.item()``, ``nonzero()`` or
boolean-mask indexing, and a scalar index is an ``index_select``, so no
value goes back to the host.

Orders follow ``scan_tpu``'s: ``jnp.argsort`` is stable, so is the sort
here; ``torch.topk`` may order the ``-1.0`` ties of invalid candidates
differently from ``lax.top_k``, which changes nothing (invalid rows are
zeroed, never kept, and add 0 to ``conf_pos``).
"""

import torch

from ..fcos.targets import compute_targets, expand_soi


def _even_subset_mask(select_from, want):
    """The membership set of the reference's balanced background choice
    ``np.floor(np.linspace(0, n - 2, want))`` over the True entries of
    ``select_from``, ranked in flat order (``sampling.py:31-61``), in
    integer arithmetic."""
    sel = select_from.long()
    n = sel.sum()
    rank = torch.cumsum(sel, 0) - 1
    want = want.long()
    m = torch.clamp_min(n - 2, 1)
    km1 = torch.clamp_min(want - 1, 1)
    r = torch.clamp_min(rank, 0)
    lo = torch.div(r * km1 + m - 1, m, rounding_mode="floor")
    hi = torch.div((r + 1) * km1 - 1, m, rounding_mode="floor")
    hit = (lo <= hi) & (lo <= km1)
    hit = torch.where((n > 2) & (want >= 2), hit, rank == 0)
    hit = hit | (want >= n)  # all negatives when positives outnumber them
    hit = hit & (want >= 1)
    return select_from & hit & (rank >= 0)


def gather_nodes(features_flat, labels_flat, select, max_nodes: int):
    """Selected rows into a fixed (max_nodes, C) buffer: all selected
    background rows first, then all selected foreground rows, each in flat
    order (reference ``cat([neg_points, pos_points])``, ``loss.py:462-466``;
    the MHA's raw-view head split makes the order matter). Returns (nodes,
    node_labels, node_valid)."""
    n = select.shape[0]
    idx_all = torch.arange(n, device=select.device)
    key = torch.where(select, (labels_flat > 0).long() * n + idx_all,
                      2 * n + idx_all)
    idx = torch.argsort(key, stable=True)[:max_nodes]
    node_valid = select[idx]
    nodes = features_flat[idx] * node_valid[:, None].to(features_flat.dtype)
    node_labels = torch.where(node_valid, labels_flat[idx],
                              torch.zeros_like(labels_flat[idx]))
    return nodes, node_labels, node_valid


def sample_source_nodes(locations, features, gt_boxes, gt_labels, gt_mask,
                        max_nodes: int, with_bg: bool = True):
    """Returns (nodes, node_labels, node_valid, act_labels_per_level); the
    per-level labels feed the act-map loss (``sampling.py:94-145``)."""
    num_points = [loc.shape[0] for loc in locations]
    locs_all = torch.cat(locations, dim=0)
    soi = expand_soi(num_points, device=locs_all.device)
    labels, _ = compute_targets(locs_all, soi, gt_boxes, gt_labels, gt_mask)
    act_labels = list(torch.split(labels, num_points, dim=1))

    selects, feats_flat, labels_flat = [], [], []
    for f, lab in zip(features, act_labels):
        ll = lab.reshape(-1)
        pos = ll > 0
        if with_bg:
            sel = pos | _even_subset_mask(~pos, pos.sum())
        else:
            sel = pos
        selects.append(sel)
        feats_flat.append(f.reshape(-1, f.shape[-1]))
        labels_flat.append(ll)
    nodes, node_labels, node_valid = gather_nodes(
        torch.cat(feats_flat), torch.cat(labels_flat), torch.cat(selects),
        max_nodes)
    return nodes, node_labels, node_valid, act_labels


def density_cluster_drop_first(points, valid, eps: float, min_samples: int = 5,
                               num_prop_iters: int = 16):
    """On-device DBSCAN as the reference uses it (``sampling.py:148-196``):
    connected components over the eps-graph through core points, a
    component's id its lowest member index; noise is kept and so is every
    component but the one holding the lowest-indexed core point. The
    squared distances are |a|^2 + |b|^2 - 2ab in float32, as in
    ``scan_tpu``. Returns the keep mask (K,)."""
    k = points.shape[0]
    sq = (points * points).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (points @ points.t())
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    core = valid & (adj.sum(dim=1) >= min_samples)
    prop_adj = adj & core[None, :]  # labels come only from core points
    idx = torch.arange(k, device=points.device)
    fill = torch.full_like(idx, k)
    comp = torch.where(valid, idx, fill)
    for _ in range(num_prop_iters):
        best = torch.where(prop_adj, comp[None, :], fill[None, :]).amin(dim=1)
        comp = torch.where(valid, torch.minimum(comp, best), fill)
    first_core_comp = torch.where(core, comp, fill).amin()
    noise = valid & ~core & ~(adj & core[None, :]).any(dim=1)
    in_first = (comp == first_core_comp) & ~noise
    keep = valid & (noise | ~in_first)
    # with no core point everything is noise: all kept
    return torch.where(core.any(), keep, valid)


def _row(points, i):
    """points[i] for a device scalar i, without reading i on the host."""
    return torch.index_select(points, 0, i.reshape(1))[0]


def kmeans2_minority(points, valid, iters: int = 8):
    """Fixed-iteration 2-means over the candidates; keep the smaller
    cluster (``sampling.py:199-228``; reference ``KMEANS_batch_ClS_FEAT``)."""
    c0 = _row(points, torch.argmax(valid.int()))  # first valid point
    norms = torch.where(valid, (points * points).sum(dim=1),
                        torch.full_like(points[:, 0], -1.0))
    c1 = _row(points, torch.argmax(norms))  # farthest-energy point

    def assign(c0, c1):
        d0 = ((points - c0) ** 2).sum(dim=1)
        d1 = ((points - c1) ** 2).sum(dim=1)
        return (d1 < d0) & valid

    for _ in range(iters):
        in1 = assign(c0, c1)
        w1 = in1.to(points.dtype)
        w0 = (valid & ~in1).to(points.dtype)
        c0 = (w0 @ points) / w0.sum().clamp_min(1.0)
        c1 = (w1 @ points) / w1.sum().clamp_min(1.0)
    in1 = assign(c0, c1)
    n1 = in1.sum()
    n0 = (valid & ~in1).sum()
    return torch.where(n1 <= n0, in1, valid & ~in1)


def meanshift_high_mode(scores, valid, bandwidth: float = 0.1,
                        iters: int = 10):
    """Fixed-iteration 1-D mean shift over activation scores; keep the
    points whose mode exceeds the valid mean (``sampling.py:231-246``)."""
    vf = valid.to(scores.dtype)
    x = torch.where(valid, scores, torch.zeros_like(scores))
    y = x
    for _ in range(iters):
        w = torch.exp(-0.5 * ((y[:, None] - x[None, :]) / bandwidth) ** 2)
        w = w * vf[None, :]
        y = (w @ x) / w.sum(dim=1).clamp_min(1e-8)
    mean_all = x.sum() / vf.sum().clamp_min(1.0)
    return valid & (y > mean_all)


def _scatter_keep(n_loc, loc_idx, keep):
    """Locations with at least one kept candidate (``.at[].add`` > 0)."""
    hits = torch.zeros(n_loc, dtype=torch.int32, device=keep.device)
    return hits.index_add_(0, loc_idx, keep.to(torch.int32)) > 0


def sample_target_nodes(features, act_maps, max_nodes: int,
                        sampling_cfg: str = "dbscan",
                        score_threshold: float = 0.5, dbscan_eps: float = 3.0,
                        dbscan_thr: float = 0.05,
                        max_candidates_per_level: int = 512):
    """Target-domain node sampling from the activation maps
    (``sampling.py:249-350``). Returns (nodes, node_labels, node_valid,
    any_nodes); pseudo-labels are the argmax over the foreground channels
    plus 1, background samples get 0."""
    selects, feats_flat, plabels_flat = [], [], []
    for f, act in zip(features, act_maps):
        ff = f.reshape(-1, f.shape[-1])
        fg = act.reshape(-1, act.shape[-1])[:, 1:]
        n_loc = ff.shape[0]
        cand_score = fg.t().reshape(-1)  # class-major, like the reference
        if sampling_cfg == "score_threshold":
            conf_pos = (fg > score_threshold).any(dim=-1)
        elif sampling_cfg in ("dbscan", "kmeans"):
            thr = dbscan_thr if sampling_cfg == "dbscan" else 0.5
            k = min(max_candidates_per_level, cand_score.shape[0])
            top_scores, top_idx = torch.topk(
                torch.where(cand_score > thr, cand_score,
                            torch.full_like(cand_score, -1.0)), k)
            cand_valid = top_scores > 0
            loc_idx = top_idx % n_loc
            pts = ff[loc_idx] * top_scores[:, None]
            pts = pts * cand_valid[:, None].to(pts.dtype)
            if sampling_cfg == "dbscan":
                keep = density_cluster_drop_first(pts, cand_valid, dbscan_eps)
            else:
                keep = kmeans2_minority(pts, cand_valid)
            conf_pos = _scatter_keep(n_loc, loc_idx, keep)
        elif sampling_cfg == "mean_shift":
            k = min(max_candidates_per_level * 2, cand_score.shape[0])
            top_scores, top_idx = torch.topk(cand_score, k)
            keep = meanshift_high_mode(top_scores, top_scores > 1e-4)
            conf_pos = _scatter_keep(n_loc, top_idx % n_loc, keep)
        else:
            raise KeyError(f"unsupported TARGET_SAMPLING_CFG: {sampling_cfg}")

        neg = _even_subset_mask(~conf_pos, conf_pos.sum())
        selects.append(conf_pos | neg)
        feats_flat.append(ff)
        plabel = torch.argmax(fg, dim=-1).to(torch.int32) + 1
        plabels_flat.append(torch.where(conf_pos, plabel,
                                        torch.zeros_like(plabel)))
    nodes, node_labels, node_valid = gather_nodes(
        torch.cat(feats_flat), torch.cat(plabels_flat), torch.cat(selects),
        max_nodes)
    return nodes, node_labels, node_valid, node_valid.any()
