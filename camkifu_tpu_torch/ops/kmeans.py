"""Fixed-iteration Lloyd k-means (port of camkifu_tpu/ops/kmeans.py).

Leading dims of ``x`` are a batch of independent problems (the reference
vmaps over frames).
"""

from __future__ import annotations

import torch


def _init_by_luminance(x: torch.Tensor, k: int,
                       luma: torch.Tensor) -> torch.Tensor:
    """Deterministic init: centroids at evenly-spaced luminance quantiles
    of x (..., N, F) by luma (..., N) → (..., k, F). The order is a stable
    sort, as ``jnp.argsort``'s."""
    order = torch.argsort(luma, dim=-1, stable=True)
    n = x.shape[-2]
    qs = (torch.arange(k, dtype=torch.float32, device=x.device) + 0.5) / k
    idx = torch.clamp((qs * n).to(torch.int64), 0, n - 1)
    rows = torch.index_select(order, -1, idx)                  # (..., k)
    return torch.gather(x, -2, rows[..., None].expand(*rows.shape,
                                                      x.shape[-1]))


def kmeans(x: torch.Tensor, k: int = 3, iters: int = 10,
           weights: torch.Tensor | None = None,
           init: torch.Tensor | None = None,
           luma: torch.Tensor | None = None):
    """Lloyd k-means on x (..., N, F).

    weights: optional (..., N) sample weights (0 excludes a sample).
    init: optional (k, F) or (..., k, F) initial centroids; else the
    luminance-quantile init (luma (..., N) defaults to the first feature
    column).

    Returns (centroids (..., k, F), labels (..., N) int32, compactness
    (...,)). Ties in the assignment go to the lower cluster, as
    ``jnp.argmin`` does.
    """
    x = x.to(torch.float32)
    if init is None:
        init = _init_by_luminance(x, k, x[..., 0] if luma is None else luma)
    c = init.to(torch.float32).expand(*x.shape[:-2], k, x.shape[-1])
    w = None if weights is None else weights.to(torch.float32)

    def dists(cents):
        # (..., N, k) squared distances.
        return torch.sum((x[..., :, None, :] - cents[..., None, :, :]) ** 2,
                         dim=-1)

    ks = torch.arange(k, device=x.device)
    for _ in range(iters):
        # One-hot by comparison: F.one_hot checks its input's range on the
        # host, which waits for the device.
        assign = (torch.argmin(dists(c), dim=-1)[..., None] == ks) \
            .to(torch.float32)
        if w is not None:
            assign = assign * w[..., None]
        counts = assign.sum(dim=-2)                          # (..., k)
        sums = assign.transpose(-1, -2) @ x                  # (..., k, F)
        new = sums / torch.clamp(counts[..., None], min=1e-6)
        # Keep empty clusters where they were.
        c = torch.where(counts[..., None] > 0.5, new, c)
    d = dists(c)
    labels = torch.argmin(d, dim=-1).to(torch.int32)
    dmin = torch.min(d, dim=-1).values
    compactness = torch.sum(dmin if w is None else dmin * w, dim=-1)
    return c, labels, compactness


def luminance_ordered_labels(centroids: torch.Tensor, labels: torch.Tensor,
                             luma_weights: torch.Tensor) -> torch.Tensor:
    """Relabel clusters so 0 = darkest, 1 = middle, 2 = brightest.

    centroids (..., k, F), labels (..., N), luma_weights (F,): the
    projection of a centroid onto luminance. Returns (..., N) int32.
    """
    luma = centroids @ luma_weights.to(centroids.dtype)
    rank = torch.argsort(torch.argsort(luma, dim=-1, stable=True), dim=-1,
                         stable=True)                        # (..., k)
    return torch.gather(rank, -1, labels.long()).to(torch.int32)
