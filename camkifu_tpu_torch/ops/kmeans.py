"""Fixed-iteration Lloyd k-means (port of camkifu_tpu/ops/kmeans.py).

Leading dims of ``x`` are a batch of independent problems (the reference
vmaps over frames).
"""

from __future__ import annotations

import torch


def kmeans(x: torch.Tensor, init: torch.Tensor, k: int = 3,
           iters: int = 10):
    """Lloyd k-means on x (..., N, F) from the initial centroids ``init``
    (k, F) or (..., k, F) — the classifier's fixed contrast centroids (the
    reference's luminance-quantile init and sample weights have no caller
    on the ported path).

    Returns (centroids (..., k, F), labels (..., N) int32, compactness
    (...,)). Ties in the assignment go to the lower cluster, as
    ``jnp.argmin`` does.
    """
    x = x.to(torch.float32)
    c = init.to(torch.float32).expand(*x.shape[:-2], k, x.shape[-1])

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
        counts = assign.sum(dim=-2)                          # (..., k)
        sums = assign.transpose(-1, -2) @ x                  # (..., k, F)
        new = sums / torch.clamp(counts[..., None], min=1e-6)
        # Keep empty clusters where they were.
        c = torch.where(counts[..., None] > 0.5, new, c)
    d = dists(c)
    labels = torch.argmin(d, dim=-1).to(torch.int32)
    compactness = torch.sum(torch.min(d, dim=-1).values, dim=-1)
    return c, labels, compactness
