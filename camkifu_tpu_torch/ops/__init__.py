"""Tensor ops of the port: color, filters, edges, Hough, warp, zones,
k-means. The package re-exports the reference's names
(camkifu_tpu/ops/__init__.py); ``kmeans`` here is the function, not its
module."""

from camkifu_tpu_torch.ops.color import rgb_to_gray, to_float
from camkifu_tpu_torch.ops.warp import (
    homography_dlt,
    canonical_corners,
    warp_to_canonical,
    warp_batch_fixed,
    warp_batch_chunked,
    apply_homography,
)
from camkifu_tpu_torch.ops.zones import extract_zones, zone_features, \
    zone_stats
from camkifu_tpu_torch.ops.kmeans import kmeans, luminance_ordered_labels
from camkifu_tpu_torch.ops.edges import edge_map
from camkifu_tpu_torch.ops.hough import hough_lines

__all__ = [
    "rgb_to_gray", "to_float",
    "homography_dlt", "canonical_corners", "warp_to_canonical",
    "warp_batch_fixed", "warp_batch_chunked", "apply_homography",
    "extract_zones", "zone_features", "zone_stats",
    "kmeans", "luminance_ordered_labels",
    "edge_map", "hough_lines",
]
