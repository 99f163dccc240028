"""Tensor ops of the port: color, filters, edges, Hough, warp, zones,
k-means."""
