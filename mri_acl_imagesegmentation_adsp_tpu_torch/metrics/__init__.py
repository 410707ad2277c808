"""Report-time segmentation metrics."""
