"""Inference of the port: whole-volume 2-D segmentation."""
