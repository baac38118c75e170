"""Geometry helpers of the port (device-side affine transforms)."""
