"""Rotations and the camera model."""
