"""Precision pinning, device selection and synthetic scenes."""
