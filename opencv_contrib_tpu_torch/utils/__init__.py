"""Precision pinning and synthetic scenes."""
