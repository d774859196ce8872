"""Camera resection."""
