"""Fast-Hessian detection, SURF description and brute-force matching."""
