"""Optical flow: pyramidal Lucas-Kanade (`lk`), DIS-class dense flow (`dis`),
TV-L1 (`tvl1`), DeepFlow, SimpleFlow, sparse-to-dense and RLOF (`extra`),
PCAFlow (`pcaflow`), the Global Patch Collider (`gpc`) and motion templates
(`motempl`)."""
