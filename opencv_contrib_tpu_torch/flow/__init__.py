"""Optical flow: pyramidal Lucas-Kanade (`lk`), DIS-class dense flow (`dis`)
and TV-L1 (`tvl1`)."""
