"""opencv_contrib_tpu_torch: the PyTorch + CUDA port of opencv_contrib_tpu
for NVIDIA Hopper (H100).

The layout mirrors the JAX package: core/, ops/ (with ops/cuda/ in the role
of ops/pallas/), features/, mvg/, ba/, utils/. Library functions run on the
device of their input tensors; the entry points in `entry` default to the
GPU. The JAX package is the reference the tests hold this one to.
"""
