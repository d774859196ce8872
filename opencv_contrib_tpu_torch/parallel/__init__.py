"""Distributed execution on torch.distributed — the port of
opencv_contrib_tpu/parallel/: meshes, sharded BA, ring matching sweeps.

The reference has NO distributed backend (SURVEY §5.8: no MPI/NCCL anywhere;
parallelism tops out at intra-process threads + single-GPU streams), so the
JAX package designed this layer fresh; the port keeps its design with one
process a rank (NCCL on the card, gloo on the CPU):

- mesh: canonical mesh axes ("dp", "sp") — dp shards frames/views/batches,
  sp shards tracks/points/map blocks — and the collectives on them.
- dist_ba: Schur BA with the observation grid sharded over the mesh; the
  single-device solvers run on each rank's block with the reductions of
  the reduced camera system placed where GSPMD places them.
- ring_match: all-pairs descriptor matching where each rank owns a block of
  images and descriptor blocks travel the ring — replacing the reference's
  quadratic single-process loop (nRobustViewMatching.cc:154).
- submap_shard: map blocks (LargeKinFu submaps) assigned to shards;
  boundary-constraint Gauss-Newton with summed 6x6 block systems.
- stage_pipeline: a stage chain with one stage a rank, items handed on by
  point-to-point sends.
- dist_sfm: the frontend -> ring matching -> sharded BA step composed.
- checkpoint: npz pytree checkpointing of SLAM / SfM state in the JAX
  package's layout.
"""

from opencv_contrib_tpu_torch.parallel import checkpoint, dist_ba, dist_sfm, mesh, ring_match, submap_shard

__all__ = ["checkpoint", "dist_ba", "dist_sfm", "mesh", "ring_match", "submap_shard"]
