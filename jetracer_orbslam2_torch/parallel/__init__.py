"""Distributed execution (counterpart of `jetracer_orbslam2_tpu/parallel/`):
process groups as meshes, landmark-sharded bundle adjustment, and the BA
benchmark problem with its timing and scaling sweep.

One process a rank, joined by `init_distributed()` (or a one-rank group from
`make_mesh()`); the live SLAM map runs BA through `sharded_local_ba` whenever
`models.slam.Slam`, `slam_scan` or `ChunkedSlam` is given a mesh.
"""

from jetracer_orbslam2_torch.parallel.mesh import (
    Mesh, init_distributed, make_mesh, map_mesh, virtual_mesh)
from jetracer_orbslam2_torch.parallel.ba_sharded import (
    ShardedBAProblem,
    prepare_sharded_problem,
    sharded_bundle_adjust,
    sharded_local_ba,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "map_mesh",
    "virtual_mesh",
    "ShardedBAProblem",
    "prepare_sharded_problem",
    "sharded_bundle_adjust",
    "sharded_local_ba",
]
