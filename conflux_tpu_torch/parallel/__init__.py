"""The process grid and its collectives (the port of `conflux_tpu/parallel`).

The JAX package names its communicators as mesh axes of one `shard_map`
program; the port runs one rank per process (or thread), each holding its
own shard, and gives each rank a `Mesh` with a process group for every
slice of the grid it belongs to, as the reference's MPI ranks hold their
sub-communicators.
"""

from conflux_tpu_torch.parallel.mesh import (
    AXIS_X,
    AXIS_Y,
    AXIS_Z,
    Mesh,
    comm,
    make_mesh,
    run_threaded,
)

__all__ = ["AXIS_X", "AXIS_Y", "AXIS_Z", "Mesh", "comm", "make_mesh", "run_threaded"]
