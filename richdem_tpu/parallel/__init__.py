"""Distribution layer (reference L3 — SURVEY.md §2.4): tiled multi-device
terrain analysis.

The reference scales by MPI tile decomposition with a producer-rank
perimeter-graph merge [P1][P2].  Here the same spatial decomposition rides
device-mesh machinery instead (SURVEY.md §5.7/§5.8):

* a 2-D ``jax.sharding.Mesh`` over devices (``richdem_tpu.parallel.mesh``);
* ``shard_map`` kernels with 1-cell halo exchange via ``lax.ppermute``
  (``richdem_tpu.parallel.halo``) — the symmetric-SPMD replacement for the
  reference's producer-consumer star topology;
* sharded fixpoint drivers whose convergence is detected by a global
  ``psum`` of changed-cell counts (``richdem_tpu.parallel.sharded``);
* the [P1]/[P2] O(perimeter) two-pass protocols — label-graph fill and
  perimeter-link accumulation — giving exactly two passes over the data
  at any scale (``richdem_tpu.parallel.labelgraph`` +
  ``sharded_fill_twopass`` / ``outofcore`` method="twopass");
* tile manifests for hosts feeding the mesh from disk
  (``richdem_tpu.parallel.layout`` — Layoutfile counterpart).
"""

from richdem_tpu.parallel.mesh import make_mesh, grid_sharding
from richdem_tpu.parallel.sharded import (
    sharded_fill, sharded_fill_twopass, sharded_terrain_attribute,
    sharded_d8_flowdirs, sharded_accumulation_d8,
    sharded_accumulation_d8_twopass, sharded_accumulation_mfd,
    sharded_pipeline,
)
