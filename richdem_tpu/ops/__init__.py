"""Device ops: the data-parallel algorithm layer (reference L1 — SURVEY.md §2.2).

Everything here is a pure, jittable function on ``jnp`` arrays.  Serial
priority queues are banned by design (SURVEY.md appendix B): depression
filling, flat resolution, and flow accumulation are recast as monotone
fixpoint iterations built from three primitives:

* 8-neighbor shifted-array stencils (:mod:`richdem_tpu.ops.stencil`);
* masked min-plus Gauss–Seidel *sweeps* — ``lax.scan`` over rows combined
  with ``lax.associative_scan`` clamp composition within rows
  (:mod:`richdem_tpu.ops.sweeps`), converging in O(sweeps) instead of
  O(grid diameter) Jacobi steps;
* log-depth pointer doubling for single-flow accumulation
  (:mod:`richdem_tpu.ops.accum`).

Each op is gated on allclose agreement with :mod:`richdem_tpu.oracle`.
"""

from richdem_tpu.ops import (  # noqa: F401 — submodule access (ops.fill etc.)
    accum, fill, flats, flowdirs, sweeps, stencil, terrain,
)
from richdem_tpu.ops.terrain import terrain_attribute, slope_riserun
from richdem_tpu.ops.flowdirs import (
    d8_flowdirs, rho8_flowdirs, dinf_flowdirs, flow_proportions,
    proportions_from_d8, proportions_from_dinf,
)
from richdem_tpu.ops.fill import fill_depressions, fill_epsilon
from richdem_tpu.ops.accum import (
    flow_accumulation_from_props, d8_accumulation,
)
from richdem_tpu.ops.flats import resolve_flats
