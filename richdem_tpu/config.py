"""Pipeline configuration (SURVEY.md §5.6).

The reference has no centralized config (per-app argv + CMake options);
the committed design here is one frozen dataclass per pipeline carrying
every knob that changes numerical results or placement, hashable so it
can key jit caches and checkpoint manifests.
"""

from __future__ import annotations

import dataclasses
import json

__all__ = ["PipelineConfig"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Knobs for the fill → flowdirs → accumulation (→ TWI) pipeline."""

    #: fixed fill epsilon; 0 = plain fill, None = auto (ulp-scaled)
    eps: float | None = 1e-3
    #: flow metric: D8/D4/Rho8/Rho4/Dinf/Quinn/Freeman/Holmgren/...
    metric: str = "D8"
    #: exponent for Freeman/Holmgren/Seibert-McGlynn
    exponent: float | None = None
    #: grid cell size (map units)
    cellsize: float = 1.0
    #: compute dtype policy for rasters on device
    dtype: str = "float32"
    #: fixpoint iteration caps
    fill_iters: int | None = None
    accum_rotations: int = 64
    #: attach slope + TWI outputs
    with_twi: bool = False
    #: device mesh shape for the sharded pipeline; None = single device
    mesh: tuple | None = None
    #: checkpoint directory for phase-granular resume; None = off
    cache_dir: str | None = None
    grid_id: str = "grid"

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh"] = list(self.mesh) if self.mesh else None
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        d = json.loads(s)
        if d.get("mesh"):
            d["mesh"] = tuple(d["mesh"])
        return cls(**d)

    def run(self, dem, no_data=None):
        """Execute the configured pipeline; returns a dict of rasters."""
        import numpy as np

        # Resolve eps ONCE for every branch: None = auto (ulp-scaled to
        # the DEM); any explicit value — including 0.0 (plain fill) —
        # passes through unchanged.
        if self.eps is None:
            from richdem_tpu.ops.fill import auto_epsilon
            eps = auto_epsilon(np.asarray(dem))
        else:
            eps = float(self.eps)

        if self.metric.lower() not in ("d8",):
            # generic path through the public API
            import richdem_tpu as rd

            arr = rd.rdarray(np.asarray(dem), no_data=no_data,
                             geotransform=(0, self.cellsize, 0, 0, 0,
                                           -self.cellsize))
            filled = rd.FillDepressions(arr, epsilon=eps if eps else False)
            acc = rd.FlowAccumulation(filled, method=self.metric,
                                      exponent=self.exponent)
            out = {"filled": np.asarray(filled), "accum": np.asarray(acc)}
            if self.with_twi:
                slope = rd.TerrainAttribute(filled, "slope_radians")
                out["slope"] = np.asarray(slope)
                out["twi"] = np.asarray(rd.TWI(acc, slope))
            return out
        if self.mesh is not None:
            from richdem_tpu.parallel import make_mesh, sharded_pipeline

            mesh = make_mesh(shape=self.mesh)
            from richdem_tpu.ops.stencil import nodata_like
            import jax.numpy as jnp
            nd_mask = (None if no_data is None
                       else nodata_like(jnp.asarray(np.asarray(dem)),
                                        no_data))
            return sharded_pipeline(dem, mesh=mesh, eps=eps,
                                    nodata_mask=nd_mask,
                                    cellsize=self.cellsize)
        if self.cache_dir:
            from richdem_tpu.pipeline import resumable_pipeline

            return resumable_pipeline(dem, self.cache_dir,
                                      grid_id=self.grid_id,
                                      eps=eps,
                                      cellsize=self.cellsize,
                                      with_twi=self.with_twi,
                                      no_data=no_data)
        from richdem_tpu.pipeline import terrain_pipeline

        return terrain_pipeline(dem, eps=eps,
                                cellsize=self.cellsize,
                                fill_iters=self.fill_iters,
                                with_twi=self.with_twi,
                                no_data=no_data)
