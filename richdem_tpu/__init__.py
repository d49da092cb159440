"""richdem_tpu — an accelerator-native terrain-analysis engine.

A from-scratch JAX/XLA/Pallas re-design of the RichDEM capability set
(see SURVEY.md at the repo root for the full blueprint): depression filling
and breaching, flat resolution, single- and multi-flow direction metrics,
flow accumulation, terrain attributes, and tiled multi-device scaling —
with serial priority queues replaced by data-parallel fixpoint sweeps.

The top-level namespace mirrors pyrichdem's public API (SURVEY.md §2.5) so
RichDEM scripts port by changing the import.
"""

import os as _os

#: Persistent compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: a fixed path inside the checkout, so a copied tree hits it.
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

if ("JAX_COMPILATION_CACHE_DIR" not in _os.environ
        and _os.environ.get("RICHDEM_TPU_NO_COMPILE_CACHE") != "1"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from richdem_tpu.version import __version__
from richdem_tpu.grid import rdarray, rd3array
from richdem_tpu.api import (
    LoadGDAL, SaveGDAL, FillDepressions, BreachDepressions, ResolveFlats,
    FlowProportions, FlowAccumulation, FlowAccumFromProps,
    TerrainAttribute, FlowDirections, WatershedLabels, UpslopeCells,
    StrahlerOrder, TWI, SPI, rdCompare, rdShow,
)
from richdem_tpu import synth, io, topology

__all__ = [
    "__version__", "rdarray", "rd3array", "LoadGDAL", "SaveGDAL",
    "FillDepressions", "BreachDepressions", "ResolveFlats",
    "FlowProportions", "FlowAccumulation", "FlowAccumFromProps",
    "TerrainAttribute", "FlowDirections", "WatershedLabels",
    "UpslopeCells", "StrahlerOrder", "TWI", "SPI", "rdCompare", "rdShow",
    "synth", "io", "topology",
]
