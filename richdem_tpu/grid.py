"""Raster container: the device-native replacement for RichDEM's ``Array2D``.

The reference (SURVEY.md §2.1, ``include/richdem/common/Array2D.hpp``) couples
storage, nodata, geotransform, projection, and GDAL IO in one templated C++
class.  Here the design splits in two:

* :class:`rdarray` — the *user-facing* container, name-compatible with
  pyrichdem's ``rdarray`` (SURVEY.md §2.5).  Wraps a ``jax.Array`` or
  ``numpy.ndarray`` plus ``no_data``, ``geotransform``, ``projection``,
  ``metadata`` (including ``PROCESSING_HISTORY`` provenance).
* pure functions in :mod:`richdem_tpu.ops` — operate on plain arrays +
  scalar nodata, so everything jits/shards cleanly.  ``rdarray`` is never
  traced.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rdarray", "rd3array", "DEFAULT_GEOTRANSFORM"]

#: Identity geotransform (GDAL-style 6-tuple):
#: (x_origin, cell_width, x_skew, y_origin, y_skew, cell_height).
DEFAULT_GEOTRANSFORM = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)


class rdarray:
    """A 2-D raster with nodata + georeferencing + provenance metadata.

    Mirrors pyrichdem's ``rdarray`` surface: ``no_data``, ``geotransform``,
    ``projection``, ``metadata``, numpy interop via ``__array__``, shape /
    dtype / indexing passthrough.  The payload may live on device (``jax.Array``)
    or host (``numpy.ndarray``); ``.np()`` / ``.jnp()`` convert explicitly.
    """

    _fields = ("no_data", "geotransform", "projection", "metadata")

    def __init__(self, array, no_data=None, geotransform=None,
                 projection="", metadata=None):
        if isinstance(array, rdarray):
            meta_src = array
            array = array.data
        else:
            meta_src = None
        self.data = array
        if meta_src is not None:
            no_data = meta_src.no_data if no_data is None else no_data
            geotransform = (meta_src.geotransform if geotransform is None
                            else geotransform)
            projection = projection or meta_src.projection
            metadata = (dict(meta_src.metadata) if metadata is None
                        else metadata)
        self.no_data = no_data
        self.geotransform = tuple(
            DEFAULT_GEOTRANSFORM if geotransform is None else geotransform)
        self.projection = projection
        self.metadata = {} if metadata is None else dict(metadata)
        self.metadata.setdefault("PROCESSING_HISTORY", "")

    # -- interop ---------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.data)
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        return arr

    def np(self) -> np.ndarray:
        """Host numpy view/copy of the payload."""
        return np.asarray(self.data)

    def jnp(self):
        """Device (jax) array of the payload."""
        import jax.numpy as jnp

        return jnp.asarray(self.data)

    def copy(self) -> "rdarray":
        return rdarray(np.array(self.np()), no_data=self.no_data,
                       geotransform=self.geotransform,
                       projection=self.projection,
                       metadata=dict(self.metadata))

    def like(self, new_data) -> "rdarray":
        """New rdarray carrying this raster's georeferencing/metadata."""
        return rdarray(new_data, no_data=self.no_data,
                       geotransform=self.geotransform,
                       projection=self.projection,
                       metadata=dict(self.metadata))

    # -- raster properties ----------------------------------------------
    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def cellsize(self) -> float:
        """Cell edge length from the geotransform (|pixel width|)."""
        return abs(self.geotransform[1])

    def nodata_mask(self) -> np.ndarray:
        """Boolean mask of nodata cells (all-False when no_data is None)."""
        if self.no_data is None:
            return np.zeros(self.shape, dtype=bool)
        arr = self.np()
        if isinstance(self.no_data, float) and np.isnan(self.no_data):
            return np.isnan(arr)
        return arr == np.asarray(self.no_data, dtype=arr.dtype)

    # -- passthrough ------------------------------------------------------
    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)

    def __repr__(self):
        return (f"rdarray(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"no_data={self.no_data})")

    def __eq__(self, other):
        if isinstance(other, rdarray):
            other = other.np()
        return self.np() == other

    def __ne__(self, other):
        if isinstance(other, rdarray):
            other = other.np()
        return self.np() != other


class rd3array(rdarray):
    """An ``(H, W, 8)`` flow-proportions raster (RichDEM ``rd3array``).

    Channel ``k`` holds the fraction of flow leaving each cell toward
    direction ``k + 1`` in the package-wide D8 ordering
    (:mod:`richdem_tpu.topology`).
    """
