"""Shared [P1]/[P2] two-pass protocol drivers over abstract tile sources.

These drivers orchestrate the device-resident consumers
(:mod:`richdem_tpu.parallel.consumer`) over any tiling — disk memmaps
(:mod:`richdem_tpu.parallel.outofcore`), in-HBM device-mesh shards
(:mod:`richdem_tpu.parallel.sharded`), or per-process shard subsets
(multi-host, via ``local_tiles`` + ``exchange``) — through ``get``/
``put`` callables.  The host side touches only O(perimeter) data: ring
vectors, label-graph edges, and the global solves; tile rasters stay
wherever the callables keep them.

Fill: [P1] arxiv 1606.06204 §3 (SURVEY.md §3.4) with the ring-Dirichlet
pass 2 (see consumer.py docstring — no label raster is ever persisted).
Accumulation: [P2] arxiv 1608.04431 §3–4 (SURVEY.md §3.5) — perimeter
links + topological exit-graph sweep + one replay with injected inflows.

Multi-process model (the reference's ``mpirun -n N`` analog, SURVEY.md
§2.4): each process runs the consumers for its own tiles (pass 1),
``exchange`` all-gathers the pickled O(perimeter) payloads, EVERY
process solves the identical global problem deterministically (tiles
sorted, stable heap/topological orders), and pass 2 runs on local tiles
only — a symmetric SPMD recast of [P1]'s producer rank.
"""

from __future__ import annotations

import numpy as np

from richdem_tpu.parallel.consumer import (GE_BOTTOM, GE_LEFT, GE_RIGHT,
                                           GE_TOP, accum_tile_consumer,
                                           fill_tile_apply,
                                           fill_tile_consumer, ring_index)

__all__ = ["fill_twopass_run", "accum_twopass_run", "side_positions",
           "multihost_exchange"]


def multihost_exchange(blob):
    """All-gather variable-length pickled payloads across
    ``jax.distributed`` processes (two fixed-shape collectives: lengths,
    then max-padded bytes).  The default ``exchange`` for multi-process
    two-pass runs — the [P1] producer's MPI gather, as a symmetric
    collective."""
    from jax.experimental import multihost_utils as mhu

    n = np.array([len(blob)], np.int64)
    lens = np.asarray(mhu.process_allgather(n)).reshape(-1)
    mx = int(lens.max())
    buf = np.zeros(max(mx, 1), np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, np.uint8)
    gathered = np.asarray(mhu.process_allgather(buf))
    return [gathered[i, :int(lens[i])].tobytes()
            for i in range(gathered.shape[0])]


def side_positions(th, tw, side):
    """Positions within the :func:`ring_index` vector of one full side
    line (length tw for top/bottom, th for left/right), in grid order."""
    if side in ("top", "bottom"):
        if side == "top" or th == 1:
            return np.arange(tw)
        return tw + np.arange(tw)
    # left/right columns, full length th including corners
    first = 0 if (side == "left" or tw == 1) else tw - 1
    if th == 1:
        return np.array([first])
    last = (tw if (side == "left" or tw == 1) else 2 * tw - 1)
    if th == 2:
        return np.array([first, last])
    inner0 = 2 * tw
    if side == "left" or tw == 1:
        inner = inner0 + np.arange(th - 2)
    else:
        inner = inner0 + (th - 2) + np.arange(th - 2)
    return np.concatenate([[first], inner, [last]])


def _ge_mask(ri, ci, nrows, ncols):
    return ((GE_TOP if ri == 0 else 0)
            | (GE_BOTTOM if ri == nrows - 1 else 0)
            | (GE_LEFT if ci == 0 else 0)
            | (GE_RIGHT if ci == ncols - 1 else 0))


def _gather_payloads(local, exchange):
    """Merge per-tile payload dicts across processes (identity when
    ``exchange`` is None).  ``exchange(bytes) -> list of bytes``."""
    if exchange is None:
        return local
    import pickle
    merged = {}
    for blob in exchange(pickle.dumps(local, protocol=4)):
        merged.update(pickle.loads(blob))
    return merged


def _seam_edges(wa, wb, la, lb, ea, eb, ew):
    """8-adjacency edges between two adjacent full grid lines (dj in
    -1, 0, 1).  ``wa``/``wb`` carry -inf at nodata cells (their label is
    OCEAN=0), so data↔nodata pairs become finite ocean edges and
    nodata↔nodata pairs drop out."""
    m = wa.shape[0]
    for dj in (-1, 0, 1):
        a_sl = slice(max(0, -dj), m - max(0, dj))
        b_sl = slice(max(0, dj), m - max(0, -dj))
        ga, gb = la[a_sl], lb[b_sl]
        wgt = np.maximum(wa[a_sl], wb[b_sl])
        keep = (ga != gb) & np.isfinite(wgt)
        ea.append(ga[keep])
        eb.append(gb[keep])
        ew.append(wgt[keep])


def fill_twopass_run(get_tile, put_tile, rows, cols, no_data=None,
                     stats=None, verbose=False, local_tiles=None,
                     exchange=None):
    """[P1] two-pass fill over an abstract tiling.

    ``get_tile(ri, ci)`` returns the (r1-r0, c1-c0) elevation raster
    (numpy or device array); ``put_tile(ri, ci, filled)`` receives the
    globally-filled device tile.  ``rows``/``cols``: (start, stop)
    ranges.  ``local_tiles``: the (ri, ci) list this process owns (all
    when None); ``exchange``: cross-process all-gather of pickled bytes.
    Host memory: O(perimeter)."""
    from richdem_tpu.parallel.labelgraph import minimax_raise, reduce_edges

    nr, nc = len(rows), len(cols)
    mine = (local_tiles if local_tiles is not None
            else [(ri, ci) for ri in range(nr) for ci in range(nc)])
    tile_loads = 0

    # ---- pass 1: device consumers for MY tiles, O(perimeter) retention
    local = {}
    for ri, ci in mine:
        out = fill_tile_consumer(get_tile(ri, ci), no_data=no_data,
                                 global_edges=_ge_mask(ri, ci, nr, nc))
        tile_loads += 1
        ea, eb, ew = out["edges"]
        labs = np.unique(np.concatenate([out["ring_lab"], ea, eb]))
        labs = labs[labs > 0]
        local[(ri, ci)] = {
            "ring_w": out["ring_w"], "ring_lab": out["ring_lab"],
            "ring_nd": out["ring_nd"], "labs": labs,
            "edges": (ea, eb, ew),
        }

    payload = _gather_payloads(local, exchange)
    if len(payload) != nr * nc:
        raise RuntimeError(f"two-pass fill: {len(payload)} tile payloads "
                           f"for a {nr}x{nc} tiling")

    # ---- deterministic global label ids (tiles sorted by position)
    meta = {}
    next_base = 1
    ea_all, eb_all, ew_all = [], [], []
    for key in sorted(payload):
        p = payload[key]
        labs = p["labs"]
        base = next_base
        next_base += labs.size

        def to_global(x, labs=labs, base=base):
            out_ = np.zeros_like(x)
            nz = x > 0
            out_[nz] = base + np.searchsorted(labs, x[nz])
            return out_

        meta[key] = {"ring_w": p["ring_w"],
                     "ring_glab": to_global(p["ring_lab"]),
                     "ring_nd": p["ring_nd"]}
        ea, eb, ew = p["edges"]
        if ea.size:
            ea_all.append(to_global(ea))
            eb_all.append(to_global(eb))
            ew_all.append(ew)

    # ---- seam edges from ring data: assemble full global seam lines
    def line(tiles, side):
        ws, ls = [], []
        for key in tiles:
            th = rows[key[0]][1] - rows[key[0]][0]
            tw = cols[key[1]][1] - cols[key[1]][0]
            pos = side_positions(th, tw, side)
            m = meta[key]
            wv = m["ring_w"][pos].astype(np.float64)
            wv[m["ring_nd"][pos]] = -np.inf
            ws.append(wv)
            ls.append(m["ring_glab"][pos])
        return np.concatenate(ws), np.concatenate(ls)

    for ri in range(nr - 1):
        wa, la = line([(ri, ci) for ci in range(nc)], "bottom")
        wb, lb = line([(ri + 1, ci) for ci in range(nc)], "top")
        _seam_edges(wa, wb, la, lb, ea_all, eb_all, ew_all)
    for ci in range(nc - 1):
        wa, la = line([(ri, ci) for ri in range(nr)], "right")
        wb, lb = line([(ri, ci + 1) for ri in range(nr)], "left")
        _seam_edges(wa, wb, la, lb, ea_all, eb_all, ew_all)

    # ---- global O(perimeter) minimax solve (every process, identical)
    if ea_all:
        a, b, w = reduce_edges(np.concatenate(ea_all),
                               np.concatenate(eb_all),
                               np.concatenate(ew_all))
    else:
        a = b = np.zeros(0, np.int64)
        w = np.zeros(0, np.float64)
    raise_ = minimax_raise(next_base, a, b, w)
    if next_base > 1 and not np.all(raise_[1:] < np.inf):
        raise RuntimeError("label graph has watersheds unreachable from "
                           "the ocean — combine bug")
    if verbose:
        print(f"label graph: {next_base} labels, {a.shape[0]} edges",
              flush=True)

    # ---- pass 2: ring-Dirichlet device solves for MY tiles
    for ri, ci in mine:
        m = meta[(ri, ci)]
        wstar = np.maximum(m["ring_w"].astype(np.float64),
                           raise_[m["ring_glab"]])
        wstar[m["ring_nd"]] = -np.inf
        filled = fill_tile_apply(get_tile(ri, ci), wstar, no_data=no_data)
        tile_loads += 1
        put_tile(ri, ci, filled)
    if stats is not None:
        stats.update(method="twopass", consumer="device", data_passes=2,
                     tile_loads=tile_loads, n_labels=int(next_base),
                     n_edges=int(a.shape[0]))


def accum_twopass_run(get_fd, get_weights, put_acc, rows, cols, shape,
                      stats=None, local_tiles=None, exchange=None):
    """[P2] two-pass D8 accumulation over an abstract tiling.

    ``get_fd(ri, ci)`` / ``get_weights(ri, ci)`` return tile rasters
    (``get_weights`` may return None for unit weights);
    ``put_acc(ri, ci, acc)`` receives the exact device accumulation.
    ``local_tiles``/``exchange`` as in :func:`fill_twopass_run`.
    Host memory: O(perimeter) ring vectors + the exit graph."""
    import jax.numpy as jnp

    from richdem_tpu.topology import DX, DY

    h, w = shape
    nr, nc = len(rows), len(cols)
    mine = (local_tiles if local_tiles is not None
            else [(ri, ci) for ri in range(nr) for ci in range(nc)])
    row_starts = np.array([r0 for r0, _ in rows])
    col_starts = np.array([c0 for c0, _ in cols])

    def owner(r, c):
        ri = int(np.searchsorted(row_starts, r, side="right") - 1)
        ci = int(np.searchsorted(col_starts, c, side="right") - 1)
        return ri, ci

    # ---- pass 1: device consumers for MY tiles → ring links
    local = {}
    tile_loads = 0
    for ri, ci in mine:
        r0, r1 = rows[ri]
        c0, c1 = cols[ci]
        _, rg = accum_tile_consumer(get_fd(ri, ci),
                                    weights=get_weights(ri, ci))
        tile_loads += 1
        th, tw = r1 - r0, c1 - c0
        ridx = ring_index(th, tw)
        lr, lc = np.divmod(ridx, tw)
        tr, tc = np.divmod(rg["link_local"], tw)
        local[(ri, ci)] = {
            "gid": (lr + r0) * w + (lc + c0),
            "a0": rg["a0"],
            "fd": rg["fd"],
            "link_gid": (tr + r0) * w + (tc + c0),
        }

    ring = _gather_payloads(local, exchange)
    if len(ring) != nr * nc:
        raise RuntimeError(f"two-pass accum: {len(ring)} tile payloads "
                           f"for a {nr}x{nc} tiling")

    # ---- global O(perimeter) combine: exit graph + topological sweep
    # (deterministic: tiles visited in sorted order, LIFO worklist)
    exit_a0 = {}        # exit gid -> local accumulation
    exit_target = {}    # exit gid -> entry cell gid or None (off-DEM)
    entry_link = {}     # entry gid -> its tile's in-tile terminal gid
    for key in sorted(ring):
        rg = ring[key]
        ri, ci = key
        r0, r1 = rows[ri]
        c0, c1 = cols[ci]
        gids = rg["gid"]
        rr, cc = np.divmod(gids, w)
        fd = rg["fd"].astype(np.int32)
        dy = np.asarray(DY, np.int32)[np.clip(fd, 0, 8)]
        dx = np.asarray(DX, np.int32)[np.clip(fd, 0, 8)]
        nr_, nc_ = rr + dy, cc + dx
        flows = fd > 0
        off_tile = flows & ((nr_ < r0) | (nr_ >= r1)
                            | (nc_ < c0) | (nc_ >= c1))
        on_grid = (nr_ >= 0) & (nr_ < h) & (nc_ >= 0) & (nc_ < w)
        for i in np.nonzero(off_tile)[0]:
            g = int(gids[i])
            exit_a0[g] = float(rg["a0"][i])
            exit_target[g] = (int(nr_[i] * w + nc_[i])
                              if on_grid[i] else None)
        for i in range(gids.shape[0]):
            entry_link[int(gids[i])] = int(rg["link_gid"][i])

    def forward_of(q):
        """(entry, next_exit): where flow crossing out of ``q`` lands."""
        e = exit_target[q]
        if e is None:
            return None, None
        x = entry_link.get(e)
        return e, (x if x in exit_a0 else None)

    indeg = {q: 0 for q in exit_a0}
    for q in exit_a0:
        _, x = forward_of(q)
        if x is not None:
            indeg[x] += 1
    delta = {q: 0.0 for q in exit_a0}
    work = [q for q, d in indeg.items() if d == 0]
    processed = 0
    while work:
        q = work.pop()
        processed += 1
        amount = exit_a0[q] + delta[q]
        _, x = forward_of(q)
        if x is not None:
            delta[x] += amount
            indeg[x] -= 1
            if indeg[x] == 0:
                work.append(x)
    if processed != len(exit_a0):
        raise RuntimeError("inter-tile exit graph has a cycle — the "
                           "flow-direction raster is not acyclic")

    inject = {}  # (ri, ci) -> {local flat: amount}
    for q in sorted(exit_a0):
        e, _ = forward_of(q)
        if e is None:
            continue
        er, ec = divmod(e, w)
        t = owner(er, ec)
        r0, c0 = rows[t[0]][0], cols[t[1]][0]
        tw = cols[t[1]][1] - c0
        local_i = (er - r0) * tw + (ec - c0)
        d = inject.setdefault(t, {})
        d[local_i] = d.get(local_i, 0.0) + exit_a0[q] + delta[q]

    # ---- pass 2: replay with exact entry inflows, on device
    for ri, ci in mine:
        fd_t = jnp.asarray(get_fd(ri, ci)).astype(jnp.int8)
        tile_loads += 1
        wt = get_weights(ri, ci)
        if wt is None:
            wt = jnp.ones(fd_t.shape, jnp.float32)
        wt = jnp.where(fd_t < 0, 0.0, jnp.asarray(wt, jnp.float32))
        inj = inject.get((ri, ci), {})
        if inj:
            idx = jnp.asarray(np.fromiter(inj.keys(), np.int64,
                                          len(inj)))
            amt = jnp.asarray(np.fromiter(inj.values(), np.float64,
                                          len(inj)), jnp.float32)
            wt = wt.reshape(-1).at[idx].add(amt).reshape(fd_t.shape)
        put_acc(ri, ci, _local_solve(fd_t, wt))
    if stats is not None:
        stats.update(method="twopass", consumer="device", data_passes=2,
                     tile_loads=tile_loads, n_exits=len(exit_a0))


def _local_solve(fd_t, wt):
    from richdem_tpu.ops.accum import d8_accumulation
    return d8_accumulation(fd_t, weights=wt)
