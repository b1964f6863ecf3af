"""Mesh extraction: SDF -> triangle mesh by marching tetrahedra (JAX
reference: engine/mesh.py, copied: numpy on the host). The SDF is
evaluated in chunks of 262,144 grid points by a callable (on the card,
`MMSModel.sdf_only`); 6 tetrahedra a cube triangulate the cells whose
corner values straddle the threshold, then duplicate vertices are welded.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

# 6 tetrahedra decomposition of a cube (corner indices in binary zyx order)
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)

# cube corner offsets [8, 3] — x fastest
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ]
)


def _eval_sdf_grid(
    sdf_fn: Callable, resolution: int, bounds: Tuple[float, float], chunk: int = 262144
) -> np.ndarray:
    lo, hi = bounds
    xs = np.linspace(lo, hi, resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    out = np.empty(grid.shape[0], np.float32)
    for i in range(0, grid.shape[0], chunk):
        out[i : i + chunk] = np.asarray(sdf_fn(grid[i : i + chunk]))
    return out.reshape(resolution, resolution, resolution)


def _tet_triangles(p: np.ndarray, s: np.ndarray, threshold: float) -> np.ndarray:
    """Triangulate one batch of tetrahedra.

    p: [T, 4, 3] vertex positions, s: [T, 4] sdf values.
    Returns [M, 3, 3] triangles.
    """
    inside = s < threshold  # [T, 4]
    code = inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8

    def interp(i, j, sel):
        si = s[sel, i]
        sj = s[sel, j]
        t = (threshold - si) / (sj - si + 1e-12)
        return p[sel, i] + t[:, None] * (p[sel, j] - p[sel, i])

    tris = []
    # single-vertex-inside cases (1 triangle) and their complements
    single = {1: (0, (1, 2, 3)), 2: (1, (0, 3, 2)), 4: (2, (0, 1, 3)), 8: (3, (0, 2, 1))}
    for c, (v, (a, b, d)) in single.items():
        for cc, flip in ((c, False), (15 - c, True)):
            sel = np.nonzero(code == cc)[0]
            if sel.size == 0:
                continue
            ea = interp(v, a, sel)
            eb = interp(v, b, sel)
            ed = interp(v, d, sel)
            tri = np.stack([ea, eb, ed], axis=1)
            if flip:
                tri = tri[:, ::-1]
            tris.append(tri)
    # two-vertices-inside cases (2 triangles / quad)
    pairs = {
        3: ((0, 1), (2, 3)),
        5: ((0, 2), (3, 1)),
        6: ((1, 2), (0, 3)),
        9: ((0, 3), (1, 2)),
        10: ((1, 3), (2, 0)),
        12: ((2, 3), (0, 1)),
    }
    for c, ((i0, i1), (o0, o1)) in pairs.items():
        sel = np.nonzero(code == c)[0]
        if sel.size == 0:
            continue
        a = interp(i0, o0, sel)
        b = interp(i0, o1, sel)
        cpt = interp(i1, o0, sel)
        d = interp(i1, o1, sel)
        tris.append(np.stack([a, b, cpt], axis=1))
        tris.append(np.stack([cpt, b, d], axis=1))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, axis=0)


def extract_mesh(
    sdf_fn: Callable,
    resolution: int = 256,
    bounds: Tuple[float, float] = (-1.0, 1.0),
    threshold: float = 0.0,
    cell_batch: int = 2_000_000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (vertices [V,3], faces [F,3]) from an SDF callable.

    Active cells are those whose corner signs straddle the threshold — the
    vectorized analogue of the reference's |sdf|-mask crop skipping
    (marching_cubes.py:90-130).
    """
    sdf = _eval_sdf_grid(sdf_fn, resolution, bounds)
    lo, hi = bounds
    spacing = (hi - lo) / (resolution - 1)

    corner = sdf[:-1, :-1, :-1]
    smin = np.minimum.reduce(
        [sdf[c[0] : resolution - 1 + c[0], c[1] : resolution - 1 + c[1], c[2] : resolution - 1 + c[2]] for c in _CORNERS]
    )
    smax = np.maximum.reduce(
        [sdf[c[0] : resolution - 1 + c[0], c[1] : resolution - 1 + c[1], c[2] : resolution - 1 + c[2]] for c in _CORNERS]
    )
    active = np.nonzero((smin < threshold) & (smax >= threshold))
    if active[0].size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    cells = np.stack(active, axis=-1)  # [C, 3] (ix, iy, iz)
    all_tris = []
    for start in range(0, cells.shape[0], cell_batch):
        cb = cells[start : start + cell_batch]
        corner_idx = cb[:, None, :] + _CORNERS[None]  # [C, 8, 3]
        corner_sdf = sdf[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
        corner_pos = lo + corner_idx.astype(np.float32) * spacing
        tet_pos = corner_pos[:, _TETS, :].reshape(-1, 4, 3)  # [C*6, 4, 3]
        tet_sdf = corner_sdf[:, _TETS].reshape(-1, 4)
        all_tris.append(_tet_triangles(tet_pos, tet_sdf, threshold))

    tris = np.concatenate(all_tris, axis=0)
    # weld duplicate vertices
    flat = tris.reshape(-1, 3)
    quant = np.round(flat / (spacing * 1e-4)).astype(np.int64)
    _, idx, inv = np.unique(quant, axis=0, return_index=True, return_inverse=True)
    verts = flat[idx]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    keep = (
        (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[keep]
