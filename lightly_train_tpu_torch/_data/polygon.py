"""Polygon rasterization with PIL's rules, without PIL.

The JAX package rasterizes COCO and YOLO polygons with
``PIL.ImageDraw.polygon(points, fill=1, outline=1)`` on a mode "1" image;
the card's machine has no PIL, so the port repeats what that call draws
(Pillow's scan-line fill, ``libImaging/Draw.c``), as fitted to Pillow
12.1 and held to it pixel for pixel by ``tests/test_torch_instance_data.py``:

- each vertex is cut to integers, toward zero;
- with ``outline`` equal to ``fill`` only the filled polygon is drawn;
- the edges are built from consecutive vertices, a horizontal edge that
  continues a horizontal edge in the same direction merged into it, and a
  closing edge unless the last vertex is the first;
- a horizontal edge is drawn as its whole span; every other edge, from
  ``(x0, y0)`` to ``(x1, y1)``, gives a float32 crossing ``(y - y0) * dx +
  x0`` on each row it covers but its end row ``y1``, where the crossing is
  ``x1`` itself (twice on its last row, unless that is the polygon's last
  row), and a crossing at a corner where two steep edges of one slope
  direction end is moved to touch the adjacent row's span
  (:func:`_connect_corner`);
- on each row the sorted crossings pair up, and each pair fills the pixels
  from the first rounded half away from zero to the second rounded half
  toward zero, clipped to the image.

Where a polygon passes through one vertex several times (a repeated point
with other edges ending there), PIL's corner rule can differ from this one,
by a few pixels, all in that vertex's row. The tests pin this divergence
(``test_rasterizer_differs_only_in_a_repeated_vertex_row``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

_F32 = np.float32


def _round_half_away(v: float) -> int:
    """To the nearest integer, halves away from 0 (C's ``roundf``)."""
    return int(math.floor(v + 0.5)) if v >= 0.0 else -int(
        math.floor(abs(v) + 0.5))


def _round_half_down(v: float) -> int:
    """To the nearest integer, halves toward 0."""
    return int(math.ceil(v - 0.5)) if v >= 0.0 else -int(
        math.ceil(abs(v) - 0.5))


class _Edge:
    __slots__ = ("xmin", "xmax", "ymin", "ymax", "dx", "x0", "y0", "x1",
                 "y1")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = (_F32(0.0) if y0 == y1
                   else _F32(x1 - x0) / _F32(y1 - y0))
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1

    def at(self, y: int) -> np.float32:
        """The float32 crossing of row ``y``: exact on the end row, so that
        the corner rule sees both edges of a corner meet there."""
        if y == self.y1:
            return _F32(self.x1)
        return _F32(y - self.y0) * self.dx + _F32(self.x0)


def _edges(xy: Sequence[Tuple[int, int]]) -> List[_Edge]:
    edges: List[_Edge] = []
    count = len(xy)
    for i in range(count - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            # A horizontal edge right after another: merged where both run
            # the same way in x.
            last = edges[-1]
            if x1 > x0 > xy[i - 1][0]:
                last.xmax = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                last.xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if xy[-1] != xy[0]:
        edges.append(_Edge(*xy[-1], *xy[0]))
    return edges


def _hline(mask: np.ndarray, x0: int, y: int, x1: int) -> None:
    h, w = mask.shape
    if not 0 <= y < h or x0 >= w or x1 < 0:
        return
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if x0 <= x1:
        mask[y, x0:x1 + 1] = True


def fill_polygon(mask: np.ndarray, points: Sequence[Tuple[float, float]]
                 ) -> None:
    """Fill the polygon through ``points`` ((x, y) pairs) into the bool
    (H, W) ``mask`` as ``ImageDraw.polygon(points, fill=1)`` draws it."""
    if not len(points):
        return
    xy = [(int(x), int(y)) for x, y in points]
    edges = _edges(xy)
    if not edges:
        return
    h = mask.shape[0]
    ymin, ymax = h - 1, 0
    table: List[_Edge] = []
    for e in edges:
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            _hline(mask, e.xmin, e.ymin, e.xmax)
            continue
        table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, h)
    for y in range(ymin, ymax + 1):
        xx: List[np.float32] = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.at(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])
            elif (cur.dx != 0 and len(xx) % 2 == 1
                  and _round_half_away(xx[-1]) == xx[-1]):
                _connect_corner(xx, table, i, cur, y)
        xx.sort()
        for i in range(1, len(xx), 2):
            _hline(mask, _round_half_away(xx[i - 1]), y,
                   _round_half_down(xx[i]))


def _connect_corner(xx: list, table: List[_Edge], i: int, cur: _Edge,
                    y: int) -> None:
    """Where the crossing just added is an integer on a row where ``cur``
    ends and another edge of the same slope direction ends at the same
    crossing, the crossing moves to touch the adjacent row's span (the
    next row, or the previous one on ``cur``'s last row), so that steep
    edges meeting at a corner leave no gap."""
    if y not in (cur.ymin, cur.ymax):
        return
    offset = -1 if y == cur.ymax else 1
    for k, other in enumerate(table):
        if k == i or (cur.dx > 0 and other.dx <= 0) or (
                cur.dx < 0 and other.dx >= 0):
            continue
        if xx[-1] != other.at(y) or y not in (other.ymin, other.ymax):
            continue
        if not other.ymin <= y + offset <= other.ymax:
            continue
        adjacent = cur.at(y + offset)
        adjacent_other = other.at(y + offset)
        if xx[-1] > adjacent + 1 and xx[-1] > adjacent_other + 1:
            xx[-1] = _F32(_round_half_away(max(adjacent, adjacent_other))
                          + 1)
        elif xx[-1] < adjacent - 1 and xx[-1] < adjacent_other - 1:
            xx[-1] = _F32(_round_half_away(min(adjacent, adjacent_other))
                          - 1)
        return


def rasterize_polygons(polys: Sequence[Sequence[float]],
                       hw: Tuple[int, int],
                       scale_xy: Tuple[float, float]) -> np.ndarray:
    """bool (H, W) union of COCO-style flat polygons ``[x0, y0, x1, y1,
    ...]`` scaled by ``scale_xy``; a polygon of fewer than 3 points is
    skipped, as in the JAX package."""
    mask = np.zeros(hw, bool)
    sx, sy = scale_xy
    for poly in polys:
        pts = [(poly[i] * sx, poly[i + 1] * sy)
               for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            fill_polygon(mask, pts)
    return mask
