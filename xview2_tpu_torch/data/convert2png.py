"""xBD GeoJSON label rasterizer: ``labels/*.json`` -> ``targets/*.png`` (the
port's copy of ``xview2_tpu/data/convert2png.py``).

WKT polygons from each label's ``features.xy`` list are filled into a
1024x1024 uint8 mask: 1 for pre-disaster labels, the damage code
(``DAMAGE_DICT``) for post-disaster ones, later polygons over earlier ones.
The JAX module fills with ``cv2.fillPoly``; the port has no OpenCV, so
:func:`fill_poly` is OpenCV's integer scanline fill written out (8-connected
non-antialiased polygons, ``shift = 0``): the edges drawn as 8-connected
Bresenham lines from left to right (clipped to the image), then the
interior spans between pairs of active edges, x in 16.16 fixed point, the
edge slopes truncated toward zero (an edge that leaves the image runs along
its clipped integer end points, upright at the clipped column where the
clipped segment is flat), the span from ``ceil(x1)`` to ``floor(x2)``.  It
equals OpenCV's fill on polygons inside the image, on polygons that reach
or cross its border and on polygons that cross themselves.  PNGs are
written by PIL and the labels converted on a thread pool.

``python -m xview2_tpu_torch.data.convert2png --data SPLIT_DIR``
"""

from __future__ import annotations

import glob
import json
import os
import re
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

DAMAGE_DICT = {"no-damage": 1, "minor-damage": 2, "major-damage": 3,
               "destroyed": 4, "un-classified": 255}

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def wkt_polygon_exterior(wkt: str) -> np.ndarray:
    """The exterior ring of a WKT POLYGON as int32 (N, 2) xy coordinates."""
    wkt = wkt.strip()
    if not wkt.upper().startswith("POLYGON"):
        raise ValueError(f"expected POLYGON WKT, got {wkt[:30]!r}")
    m = re.search(r"\(\(([^()]*)\)", wkt)  # the first ring is the exterior
    if not m:
        raise ValueError(f"malformed WKT: {wkt[:60]!r}")
    pts = []
    for pair in m.group(1).split(","):
        x, y = pair.split()[:2]
        pts.append((float(x), float(y)))
    return np.round(np.array(pts)).astype(np.int32)


def _tdiv(a: int, b: int) -> int:
    """C integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV ``clipLine``: the segment clipped to the image, or None."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color: int) -> None:
    """OpenCV ``Line`` with 8-connectivity: ``LineIterator(leftToRight)``."""
    h, w = img.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    if dy > dx:  # steep: step y every pixel, x when the error goes negative
        err, count = dy - 2 * dx, dy + 1
        x, y = x1, y1
        for _ in range(count):
            img[y, x] = color
            if err < 0:
                x += 1
                err += 2 * dy
            y += sy
            err -= 2 * dx
    else:
        err, count = dx - 2 * dy, dx + 1
        x, y = x1, y1
        for _ in range(count):
            img[y, x] = color
            if err < 0:
                y += sy
                err += 2 * dx
            x += 1
            err -= 2 * dy


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def fill_poly(img: np.ndarray, ring: np.ndarray, color: int) -> None:
    """``cv2.fillPoly(img, [ring], color)`` for one integer ring, in place."""
    h, w = img.shape
    pts = [(int(x), int(y)) for x, y in ring]
    edges = []
    px, py = pts[-1]
    px <<= XY_SHIFT
    for x, y in pts:
        x <<= XY_SHIFT
        t0x, t1x = (px + (XY_ONE >> 1)) >> XY_SHIFT, (x + (XY_ONE >> 1)) >> XY_SHIFT
        _line(img, t0x, py, t1x, y, color)
        # an edge that leaves the image runs through its clipped integer
        # end points; where the clipped segment is flat it keeps the
        # original rows, so it stands upright at the clipped column
        c0x, c0y, c1x, c1y = px, py, x, y
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= py < h and 0 <= y < h):
            clipped = _clip_line(w, h, t0x, py, t1x, y)
            if clipped is not None:
                c0x, c1x = clipped[0] << XY_SHIFT, clipped[2] << XY_SHIFT
                if clipped[1] != clipped[3]:
                    c0y, c1y = clipped[1], clipped[3]
        if py != y:
            dx = _tdiv(c1x - c0x, c1y - c0y)
            if py < y:
                e = _Edge(py, y, c0x + (py - c0y) * dx, dx)
            else:
                e = _Edge(y, py, c1x + (y - c1y) * dx, dx)
            edges.append(e)
        px, py = x, y
    if len(edges) < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge(y0=1 << 62))  # sentinel
    total = len(edges) - 1
    head = _Edge()  # the active list, linked through .next, in x order
    i = 0
    e = edges[0]
    for y in range(e.y0, min(y_max, h)):
        draw = False
        clip = y < 0
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:  # the edge ends here
                prelast.next = last.next
                last = last.next
                continue
            keep = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:  # the next edge starts here
                prelast.next, e.next = e, last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clip:
                    if keep.x > prelast.x:
                        x1, x2 = (prelast.x + XY_ONE - 1) >> XY_SHIFT, keep.x >> XY_SHIFT
                    else:
                        x1, x2 = (keep.x + XY_ONE - 1) >> XY_SHIFT, prelast.x >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = color
                keep.x += keep.dx
                prelast.x += prelast.dx
            draw = not draw
        # one pass of OpenCV's bubble sort by x, with its early exit
        keep_prelast = None
        while True:
            prelast, last = head, head.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next, last.next, te.next = te, te.next, last
                    prelast = te
                    if last_exchange is None:
                        last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is head.next or keep_prelast is head:
                break


def convert_label(json_path: str, mode: str, save_path: str, size: int = 1024) -> None:
    fname = os.path.basename(json_path).replace(".json", ".png")
    with open(json_path) as f:
        payload = json.load(f)
    mask = np.zeros((size, size), np.uint8)
    for feat in payload["features"]["xy"]:
        fill = np.zeros((size, size), np.uint8)
        fill_poly(fill, wkt_polygon_exterior(feat["wkt"]), 1)
        mask[fill > 0] = 1 if mode == "pre" else DAMAGE_DICT[feat["properties"]["subtype"]]
    Image.fromarray(mask).save(os.path.join(save_path, fname), compress_level=9)


def convert_dataset(data_dir: str, workers: int = 0) -> str:
    """Rasterize ``data_dir/labels/*`` into ``data_dir/targets``; returns
    the targets directory.  ``workers``: threads (0: one per CPU)."""
    save_path = os.path.join(data_dir, "targets")
    os.makedirs(save_path, exist_ok=True)
    with ThreadPoolExecutor(workers or os.cpu_count()) as pool:
        for mode in ("pre", "post"):
            files = sorted(glob.glob(os.path.join(data_dir, "labels", f"*{mode}*")))
            list(pool.map(lambda f: convert_label(f, mode, save_path), files))
    return save_path


def main(argv=None) -> int:
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("--data", type=str, required=True,
                        help="Dataset split dir containing labels/")
    parser.add_argument("--n_jobs", type=int, default=0, help="Threads (0: one per CPU)")
    args = parser.parse_args(argv)
    convert_dataset(args.data, args.n_jobs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
