"""Geo scalar type + geohash cell index.

Port of `dgraph_tpu/store/geo.py`, whole: GeoJSON Point/Polygon values
wrapped in a hashable `GeoVal` (canonical compact JSON, so set-semantics
dedup and string columns work unchanged), geohash cells at a ladder of
precisions as index tokens, radius and bbox covers for `near`/`within`,
and the exact verifiers after the cell lookup (haversine distance,
point-in-polygon, distance to a polygon), with the per-edge antimeridian
rule shared by the index and the verifiers. Host code: the candidates
are a few cells' posting lists, verified in Python.
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass

_B32 = "0123456789bcdefghjkmnpqrstuvwxyz"
M_PER_DEG_LAT = 111_320.0
# points index at every precision in this ladder; query covers pick the
# finest precision whose cells still dominate the query radius/box
PRECISIONS = (2, 3, 4, 5, 6, 7)
MAX_COVER_CELLS = 96   # bbox covers larger than this fall back to scan


class GeoError(ValueError):
    pass


@dataclass(frozen=True)
class GeoVal:
    """Canonical GeoJSON value (compact-JSON string, hashable)."""

    gj: str

    @functools.cached_property
    def obj(self) -> dict:
        # cached: verify phases call point()/rings() repeatedly per value
        # (cached_property writes to __dict__, bypassing frozen setattr)
        return json.loads(self.gj)

    @property
    def kind(self) -> str:
        return self.obj.get("type", "")

    def point(self) -> tuple[float, float] | None:
        o = self.obj
        if o.get("type") == "Point":
            lon, lat = o["coordinates"][:2]
            return float(lon), float(lat)
        return None

    def rings(self) -> list[list[tuple[float, float]]]:
        """Polygon rings (outer first, then holes); [] for non-polygons."""
        o = self.obj
        if o.get("type") == "Polygon":
            return [[(float(x), float(y)) for x, y in ring]
                    for ring in o["coordinates"]]
        return []

    def __str__(self) -> str:  # export/RDF literal form
        return self.gj


def parse_geo(value) -> GeoVal:
    """GeoJSON from a JSON string, dict, or GeoVal (idempotent)."""
    if isinstance(value, GeoVal):
        return value
    if isinstance(value, str):
        try:
            obj = json.loads(value)
        except json.JSONDecodeError as e:
            raise GeoError(f"invalid GeoJSON string: {e}") from e
    elif isinstance(value, dict):
        obj = value
    else:
        raise GeoError(f"cannot convert {type(value).__name__} to geo")
    def _finite(x) -> bool:
        return isinstance(x, (int, float)) and math.isfinite(x)

    t = obj.get("type")
    if t == "Point":
        c = obj.get("coordinates")
        if (not isinstance(c, (list, tuple)) or len(c) < 2
                or not all(_finite(x) for x in c[:2])):
            raise GeoError("Point needs finite [lon, lat] coordinates")
    elif t == "Polygon":
        rings = obj.get("coordinates")
        if not isinstance(rings, (list, tuple)) or not rings or any(
                len(r) < 4 for r in rings):
            raise GeoError("Polygon needs rings of >= 4 positions")
        # json.loads admits Infinity/NaN literals (and 1e400 → inf);
        # a non-finite longitude would spin unwrap_lons forever, so
        # coordinates are validated finite at the boundary
        for r in rings:
            for p in r:
                if (not isinstance(p, (list, tuple)) or len(p) < 2
                        or not all(_finite(x) for x in p[:2])):
                    raise GeoError(
                        "Polygon positions need finite [lon, lat]")
    else:
        raise GeoError(f"unsupported GeoJSON type {t!r}")
    return GeoVal(json.dumps(obj, separators=(",", ":"), sort_keys=True))


# -- geohash cells ----------------------------------------------------------

def geohash(lon: float, lat: float, precision: int) -> str:
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits = bit_count = 0
    out = []
    even = True
    while len(out) < precision:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits = bits * 2 + 1
                lon_lo = mid
            else:
                bits = bits * 2
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits = bits * 2 + 1
                lat_lo = mid
            else:
                bits = bits * 2
                lat_hi = mid
        even = not even
        bit_count += 1
        if bit_count == 5:
            out.append(_B32[bits])
            bits = bit_count = 0
    return "".join(out)


def cell_dims(precision: int) -> tuple[float, float]:
    """(dlon_degrees, dlat_degrees) of one cell at `precision`."""
    lon_bits = (5 * precision + 1) // 2
    lat_bits = (5 * precision) // 2
    return 360.0 / (1 << lon_bits), 180.0 / (1 << lat_bits)


def _cell_meters(precision: int, lat: float) -> float:
    """Smallest cell dimension in meters at `precision` near `lat`."""
    dlon, dlat = cell_dims(precision)
    w = dlon * M_PER_DEG_LAT * max(math.cos(math.radians(lat)), 0.05)
    h = dlat * M_PER_DEG_LAT
    return min(w, h)


def haversine_m(lon1: float, lat1: float, lon2: float, lat2: float) -> float:
    r = 6_371_000.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + \
        math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(min(1.0, math.sqrt(a)))


def point_tokens(lon: float, lat: float, prefix: str = "pt") -> list[str]:
    """One token per ladder precision for a coordinate. Point and
    polygon tokens live in SEPARATE namespaces ("pt:"/"py:") so polygon
    lookups can scan the whole precision ladder without dragging every
    nearby point in as a candidate."""
    return [f"{prefix}:{p}:{geohash(lon, lat, p)}" for p in PRECISIONS]


def polygon_cover_tokens(min_lon, min_lat, max_lon, max_lat) -> list[str]:
    """bbox-cover tokens per precision, stopping at the first precision
    whose cover exceeds the cap (the coarsest is UNCAPPED so even a
    continent-scale polygon is always reachable through the index)."""
    out = []
    for p in PRECISIONS:
        cells = _bbox_cells(min_lon, min_lat, max_lon, max_lat, p,
                            cap=None if p == PRECISIONS[0] else
                            MAX_COVER_CELLS)
        if cells is None:
            break  # finer precisions only cost more cells
        out.extend(f"py:{p}:{c}" for c in cells)
    return out


def tokens_for_geo(g: GeoVal) -> list[str]:
    """Index tokens: points at every ladder precision; polygons by bbox
    cover per precision (see polygon_cover_tokens). A polygon whose ring
    spans >180° of longitude crosses the antimeridian: its bbox splits
    at ±180 into two covers so index lookups from either side find it."""
    pt = g.point()
    if pt is not None:
        return point_tokens(*pt)
    rings = g.rings()
    if rings:
        xs = [x for x, _ in rings[0]]
        ys = [y for _, y in rings[0]]
        out = []
        for lo, hi in lon_spans(xs):
            out.extend(polygon_cover_tokens(lo, min(ys), hi, max(ys)))
        return sorted(set(out))
    return []


def unwrap_lons(xs: list[float]) -> list[float]:
    """Consecutive ring longitudes made CONTINUOUS: every edge follows
    its shorter longitudinal arc (≤180°), so an antimeridian-crossing
    ring extends past ±180 instead of jumping across the axis. Identity
    for rings whose edges all stay under 180° of longitude."""
    if not xs:
        return []
    out = [xs[0]]
    for x in xs[1:]:
        px = out[-1]
        while x - px > 180.0:
            x -= 360.0
        while x - px < -180.0:
            x += 360.0
        out.append(x)
    return out


def ring_crosses(ring) -> bool:
    """Whether any edge's shorter arc wraps ±180 — the PER-EDGE crossing
    rule shared by indexing (lon_spans) and the exact verifiers
    (point_in_polygon, dist_to_polygon_m), so they can never disagree."""
    return any(abs(x2 - x1) > 180.0
               for (x1, _y1), (x2, _y2) in zip(ring, ring[1:]))


def lon_spans(xs: list[float]) -> list[tuple[float, float]]:
    """Longitude interval(s) of a ring, deciding antimeridian crossing
    PER EDGE (shorter arc): consecutive lons are unwrapped so each step
    takes the arc under 180°. A planar ring that merely spans a wide
    bbox (no single wrapping edge, e.g. lons -100, 0, 100) keeps its
    full (min, max) span; a crossing ring splits into covers at ±180 so
    lookups from either side find it."""
    ux = unwrap_lons(xs)
    lo, hi = min(ux), max(ux)
    if hi - lo >= 360.0:       # wraps the whole axis
        return [(-180.0, 180.0)]
    if lo >= -180.0 and hi <= 180.0:
        return [(lo, hi)]
    if hi > 180.0:
        return [(lo, 180.0), (-180.0, hi - 360.0)]
    return [(lo + 360.0, 180.0), (-180.0, hi)]


def _bbox_cells(min_lon, min_lat, max_lon, max_lat, precision,
                cap=MAX_COVER_CELLS):
    """Cell hashes covering a bbox at `precision`, or None past the cap."""
    dlon, dlat = cell_dims(precision)
    nx = int((max_lon - min_lon) / dlon) + 2
    ny = int((max_lat - min_lat) / dlat) + 2
    if cap is not None and nx * ny > cap:
        return None
    cells = set()
    for i in range(nx):
        for j in range(ny):
            lon = min(min_lon + i * dlon, max_lon)
            lat = min(min_lat + j * dlat, max_lat)
            cells.add(geohash(lon, lat, precision))
    return cells


def cover_near(lon: float, lat: float, meters: float):
    """Tokens covering a radius: finest precision whose cell dimension
    still exceeds the radius, 3x3 block around the center (the circle
    cannot escape the block then). None when even the COARSEST cell is
    smaller than the radius — the caller must fall back to a scan, a
    3x3 block could not contain the circle."""
    if _cell_meters(PRECISIONS[0], lat) < meters:
        return None
    prec = PRECISIONS[0]
    for p in PRECISIONS:
        if _cell_meters(p, lat) >= meters:
            prec = p
        else:
            break
    toks = set()
    # points: the 3x3 block at the radius-matched precision. Polygons:
    # the 3x3 block at EVERY precision up to it — a large polygon's
    # capped cover may only exist at coarser precisions than the query's
    # (its tokens are rare, so the coarse lookups stay cheap).
    for p in PRECISIONS:
        if p > prec:
            break
        dlon, dlat = cell_dims(p)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                # wrap longitude across the antimeridian (a clamp would
                # fold the western neighbor into the easternmost cell)
                lo = ((lon + di * dlon + 180.0) % 360.0) - 180.0
                la = min(max(lat + dj * dlat, -90.0), 90.0)
                toks.add(f"py:{p}:{geohash(lo, la, p)}")
                if p == prec:
                    toks.add(f"pt:{p}:{geohash(lo, la, p)}")
    return toks


def dist_to_polygon_m(lon: float, lat: float,
                      rings: list[list[tuple[float, float]]]) -> float:
    """Distance from a point to a polygon: 0 inside, else the minimum
    distance to any outer-ring edge (local equirectangular projection —
    accurate at query-radius scales)."""
    if point_in_polygon(lon, lat, rings):
        return 0.0
    kx = M_PER_DEG_LAT * max(math.cos(math.radians(lat)), 0.05)
    ky = M_PER_DEG_LAT
    best = math.inf
    # ALL rings: a point inside a hole is closest to the hole's edge.
    # Rings measure in unwrapped longitudes with the query point tried
    # at ALL ±360 shifts — the nearest representation wins whether the
    # RING crosses or the QUERY POINT sits across ±180 from a
    # non-crossing ring (near() wraps its candidate cover, so both
    # shapes reach this verifier).
    for ring in rings:
        xs = unwrap_lons([x for x, _ in ring])
        ys = [y for _, y in ring]
        for k in (-360.0, 0.0, 360.0):
            L = lon + k
            for i in range(len(ring) - 1):
                x1, y1, x2, y2 = xs[i], ys[i], xs[i + 1], ys[i + 1]
                ax, ay = (x1 - L) * kx, (y1 - lat) * ky
                bx, by = (x2 - L) * kx, (y2 - lat) * ky
                dx, dy = bx - ax, by - ay
                L2 = dx * dx + dy * dy
                t = 0.0 if L2 == 0 else max(
                    0.0, min(1.0, -(ax * dx + ay * dy) / L2))
                px, py = ax + t * dx, ay + t * dy
                best = min(best, math.hypot(px, py))
    return best


def cover_bbox(min_lon, min_lat, max_lon, max_lat):
    """Tokens covering a bbox: points at the finest under-cap precision,
    polygons across the ladder (mirrors their capped index cover, which
    always shares at least the uncapped coarsest precision); None →
    caller should scan."""
    if max_lon - min_lon > 180.0:
        # a >180° span means the ring crosses the antimeridian and the
        # naive min/max bbox covers the WRONG side — cells would silently
        # miss every matching value. Force the exact-scan fallback.
        return None
    chosen = None
    for p in PRECISIONS:
        cells = _bbox_cells(min_lon, min_lat, max_lon, max_lat, p)
        if cells is None:
            break
        chosen = (p, cells)
    if chosen is None:
        return None
    p, cells = chosen
    toks = {f"pt:{p}:{c}" for c in cells}
    toks.update(polygon_cover_tokens(min_lon, min_lat, max_lon, max_lat))
    return toks


def point_in_polygon(lon: float, lat: float,
                     rings: list[list[tuple[float, float]]]) -> bool:
    """Ray casting; ring 0 is the outer boundary, the rest are holes.
    Edges follow their SHORTER longitudinal arc (the same per-edge
    antimeridian rule lon_spans indexes by): rings are unwrapped to
    continuous longitudes and the point is tested at lon and lon±360,
    so crossing polygons verify exactly where their index tokens say."""
    def in_ring(ring):
        xs = unwrap_lons([x for x, _ in ring])
        lo, hi = min(xs), max(xs)
        ys = [y for _, y in ring]
        for k in (-360.0, 0.0, 360.0):
            L = lon + k
            if not lo <= L <= hi:
                continue
            inside = False
            j = len(ring) - 1
            for i in range(len(ring)):
                xi, yi = xs[i], ys[i]
                xj, yj = xs[j], ys[j]
                if ((yi > lat) != (yj > lat)) and \
                        L < (xj - xi) * (lat - yi) / (yj - yi) + xi:
                    inside = not inside
                j = i
            if inside:
                return True
        return False

    if not rings or not in_ring(rings[0]):
        return False
    return not any(in_ring(h) for h in rings[1:])
