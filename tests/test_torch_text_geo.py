"""Text, geo and password features: the port == the JAX package.

Three layers, each held against the reference on the CPU:
  * the tokenizers (Porter stemmer, fulltext, trigram) on the reference
    suite's vectors and on 2,000 seeded random words;
  * `store/geo.py`'s functions on seeded random inputs (geohash, covers,
    point-in-polygon, distances, antimeridian rings); distances agree to
    1e-9 relative;
  * the query scenarios of tests/test_geo.py and tests/test_password.py,
    with the two stores built from the same values through each
    package's own StoreBuilder; the JSON must be equal at
    device_threshold 0 and 10**9, and the errors of the same type.

The scenarios that need mutations, the write-ahead log or checkpoints
(`Alpha`) wait for the port's mutation and durability layers.
"""

import json
import math

import numpy as np
import pytest
import torch

from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.store import geo as RG
from dgraph_tpu.store import tok as rtok
from dgraph_tpu.store import types as rtypes
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.store import geo as G
from dgraph_tpu_torch.store import tok
from dgraph_tpu_torch.store import types as ptypes
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder, store_from_arrays

CPU = "cpu"
torch.set_num_threads(1)
THRESHOLDS = [0, 10**9]
REL = 1e-9    # relative tolerance on distances in meters

GEO_SCHEMA = "name: string @index(exact) .\nloc: geo @index(geo) ."
PLACES = {
    "sf_ferry": (-122.3937, 37.7955),
    "sf_mission": (-122.4148, 37.7599),
    "oakland": (-122.2712, 37.8044),
    "la": (-118.2437, 34.0522),
    "nyc": (-74.0060, 40.7128),
}


def _pt(lon, lat):
    return json.dumps({"type": "Point", "coordinates": [lon, lat]})


def _poly(*rings):
    return json.dumps({"type": "Polygon", "coordinates": list(rings)})


def _stores(schema: str, values):
    """(reference Store, port Store) from the same (uid, pred, value)
    triples, each through its own package's StoreBuilder."""
    rb = RefBuilder(ref_parse_schema(schema))
    pb = StoreBuilder(parse_schema(schema))
    for uid, pred, v in values:
        rb.add_value(uid, pred, v)
        pb.add_value(uid, pred, v)
    return rb.finalize(), pb.finalize()


def _named(schema: str, named_values, pred="loc"):
    vals = []
    for i, (name, v) in enumerate(named_values, start=1):
        vals += [(i, "name", name), (i, pred, v)]
    return _stores(schema, vals)


def _same(stores, q: str) -> dict:
    """The query's JSON, asserted equal across the packages and both
    expansion routes."""
    ref, port = stores
    want = json.dumps(RefEngine(ref, device_threshold=10**9).query(q))
    for t in THRESHOLDS:
        got = Engine(port, device=CPU, device_threshold=t).query(q)
        assert json.dumps(got) == want, (t, q)
    return json.loads(want)


def _names(out):
    return [r["name"] for r in out["q"]]


def _raises_same(stores, q: str):
    ref, port = stores
    with pytest.raises(Exception) as want:
        RefEngine(ref, device_threshold=10**9).query(q)
    with pytest.raises(Exception) as got:
        Engine(port, device=CPU, device_threshold=10**9).query(q)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    return got.value


# -- tokenizers ---------------------------------------------------------------

STEM_VECTORS = {
    "caresses": "caress", "ponies": "poni", "ties": "ti",
    "cats": "cat", "feed": "feed", "agreed": "agre",
    "plastered": "plaster", "motoring": "motor", "sing": "sing",
    "hopping": "hop", "falling": "fall", "filing": "file",
    "happy": "happi", "sky": "sky", "relational": "relat",
    "conditional": "condit", "rational": "ration",
    "digitizer": "digit", "vietnamization": "vietnam",
    "operator": "oper", "feudalism": "feudal",
    "decisiveness": "decis", "hopefulness": "hope",
    "triplicate": "triplic", "formative": "form",
    "electriciti": "electr", "electrical": "electr",
    "hopeful": "hope", "goodness": "good", "allowance": "allow",
    "inference": "infer", "adjustable": "adjust",
    "replacement": "replac", "adoption": "adopt",
    "activate": "activ", "effective": "effect",
    "controlling": "control", "generalization": "gener",
}

TEXTS = [
    "Hello, WORLD—café!", "The running dogs are jumping", "running",
    "RUNNING", "relational databases", "relate database",
    "you've been doing it again", "it isn't here, don't worry",
    "the dog's bone", "abcd", "ab", "", "Ünïcödé naïve façade",
]


@pytest.mark.parametrize("word", sorted(STEM_VECTORS))
def test_porter_stemmer_vectors(word):
    assert tok._stem(word) == rtok._stem(word) == STEM_VECTORS[word]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizers_on_reference_vectors(text):
    for name in ("exact", "hash", "term", "fulltext", "trigram"):
        assert tok.tokens_for(name, text) == rtok.tokens_for(name, text), \
            (name, text)


_SUFFIXES = ["", "s", "es", "ies", "sses", "ed", "eed", "ing", "ational",
             "tional", "enci", "anci", "izer", "abli", "alli", "entli",
             "eli", "ousli", "ization", "ation", "ator", "alism", "iveness",
             "fulness", "ousness", "aliti", "iviti", "biliti", "logi",
             "icate", "ative", "alize", "iciti", "ical", "ful", "ness",
             "al", "ance", "ence", "er", "ic", "able", "ible", "ant",
             "ement", "ment", "ent", "ion", "sion", "tion", "ou", "ism",
             "ate", "iti", "ous", "ive", "ize", "e", "ll", "y", "'s"]


def _random_words(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyzaeiouy"))
    out = []
    for _ in range(n):
        stem = "".join(rng.choice(letters, int(rng.integers(1, 9))))
        out.append(stem + _SUFFIXES[int(rng.integers(len(_SUFFIXES)))])
    return out


def test_tokenizers_on_random_words():
    words = _random_words(2000, seed=31)
    for w in words:
        assert tok._stem(w) == rtok._stem(w), w
    for i in range(0, len(words), 5):
        text = " ".join(words[i:i + 5]).title()
        for name in ("term", "fulltext", "trigram"):
            assert tok.tokens_for(name, text) == \
                rtok.tokens_for(name, text), (name, text)


def test_geo_tokens_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        lon, lat = rng.uniform(-180, 180), rng.uniform(-85, 85)
        assert tok.tokens_for("geo", _pt(lon, lat)) == \
            rtok.tokens_for("geo", _pt(lon, lat))
    for ring in _random_rings(rng, 50):
        assert tok.tokens_for("geo", _poly(ring)) == \
            rtok.tokens_for("geo", _poly(ring))


def test_unknown_tokenizer_raises_as_reference():
    for mod in (tok, rtok):
        with pytest.raises(ValueError, match="unknown tokenizer"):
            mod.tokens_for("soundex", "x")


# -- geo functions --------------------------------------------------------------

def _random_rings(rng, n: int, crossing_share: float = 0.3):
    """Closed star-shaped rings around random centres; a share of them
    centred on the antimeridian so their edges wrap ±180."""
    rings = []
    for _ in range(n):
        cx = (180.0 if rng.random() < crossing_share
              else float(rng.uniform(-170, 170)))
        cy = float(rng.uniform(-60, 60))
        k = int(rng.integers(3, 9))
        ang = np.sort(rng.uniform(0, 2 * math.pi, k))
        rad = rng.uniform(0.2, 4.0, k)
        ring = []
        for a, r in zip(ang, rad):
            x = cx + r * math.cos(a)
            x = ((x + 180.0) % 360.0) - 180.0
            ring.append([x, cy + r * math.sin(a)])
        ring.append(list(ring[0]))
        rings.append(ring)
    return rings


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def test_geohash_cells_and_haversine_match_reference():
    rng = np.random.default_rng(7)
    for _ in range(500):
        lon, lat = rng.uniform(-180, 180), rng.uniform(-90, 90)
        p = int(rng.integers(1, 10))
        assert G.geohash(lon, lat, p) == RG.geohash(lon, lat, p)
        assert G.point_tokens(lon, lat) == RG.point_tokens(lon, lat)
        lon2, lat2 = rng.uniform(-180, 180), rng.uniform(-90, 90)
        assert _close(G.haversine_m(lon, lat, lon2, lat2),
                      RG.haversine_m(lon, lat, lon2, lat2))
    for p in range(1, 10):
        assert G.cell_dims(p) == RG.cell_dims(p)


def test_covers_match_reference():
    rng = np.random.default_rng(8)
    for _ in range(300):
        lon, lat = rng.uniform(-180, 180), rng.uniform(-80, 80)
        meters = float(10 ** rng.uniform(1, 6.2))
        assert G.cover_near(lon, lat, meters) == \
            RG.cover_near(lon, lat, meters)
        w, h = 10 ** rng.uniform(-3, 2.5), 10 ** rng.uniform(-3, 1.5)
        box = (lon, lat, lon + w, min(lat + h, 90.0))
        assert G.cover_bbox(*box) == RG.cover_bbox(*box)
        assert G.polygon_cover_tokens(*box) == \
            RG.polygon_cover_tokens(*box)


def test_polygon_verifiers_match_reference():
    rng = np.random.default_rng(9)
    rings = _random_rings(rng, 60)
    hits = 0
    for ring in rings:
        outer = [(x, y) for x, y in ring]
        xs, ys = [x for x, _ in outer], [y for _, y in outer]
        assert G.ring_crosses(outer) == RG.ring_crosses(outer)
        assert G.lon_spans(xs) == RG.lon_spans(xs)
        assert G.unwrap_lons(xs) == RG.unwrap_lons(xs)
        for _ in range(25):
            # points near the ring: inside, outside, across ±180
            x = xs[0] + float(rng.uniform(-6, 6))
            x = ((x + 180.0) % 360.0) - 180.0
            y = ys[0] + float(rng.uniform(-6, 6))
            inside = G.point_in_polygon(x, y, [outer])
            assert inside == RG.point_in_polygon(x, y, [outer])
            hits += inside
            assert _close(G.dist_to_polygon_m(x, y, [outer]),
                          RG.dist_to_polygon_m(x, y, [outer]))
    assert hits > 0


def test_polygon_hole_distance_matches_reference():
    outer = [(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0)]
    hole = [(0.1, 0.1), (0.1, 0.9), (0.9, 0.9), (0.9, 0.1), (0.1, 0.1)]
    assert not G.point_in_polygon(0.5, 0.5, [outer, hole])
    d = G.dist_to_polygon_m(0.11, 0.5, [outer, hole])
    assert d < 2_000
    assert _close(d, RG.dist_to_polygon_m(0.11, 0.5, [outer, hole]))


def test_antimeridian_rings_match_reference():
    crossing = [[179.0, -1.0], [-179.0, -1.0], [-179.0, 1.0],
                [179.0, 1.0], [179.0, -1.0]]
    assert G.cover_bbox(-179.0, -1.0, 179.0, 1.0) is None
    assert G.lon_spans([179.0, -179.0, -179.5, 179.5]) == \
        RG.lon_spans([179.0, -179.0, -179.5, 179.5]) == \
        [(179.0, 180.0), (-180.0, -179.0)]
    gv = G.parse_geo(_poly(crossing))
    assert G.tokens_for_geo(gv) == RG.tokens_for_geo(RG.parse_geo(
        _poly(crossing)))
    for x in (179.5, -179.5, 180.0, 0.0):
        assert G.point_in_polygon(x, 0.0, [crossing]) == \
            RG.point_in_polygon(x, 0.0, [crossing])
    assert _close(G.dist_to_polygon_m(-178.0, 0.0, [crossing]),
                  RG.dist_to_polygon_m(-178.0, 0.0, [crossing]))


@pytest.mark.parametrize("bad", [
    '{"type": "Point", "coordinates": [1e400, 0.0]}',
    '{"type": "Point", "coordinates": [NaN, 0.0]}',
    '{"type": "Polygon", "coordinates": '
    '[[[1e400, 0.0], [1.0, 0.0], [1.0, 1.0], [1e400, 0.0]]]}',
    'not json', '{"type": "Nope"}', '{"type": "Polygon", "coordinates": []}',
])
def test_invalid_geojson_rejected_as_reference(bad):
    with pytest.raises(G.GeoError) as got:
        G.parse_geo(bad)
    with pytest.raises(RG.GeoError) as want:
        RG.parse_geo(bad)
    assert str(got.value) == str(want.value)
    b = StoreBuilder(parse_schema(GEO_SCHEMA))
    b.add_value(1, "loc", bad)
    with pytest.raises(G.GeoError):
        b.finalize()


def test_parse_geo_canonical_text_matches_reference():
    for v in (_pt(1.5, -2.25), {"coordinates": [3, 4], "type": "Point"},
              _poly([[0, 0], [0, 1], [1, 1], [0, 0]])):
        assert G.parse_geo(v).gj == RG.parse_geo(v).gj
        assert ptypes.convert(v, ptypes.Kind.GEO) == G.parse_geo(v)


# -- geo queries ------------------------------------------------------------------

@pytest.fixture(scope="module")
def places():
    return _named(GEO_SCHEMA, [(n, _pt(*ll)) for n, ll in PLACES.items()])


@pytest.mark.parametrize("radius,want", [
    (10000, ["sf_ferry", "sf_mission"]),
    (20000, ["oakland", "sf_ferry", "sf_mission"]),
    (10, ["sf_ferry"]),
    (700000, ["la", "oakland", "sf_ferry", "sf_mission"]),
])
def test_near_query(places, radius, want):
    lon, lat = PLACES["sf_ferry"]
    out = _same(places, '{ q(func: near(loc, [%f, %f], %d), orderasc: name)'
                ' { name } }' % (lon, lat, radius))
    assert _names(out) == want


def test_within_query(places):
    ring = [[-122.52, 37.70], [-122.52, 37.84],
            [-122.35, 37.84], [-122.35, 37.70], [-122.52, 37.70]]
    out = _same(places, '{ q(func: within(loc, %s), orderasc: name) '
                '{ name } }' % json.dumps([ring]))
    assert _names(out) == ["sf_ferry", "sf_mission"]


def test_geo_renders_as_geojson(places):
    out = _same(places, '{ q(func: eq(name, "nyc")) { name loc } }')
    assert out["q"][0]["loc"] == {"type": "Point",
                                  "coordinates": [-74.006, 40.7128]}


@pytest.mark.parametrize("q", [
    '{ q(func: near(loc, 5, 10)) { name } }',
    '{ q(func: within(loc, [1, 2])) { name } }',
    '{ q(func: within(loc, [])) { name } }',
    '{ q(func: contains(loc, 7)) { name } }',
])
def test_malformed_geo_args_raise_as_reference(places, q):
    assert isinstance(_raises_same(places, q), ValueError)


def test_contains_query_on_stored_polygon():
    bay = [[-123.0, 37.0], [-123.0, 38.5], [-121.5, 38.5], [-121.5, 37.0],
           [-123.0, 37.0]]
    far = [[10.0, 10.0], [10.0, 11.0], [11.0, 11.0], [11.0, 10.0],
           [10.0, 10.0]]
    s = _named(GEO_SCHEMA, [("bay_area", _poly(bay)),
                            ("elsewhere", _poly(far))])
    lon, lat = PLACES["sf_ferry"]
    assert _names(_same(s, '{ q(func: contains(loc, [%f, %f])) { name } }'
                        % (lon, lat))) == ["bay_area"]
    assert _same(s, '{ q(func: contains(loc, [0.0, 0.0])) { name } }') == \
        {"q": []}


def test_near_matches_bruteforce_random():
    rng = np.random.default_rng(4)
    pts = [(float(rng.uniform(-10, 10)), float(rng.uniform(40, 55)))
           for _ in range(300)]
    s = _named(GEO_SCHEMA, [(f"p{i}", _pt(*p)) for i, p in enumerate(pts)])
    for clon, clat, radius in [(0.0, 47.0, 50_000), (5.0, 50.0, 200_000),
                               (-8.0, 42.0, 500_000), (3.0, 44.0, 5_000)]:
        out = _same(s, '{ q(func: near(loc, [%f, %f], %d)) { name } }'
                    % (clon, clat, radius))
        want = sorted(f"p{i}" for i, (lon, lat) in enumerate(pts)
                      if G.haversine_m(clon, clat, lon, lat) <= radius)
        assert sorted(_names(out)) == want


def test_near_wraps_antimeridian():
    s = _named(GEO_SCHEMA, [("west", _pt(-179.99, 0.0))])
    assert _names(_same(s, '{ q(func: near(loc, [179.99, 0.0], 10000)) '
                        '{ name } }')) == ["west"]


def test_near_and_within_match_stored_polygons():
    ring = [[-122.5, 37.7], [-122.5, 37.85], [-122.35, 37.85],
            [-122.35, 37.7], [-122.5, 37.7]]
    s = _named(GEO_SCHEMA, [("sf_poly", _poly(ring))])
    for lon, r, want in [(-122.40, 1000, ["sf_poly"]),
                         (-122.29, 10000, ["sf_poly"]),
                         (-122.29, 1000, [])]:
        out = _same(s, '{ q(func: near(loc, [%f, 37.78], %d)) { name } }'
                    % (lon, r))
        assert _names(out) == want
    big = [[-123.0, 37.0], [-123.0, 38.5], [-121.5, 38.5],
           [-121.5, 37.0], [-123.0, 37.0]]
    small = [[-122.45, 37.0], [-122.45, 38.5], [-121.5, 38.5],
             [-121.5, 37.0], [-122.45, 37.0]]
    assert _names(_same(s, '{ q(func: within(loc, %s)) { name } }'
                        % json.dumps([big]))) == ["sf_poly"]
    assert _same(s, '{ q(func: within(loc, %s)) { name } }'
                 % json.dumps([small])) == {"q": []}


def test_near_finds_polygon_indexed_only_at_coarse_precision():
    ring = [[0.0, 0.0], [0.0, 1.5], [1.5, 1.5], [1.5, 0.0], [0.0, 0.0]]
    s = _named(GEO_SCHEMA, [("zone", _poly(ring))])
    assert _names(_same(s, '{ q(func: near(loc, [0.75, 0.75], 1000)) '
                        '{ name } }')) == ["zone"]


def test_polygon_with_hole_queries():
    outer = [[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0], [0.0, 0.0]]
    hole = [[0.1, 0.1], [0.1, 0.9], [0.9, 0.9], [0.9, 0.1], [0.1, 0.1]]
    s = _named(GEO_SCHEMA, [("donut", _poly(outer, hole))])
    assert _same(s, '{ q(func: contains(loc, [0.5, 0.5])) { name } }') == \
        {"q": []}
    assert _names(_same(s, '{ q(func: contains(loc, [0.05, 0.5])) '
                        '{ name } }')) == ["donut"]
    assert _names(_same(s, '{ q(func: near(loc, [0.11, 0.5], 2000)) '
                        '{ name } }')) == ["donut"]


def test_antimeridian_contains_end_to_end():
    crossing = [[179.0, -1.0], [-179.0, -1.0], [-179.0, 1.0],
                [179.0, 1.0], [179.0, -1.0]]
    planar = [[-100.0, -5.0], [0.0, -5.0], [100.0, -5.0], [100.0, 5.0],
              [0.0, 5.0], [-100.0, 5.0], [-100.0, -5.0]]
    s = _named(GEO_SCHEMA, [("crossing", _poly(crossing)),
                            ("planar", _poly(planar))])
    for lon, lat, want in [(179.5, 0.0, ["crossing"]),
                           (-179.5, 0.0, ["crossing"]),
                           (0.0, 0.0, ["planar"]), (-99.0, 0.0, ["planar"]),
                           (0.5, 0.5, ["planar"]),
                           (179.5, 0.4, ["crossing"])]:
        out = _same(s, '{ q(func: contains(loc, [%s, %s]), orderasc: name)'
                    ' { name } }' % (lon, lat))
        assert _names(out) == want


def test_near_across_antimeridian_to_noncrossing_polygon():
    ring = [[175.0, -1.0], [180.0, -1.0], [180.0, 1.0], [175.0, 1.0],
            [175.0, -1.0]]
    s = _named(GEO_SCHEMA, [("edge", _poly(ring))])
    assert _names(_same(s, '{ q(func: near(loc, [-179.5, 0.0], 100000)) '
                        '{ name } }')) == ["edge"]


def test_within_concave_polygon_rejects_bulging_edge():
    u_ring = [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [6.0, 10.0],
              [6.0, 2.0], [4.0, 2.0], [4.0, 10.0], [0.0, 10.0], [0.0, 0.0]]
    bar = [[1.0, 4.9], [9.0, 4.9], [9.0, 5.1], [1.0, 5.1], [1.0, 4.9]]
    left = [[1.0, 4.0], [3.0, 4.0], [3.0, 6.0], [1.0, 6.0], [1.0, 4.0]]
    s = _named(GEO_SCHEMA, [("bar", _poly(bar)), ("left", _poly(left))])
    out = _same(s, '{ q(func: within(loc, %s), orderasc: name) { name } }'
                % json.dumps([u_ring]))
    assert _names(out) == ["left"]


def test_geo_without_index_scans_as_reference():
    s = _named("name: string @index(exact) .\nloc: geo .",
               [(n, _pt(*ll)) for n, ll in PLACES.items()])
    lon, lat = PLACES["sf_ferry"]
    out = _same(s, '{ q(func: near(loc, [%f, %f], 20000), orderasc: name)'
                ' { name } }' % (lon, lat))
    assert _names(out) == ["oakland", "sf_ferry", "sf_mission"]


def test_geo_store_carried_with_store_from_arrays(places):
    ref, _port = places
    carried = store_from_arrays(ref)
    col = carried.value_col("loc", "")
    assert all(isinstance(v, G.GeoVal) for v in col.vals)
    _same((ref, carried), '{ q(func: near(loc, [-122.3937, 37.7955], '
          '20000), orderasc: name) { name loc } }')


# -- text queries -------------------------------------------------------------------

TEXT_SCHEMA = ("name: string @index(exact, term, trigram, fulltext) .\n"
               "bio: string @index(fulltext) .\nplain: string .")
BIOS = ["The running dogs are jumping over relational databases",
        "A dog's bone, buried by the conditional rationalist",
        "Kenji likes hopping and falling; Yang relates stories",
        "you've been doing it again", "electrical operators digitize",
        "Marla and Marlo argued about formative generalizations"]
NAMES = ["Marla Singer", "Marlo Stanfield", "Kenji Yang", "Sofia Ma",
         "Mark Mayer", "Yangs Kenji"]


@pytest.fixture(scope="module")
def texts():
    vals = []
    for i, (n, b) in enumerate(zip(NAMES, BIOS), start=1):
        vals += [(i, "name", n), (i, "bio", b), (i, "plain", b)]
    return _stores(TEXT_SCHEMA, vals)


@pytest.mark.parametrize("q", [
    '{ q(func: anyoftext(bio, "dog jumps")) { name } }',
    '{ q(func: alloftext(bio, "relate stories")) { name } }',
    '{ q(func: anyoftext(name, "yangs kenji")) { name } }',
    '{ q(func: alloftext(bio, "the of")) { name } }',
    '{ q(func: regexp(name, /^(Ma|So)/)) { name } }',
    '{ q(func: regexp(name, /yang/i)) { name } }',
    '{ q(func: regexp(plain, /dog/)) { name } }',
    '{ q(func: match(name, "Marla", 2)) { name } }',
    '{ q(func: match(name, "Yang", 1)) { name } }',
    '{ q(func: has(name)) @filter(anyoftext(bio, "hop")) { name } }',
    '{ q(func: has(name)) @filter(match(name, "Marks", 1)) { name } }',
])
def test_text_queries_equal_reference(texts, q):
    _same(texts, q)


def test_text_query_results(texts):
    assert _names(_same(texts, '{ q(func: anyoftext(name, "yangs kenji")) '
                        '{ name } }')) == ["Kenji Yang", "Yangs Kenji"]
    assert _names(_same(texts, '{ q(func: match(name, "Marla", 2)) '
                        '{ name } }')) == ["Marla Singer", "Marlo Stanfield",
                                           "Mark Mayer"]


def test_text_without_index_raises_as_reference(texts):
    err = _raises_same(texts, '{ q(func: anyoftext(plain, "dog")) '
                       '{ name } }')
    assert "fulltext" in str(err)


# -- passwords ------------------------------------------------------------------------

PW_SCHEMA = "name: string @index(exact) .\npass: password ."


def test_password_hashes_verify_across_packages():
    port_hash = ptypes.hash_password("s3cret")
    ref_hash = rtypes.hash_password("s3cret")
    assert "s3cret" not in port_hash and "$" in port_hash
    assert rtypes.check_password("s3cret", port_hash)
    assert ptypes.check_password("s3cret", ref_hash)
    assert not rtypes.check_password("wrong", port_hash)
    assert not ptypes.check_password("wrong", ref_hash)
    assert not ptypes.check_password("s3cret", "not-a-hash")


@pytest.fixture(scope="module")
def passwords():
    return _stores(PW_SCHEMA, [
        (1, "name", "alice"), (1, "pass", ptypes.hash_password("s3cret")),
        (2, "name", "bob"), (2, "pass", rtypes.hash_password("hunter2")),
        (3, "name", "nopass")])


@pytest.mark.parametrize("who,pw,want", [
    ("alice", "s3cret", True), ("alice", "wrong", False),
    ("bob", "hunter2", True), ("bob", "s3cret", False),
    ("nopass", "x", False),
])
def test_checkpwd_equals_reference(passwords, who, pw, want):
    out = _same(passwords, '{ q(func: eq(name, "%s")) '
                '{ name checkpwd(pass, "%s") } }' % (who, pw))
    assert out["q"] == [{"name": who, "checkpwd(pass)": want}]
    out = _same(passwords, '{ q(func: eq(name, "%s")) '
                '{ ok: checkpwd(pass, "%s") } }' % (who, pw))
    assert out["q"] == [{"ok": want}]


@pytest.mark.parametrize("leaf", ["pass", "pass@*"])
def test_password_hash_never_renders(passwords, leaf):
    out = _same(passwords, '{ q(func: eq(name, "alice")) { name %s } }'
                % leaf)
    assert out["q"] == [{"name": "alice"}]
