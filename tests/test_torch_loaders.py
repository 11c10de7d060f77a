"""The port's bulk and live loaders and exporters against the reference's.

`tests/test_loaders.py`'s loader and export cases run with the port's
objects (the harness of `test_torch_lifecycle.py`), then with the
reference's; their transcripts (loader counts, export counts, query
answers) must be equal. An export of the same store gives the same bytes
from both packages, and both reload to the same store. Tolerance: exact.
"""

import io

import pytest

import dgraph_tpu.server.export as ref_export
import test_loaders
from dgraph_tpu.models import ldbc as ref_ldbc
from dgraph_tpu.server.api import Alpha as RefAlpha
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.loader.bulk import boot_from, run_bulk
from dgraph_tpu_torch.loader.live import run_live
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.server import export
from dgraph_tpu_torch.server.api import Alpha
from test_torch_lifecycle import compare_case
from test_torch_mvcc import assert_stores_equal

CASES = ["test_bulk_load_and_boot", "test_live_load_matches_bulk",
         "test_export_rdf_roundtrip", "test_export_json",
         "test_bulk_multiprocess_map"]


# two loader threads commit in either order: each run's own assertions
# hold, its timestamps are its own
NONDETERMINISTIC = {"test_live_load_matches_bulk"}


@pytest.mark.parametrize("name", CASES)
def test_reference_case_on_port(name, tmp_path, monkeypatch):
    compare_case(test_loaders, name, tmp_path, monkeypatch,
                 nondeterministic=NONDETERMINISTIC)


# templates that read edge facets (IC14's `weight`)
FACET_TEMPLATES = {"IC14"}


@pytest.fixture(scope="module")
def ldbc_stores():
    g = ldbc.generate(sf=0.02, seed=6)
    port = Alpha(device="cpu", device_threshold=10**9)
    ldbc.load_into_alpha(port, g, batch=20_000)
    ref = RefAlpha(device_threshold=10**9)
    ref_ldbc.load_into(ref, g, batch=20_000)
    return g, port.mvcc.rollup(), ref.mvcc.rollup()


@pytest.mark.parametrize("fmt", ["rdf", "json"])
def test_export_bytes_equal_reference(fmt, ldbc_stores):
    _g, port, ref = ldbc_stores
    got, want = io.StringIO(), io.StringIO()
    fn = export.export_rdf if fmt == "rdf" else export.export_json
    rfn = ref_export.export_rdf if fmt == "rdf" else ref_export.export_json
    assert fn(port, got) == rfn(ref, want)
    assert got.getvalue() == want.getvalue()


def test_bulk_and_live_reload_answer_the_ic_mix(ldbc_stores, tmp_path):
    """An RDF export reloads through `run_bulk` (worker processes) and
    `run_live` into stores that answer the IC templates in the same
    bytes as the exported one; the bulk reduce equals the reference's
    (inline map) array for array."""
    from dgraph_tpu.loader.bulk import run_bulk as ref_run_bulk
    from dgraph_tpu.store import checkpoint as ref_checkpoint
    import dgraph_tpu_torch.loader.bulk as bulk

    g, port, _ref = ldbc_stores
    buf = io.StringIO()
    export.export_rdf(port, buf)
    rdf = buf.getvalue()
    old = bulk._MP_MIN_BYTES
    bulk._MP_MIN_BYTES = 1
    try:
        st = run_bulk(rdf, str(tmp_path / "b"), schema_text=ldbc.SCHEMA,
                      n_mappers=2)
    finally:
        bulk._MP_MIN_BYTES = old
    bulked, _ = boot_from(str(tmp_path / "b"))
    live = Alpha(device="cpu", device_threshold=10**9)
    live.alter(ldbc.SCHEMA)
    lst = run_live(live, rdf, batch_size=5000, concurrency=1)
    assert st.nquads == lst.nquads == rdf.count("\n")
    assert lst.aborts == 0
    want = Engine(port, device="cpu", device_threshold=10**9)
    got_b = Engine(bulked, device="cpu", device_threshold=10**9)
    for name, q in ldbc.ic_templates(g).items():
        w = want.query_bytes(q)
        if name in FACET_TEMPLATES:
            # the export format carries no facets (the reference's): the
            # reloads agree with each other, not with the weighted store
            assert got_b.query_bytes(q) == live.query_raw(q), name
            continue
        assert got_b.query_bytes(q) == w, name
        assert live.query_raw(q) == w, name
    ref_run_bulk(rdf, str(tmp_path / "rb"), schema_text=ldbc.SCHEMA,
                 n_mappers=1)
    assert_stores_equal(bulked, ref_checkpoint.load(str(tmp_path / "rb"))[0])
