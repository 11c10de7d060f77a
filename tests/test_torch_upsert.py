"""The port's upserts against the reference's.

`tests/test_upsert.py`'s cases (parse, condition trees, substitution,
the RDF and JSON upsert forms through `Alpha`, conflicting concurrent
upserts) run with the port's objects (the harness of
`test_torch_lifecycle.py`), then with the reference's; their transcripts
(every upsert's and query's result) must be equal. The get-or-create
upserts of `tools/write_mix.py` run on both packages' Alphas over LDBC
and answer the same. Tolerance: exact.
"""

import pytest

import dgraph_tpu.server.api as ref_api
import test_upsert
from dgraph_tpu.models import ldbc as ref_ldbc
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.tools import write_mix
from test_torch_lifecycle import compare_case, reference_cases

# the HTTP forms run with the front end's cases (tests/test_torch_http.py)
SKIP = {"test_http_upsert_paths", "test_http_json_list"}
CASES = reference_cases(test_upsert, SKIP)


@pytest.mark.parametrize("name", CASES)
def test_reference_case_on_port(name, tmp_path, monkeypatch):
    compare_case(test_upsert, name, tmp_path, monkeypatch)


def test_case_list_covers_the_issue():
    assert len(CASES) == 11


@pytest.fixture(scope="module")
def ldbc_pair():
    g = ldbc.generate(sf=0.02, seed=4)
    port = Alpha(device="cpu", device_threshold=10**9)
    ldbc.load_into_alpha(port, g, batch=20_000)
    ref = ref_api.Alpha(device_threshold=10**9)
    ref_ldbc.load_into(ref, g, batch=20_000)
    return g, port, ref


def test_tag_upserts_match_reference(ldbc_pair):
    """The get-or-create tag upserts (half on existing tags, half
    creating one) give both packages the same results, uids and
    read-backs (timestamps aside: the two loaders spend different
    numbers)."""
    g, port, ref = ldbc_pair
    ops = write_mix.tag_upserts(g, 40, seed=2)
    assert sum(op.creates for op in ops) == 20
    for op in ops:
        got = port.upsert(op.src)
        want = ref.upsert(op.src)
        # the two loaders spent different numbers of timestamps
        gt, wt = got.pop("txn"), want.pop("txn")
        assert gt["commit_ts"] > gt["start_ts"] and \
            wt["commit_ts"] > wt["start_ts"]
        assert got == want
        assert got["applied"] == 1
        assert port.query(op.check) == ref.query(op.check)
        assert write_mix.upsert_took(port.query(op.check), op)
