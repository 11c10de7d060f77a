"""Port native/ (codec, CSR builder, JSON emitter) == the JAX package's.

The port compiles its own copies of the C++ sources with g++ at first use
(dgraph_tpu_torch/build/). Held to the reference:
  * codec bytes equal to the reference's encoding, and the round trips
    of tests/test_native.py;
  * build_csr equal to the reference's numpy builder at
    tests/test_native.py's sizes, and the port StoreBuilder equal with
    and without the native builder;
  * query_bytes through the native emitter equal to the reference's
    over tests/test_query.py's CASES, at device_threshold 0 and 10**9,
    with the emitter serving blocks, and equal to the dict renderer's
    bytes.
Exact everywhere (bytes and integer arrays).
"""

import os

import numpy as np
import pytest
import torch

import dgraph_tpu.native as ref_nat
from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.store.store import _csr_from_pairs_np
from dgraph_tpu_torch import native
from dgraph_tpu_torch.engine import Engine, emit
from dgraph_tpu_torch.store.store import store_from_arrays
from test_query import CASES, build_store

CPU = "cpu"
torch.set_num_threads(1)


def test_library_builds_from_the_sources():
    native.load()
    assert native.built() and native.HAVE_NATIVE and native.HAVE_EMIT
    path = native.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native build failed"):
        native._build(str(tmp_path / "lib.so"))
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 20000])
def test_codec_equals_reference_and_roundtrips(n):
    rng = np.random.default_rng(1)
    uids = (np.unique(rng.integers(0, 1 << 50, n)) if n
            else np.zeros(0, np.int64))
    buf = native.codec_encode(uids)
    assert buf == ref_nat.codec_encode(uids)
    assert np.array_equal(native.codec_decode(buf, len(uids)), uids)


def test_codec_compresses_dense_runs():
    uids = np.arange(10_000, dtype=np.int64) + 5_000_000
    buf = native.codec_encode(uids)
    assert len(buf) < 10_500            # ~1 byte per uid after the first
    assert buf == ref_nat.codec_encode(uids)


def test_codec_rejects_unsorted():
    with pytest.raises(ValueError):
        native.codec_encode(np.array([5, 3, 4], np.int64))


def test_codec_truncated_buffer():
    buf = native.codec_encode(np.array([1, 2, 3], np.int64))
    with pytest.raises(ValueError):
        native.codec_decode(buf[:1], 3)


@pytest.mark.parametrize("m,n", [(0, 5), (1, 1), (5000, 100), (50000, 3000)])
def test_build_csr_equals_reference(m, n):
    rng = np.random.default_rng(m + n)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    indptr, indices = native.build_csr(src, dst, n)
    rel = _csr_from_pairs_np(src, dst, n)
    assert np.array_equal(indptr, rel.indptr)
    assert np.array_equal(indices, rel.indices)


def test_build_csr_rejects_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        native.build_csr(np.array([5], np.int32), np.array([0], np.int32), 3)


def test_store_builder_native_equals_numpy(monkeypatch):
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.store.store import StoreBuilder

    g = ldbc.generate(sf=0.02)

    def build():
        b = StoreBuilder()
        ldbc.load_into(b, g)
        return b.finalize()

    got = build()
    monkeypatch.setattr(native, "HAVE_NATIVE", False)
    want = build()
    for pred, pd in want.preds.items():
        for d in ("fwd", "rev"):
            w, p = getattr(pd, d), getattr(got.preds[pred], d)
            assert (w is None) == (p is None)
            if w is not None:
                assert np.array_equal(w.indptr, p.indptr)
                assert np.array_equal(w.indices, p.indices)


# -- the emitter -----------------------------------------------------------------

@pytest.fixture(scope="module")
def stores():
    ref = build_store()
    return ref, store_from_arrays(ref)


@pytest.mark.parametrize("thresh", [0, 10**9])
@pytest.mark.parametrize("name,query,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_query_bytes_equal_reference(stores, monkeypatch, thresh, name,
                                     query, expected):
    ref, port = stores
    want = RefEngine(ref, device_threshold=thresh).query_bytes(query)
    eng = Engine(port, device=CPU, device_threshold=thresh)
    got = eng.query_bytes(query)
    assert got == want
    # and the dict renderer's compact JSON is the same bytes
    monkeypatch.setattr(native, "HAVE_EMIT", False)
    assert eng.query_bytes(query) == got


def test_emitter_serves_blocks(stores):
    _ref, port = stores
    eng = Engine(port, device=CPU)
    before = dict(emit.COUNTS)
    eng.query_bytes("{ q(func: uid(1)) { name friend { name uid } } }")
    assert emit.COUNTS["native"] == before["native"] + 1
    eng.query_bytes("{ q(func: uid(1)) @normalize { n: name } }")
    assert emit.COUNTS["dict"] == before["dict"] + 1
