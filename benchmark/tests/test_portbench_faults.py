"""A run with the timed path broken underneath comes out not correct,
once for each fault its cell can have (one chip: no exchange between
chips to leave out)."""

import torch

from benchmark.tests.conftest import tiny_run

G500 = "graph500-s20.recurse4-l4096"
RAG = "snb-sf1-rag.knn-c8"


def test_a_sound_run_is_correct():
    assert tiny_run(G500)["correct"] and tiny_run(RAG)["correct"]


def test_a_hop_that_returns_its_state_unchanged(monkeypatch):
    from dgraph_tpu_torch.ops import bfs

    def stuck(prepared, frontier, hop=None, *, flags=None, seen=None,
              out_flags=None, out=None):
        if out_flags is not None and flags is not None:
            out_flags.copy_(flags)
        return frontier.clone()

    monkeypatch.setattr(bfs, "_ell_hop", stuck)
    res = tiny_run(G500)
    assert not res["correct"] and res["checks"]["lanes_off"]["value"] > 0


def test_half_the_lanes_left_out(monkeypatch):
    from dgraph_tpu_torch.ops import bfs
    real = bfs.pack_seed_masks

    def half(g, rank_lists, word_bits=32):
        m = real(g, rank_lists, word_bits)
        m[:, m.shape[1] // 2:] = 0
        return m

    monkeypatch.setattr(bfs, "pack_seed_masks", half)
    res = tiny_run(G500)
    assert not res["correct"] and res["checks"]["lanes_off"]["value"] > 0


def test_a_count_altered_where_it_is_produced(monkeypatch):
    from dgraph_tpu_torch.ops import bfs
    real = bfs.make_ell_count

    def altered(outdeg, n, device="cpu"):
        count = real(outdeg, n, device)

        def one_off(last, seen):
            c = count(last, seen)
            c[0] += 1
            return c
        return one_off

    monkeypatch.setattr(bfs, "make_ell_count", altered)
    res = tiny_run(G500)
    assert not res["correct"] and res["checks"]["lanes_off"]["value"] > 0


def _topk_patch(monkeypatch, wrap):
    from dgraph_tpu_torch.engine import fused
    from dgraph_tpu_torch.store import vec
    real = vec.device_topk
    monkeypatch.setattr(vec, "device_topk", wrap(real))
    monkeypatch.setattr(fused, "device_topk", wrap(real))


def test_seeds_that_are_not_the_nearest(monkeypatch):
    def wrap(real):
        return lambda subj, vecs, q, k, out_cap=None: real(subj, vecs, -q, k,
                                                           out_cap)
    _topk_patch(monkeypatch, wrap)
    res = tiny_run(RAG)
    assert not res["correct"] and res["checks"]["knn_gap"]["value"] > 0.01


def test_half_the_seeds_left_out(monkeypatch):
    def wrap(real):
        def half(subj, vecs, q, k, out_cap=None):
            top = real(subj, vecs, q, k, out_cap).clone()
            top[k // 2:k] = top[0]          # the second half: the first seed
            return torch.sort(top).values
        return half
    _topk_patch(monkeypatch, wrap)
    res = tiny_run(RAG)
    assert not res["correct"] and res["checks"]["mismatched"]["value"] > 0


def test_a_mean_altered_where_it_is_produced(monkeypatch):
    from dgraph_tpu_torch.engine import feat as engine_feat
    from dgraph_tpu_torch.ops import feat
    real = feat.segment_combine

    def skewed(*args, **kw):
        out, cnt, ecnt = real(*args, **kw)
        return out * (1 + 1e-3), cnt, ecnt

    monkeypatch.setattr(feat, "segment_combine", skewed)
    monkeypatch.setattr(engine_feat, "segment_combine", skewed)
    res = tiny_run(RAG)
    assert not res["correct"] and res["checks"]["mean_err"]["value"] > 1e-5


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from dgraph_tpu_torch.server.api import Alpha
    real = Alpha.query_raw

    def altered(self, dql, *a, **kw):
        body = real(self, dql, *a, **kw)
        return body.replace(b'"uid":"0x', b'"uid":"0x1', 1)

    monkeypatch.setattr(Alpha, "query_raw", altered)
    res = tiny_run(RAG)
    assert not res["correct"]
    assert (res["checks"]["mismatched"]["value"] > 0
            or res["checks"]["knn_gap"]["value"] > 0)


def test_a_request_that_raises_is_failed(monkeypatch):
    from dgraph_tpu_torch.server.api import Alpha
    real = Alpha.query_raw
    calls = [0]

    def flaky(self, dql, *a, **kw):
        calls[0] += 1
        if calls[0] % 7 == 0:
            raise RuntimeError("injected")
        return real(self, dql, *a, **kw)

    monkeypatch.setattr(Alpha, "query_raw", flaky)
    res = tiny_run(RAG)
    assert not res["correct"] and res["failed"] > 0
