"""Set-up of LDBC SNB data with GraphRAG embeddings in the port.

The frozen SNB generator (`reference/snb.py`) and the embeddings (one
`torch.Generator` on the device) are made from the seed; the predicates
the configuration lists go into the port's `StoreBuilder` (edges in
bulk, values and vectors one `add_value` each, as the builder takes
them), every generated uid is touched, and the store is served by a
read-only `Alpha` (no WAL) on the device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import rag, snb


class Inputs:
    """The generated graph and embeddings (host copies)."""

    def __init__(self, cfg: dict, seed: int, device: str):
        t0 = time.perf_counter()
        self.device = device
        self.g = snb.generate(sf=float(cfg["sf"]), seed=int(seed))
        self.uids, vecs = snb.embeddings(self.g, int(cfg["dim"]), seed,
                                         device)
        self.vecs = vecs.cpu().numpy()
        self.messages = np.concatenate([self.g.post_uids,
                                        self.g.comment_uids])
        self.phases = {"generate_s": time.perf_counter() - t0}

    def query_vector(self, message_uid: int) -> np.ndarray:
        return self.vecs[message_uid - 1]


class Served(Inputs):
    """The inputs loaded into the port and served by an Alpha."""

    def __init__(self, cfg: dict, seed: int, device: str):
        from dgraph_tpu_torch.server.api import Alpha
        from dgraph_tpu_torch.store.schema import parse_schema
        from dgraph_tpu_torch.store.store import StoreBuilder

        super().__init__(cfg, seed, device)
        t0 = time.perf_counter()
        g, uids = self.g, self.uids
        b = StoreBuilder(parse_schema("\n".join(cfg["schema"])))
        for pred in cfg["predicates"]:
            if pred in ("first_name", "tag_name", "emb"):
                continue
            pairs = getattr(g, pred)
            b.add_edges(pred, pairs[:, 0], pairs[:, 1])
        for i, u in enumerate(g.person_uids.tolist()):
            b.add_value(u, "first_name", g.first_name[i])
        for i, u in enumerate(g.tag_uids.tolist()):
            b.add_value(u, "tag_name", snb.TAG_NAMES[i])
        for u, row in zip(uids.tolist(), self.vecs):
            b.add_value(u, "emb", row)
        b.touch_many(np.arange(1, g.n_nodes + 1, dtype=np.int64))
        t1 = time.perf_counter()
        store = b.finalize()
        t2 = time.perf_counter()
        self.alpha = Alpha(base=store, device=device)
        self.phases.update(add_s=t1 - t0, finalize_s=t2 - t1,
                           alpha_s=time.perf_counter() - t2)

    def query(self, dql: str) -> bytes:
        return self.alpha.query_raw(dql)

    def free(self) -> None:
        self.alpha = None


class Reference:
    def __init__(self, system: Inputs, device: str):
        self.graph = rag.Graph(system.g, snb.TAG_NAMES)
        self.vecs_np = system.vecs
        self.vecs = torch.as_tensor(system.vecs, device=device)
        self.scanner = rag.Scanner(self.vecs)

    def judge(self, requests: list, bodies: list) -> dict:
        return rag.judge(self.graph, self.vecs_np, self.scanner, requests,
                         bodies)

    def control(self, requests: list) -> list:
        return rag.control_bodies(self.graph, self.vecs, self.scanner,
                                  requests)


def build(cfg: dict, seed: int, device: str, traffic: dict) -> Served:
    return Served(cfg, seed, device)


def reference(system: Inputs, device: str) -> Reference:
    return Reference(system, device)
