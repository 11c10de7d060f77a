"""Bulk loader: offline map-reduce RDF → checkpointed Store snapshot.

Port of `dgraph_tpu/loader/bulk.py`. The mappers are SPAWNED processes:
a forked child of a process that has CUDA initialised cannot use it, and
one whose torch thread pools are running may deadlock, so the port never
forks; a spawned mapper imports the package and parses its chunk on the
host (no mapper touches the card). Reference parity: `dgraph/cmd/bulk/` — N mapper PROCESSES shard-parse
N-Quads (the map phase is pure-Python lexing, so real processes, not
GIL-bound threads — the role of bulk's mapper goroutines), the
single-process reduce assigns uids and builds CSR blocks + columnar
values (what HBM wants), written via `store.checkpoint.save` as the
snapshot Alphas boot from.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from dataclasses import dataclass

from dgraph_tpu_torch.cluster.oracle import Oracle
from dgraph_tpu_torch.loader.chunker import NQuad, parse_rdf
from dgraph_tpu_torch.loader.xidmap import XidMap
from dgraph_tpu_torch.store import checkpoint
from dgraph_tpu_torch.store.schema import Schema, parse_schema
from dgraph_tpu_torch.store.store import Store, StoreBuilder


@dataclass
class BulkStats:
    nquads: int = 0
    nodes: int = 0
    edges: int = 0
    elapsed_s: float = 0.0


def chunk_lines(text: str, n_chunks: int) -> list[str]:
    """Split N-Quad text on line boundaries into ~equal chunks
    (reference: chunker feeding N mapper goroutines)."""
    lines = text.splitlines()
    per = max(1, -(-len(lines) // max(n_chunks, 1)))
    return ["\n".join(lines[i:i + per]) for i in range(0, len(lines), per)]


def _map_chunk(chunk: str) -> list[NQuad]:
    return parse_rdf(chunk)


# inputs below this skip process startup (tests, tiny loads)
_MP_MIN_BYTES = 1 << 20


def run_bulk(rdf_text: str, out_dir: str, schema_text: str = "",
             n_mappers: int = 4, oracle: Oracle | None = None) -> BulkStats:
    """Map (parallel parse in worker processes) → reduce (uid assignment
    + StoreBuilder finalize) → checkpoint. Returns stats; `out_dir` holds
    the snapshot."""
    t0 = time.perf_counter()
    oracle = oracle or Oracle()
    xm = XidMap(oracle)

    chunks = chunk_lines(rdf_text, n_mappers)
    if n_mappers > 1 and len(rdf_text) >= _MP_MIN_BYTES:
        # spawn, never fork (module docstring): a re-import per worker
        ctx = mp.get_context("spawn")
        with ctx.Pool(processes=min(n_mappers, len(chunks))) as pool:
            parsed: list[list[NQuad]] = pool.map(_map_chunk, chunks)
    else:
        parsed = [parse_rdf(c) for c in chunks]

    schema = parse_schema(schema_text) if schema_text else Schema()
    b = StoreBuilder(schema=schema)
    n = 0
    for batch in parsed:
        for nq in batch:
            n += 1
            s = xm.resolve(nq.subject)
            if nq.object_id is not None:
                b.add_edge(s, nq.predicate, xm.resolve(nq.object_id))
            elif nq.is_star:
                raise ValueError("star deletion invalid in bulk load")
            elif nq.predicate == "dgraph.type":
                b.add_type(s, str(nq.object_value))
            else:
                b.add_value(s, nq.predicate, nq.object_value, nq.lang)
    store = b.finalize()
    os.makedirs(out_dir, exist_ok=True)
    checkpoint.save(store, out_dir, base_ts=0)
    edges = sum(pd.fwd.nnz for pd in store.preds.values()
                if pd.fwd is not None)
    return BulkStats(nquads=n, nodes=store.n_nodes, edges=edges,
                     elapsed_s=time.perf_counter() - t0)


def boot_from(out_dir: str) -> tuple[Store, int]:
    """Load a bulk-produced snapshot (reference: alpha -p dir boot)."""
    return checkpoint.load(out_dir)
