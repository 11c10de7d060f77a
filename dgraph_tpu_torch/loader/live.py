"""Live loader: stream mutations through the transaction path.

Port of `dgraph_tpu/loader/live.py` against the port's in-process
`Alpha`.
Reference parity: `dgraph/cmd/live/run.go` — chunk the input RDF/JSON,
batch N-Quads per mutation, fire batches with bounded concurrency and
abort-retry, xidmap for blank/external ids.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from dgraph_tpu_torch.loader.chunker import parse_rdf
from dgraph_tpu_torch.server.api import Alpha, TxnAborted


@dataclass
class LiveStats:
    nquads: int = 0
    txns: int = 0
    aborts: int = 0
    elapsed_s: float = 0.0


def run_live(alpha: Alpha, rdf_text: str, batch_size: int = 1000,
             concurrency: int = 4, max_retries: int = 5) -> LiveStats:
    """Load N-Quad text through live mutations (reference: live.run)."""
    t0 = time.perf_counter()
    nquads = parse_rdf(rdf_text)
    stats = LiveStats(nquads=len(nquads))

    # batch on subject boundaries so one subject's statements commit
    # together (reference batches arbitrarily; subject-aligned batching
    # avoids cross-batch blank-node references)
    batches: list[list] = []
    cur: list = []
    cur_subjects: set[str] = set()
    for nq in nquads:
        if len(cur) >= batch_size and nq.subject not in cur_subjects:
            batches.append(cur)
            cur, cur_subjects = [], set()
        cur.append(nq)
        cur_subjects.add(nq.subject)
    if cur:
        batches.append(cur)

    # blank nodes must resolve consistently ACROSS batches: pre-assign
    # through the shared xidmap (the reference does exactly this)
    def to_rdf(batch) -> str:
        lines = []
        for nq in batch:
            s = nq.subject
            if s.startswith("_:"):
                s = f"0x{alpha.xidmap.assign(s):x}"
            o = nq.object_id
            if o and o.startswith("_:"):
                o = f"0x{alpha.xidmap.assign(o):x}"
            if nq.is_star:
                lines.append(f"<{s}> <{nq.predicate}> * .")
            elif o is not None:
                lines.append(f"<{s}> <{nq.predicate}> <{o}> .")
            else:
                v = str(nq.object_value).replace("\\", "\\\\").replace(
                    '"', '\\"')
                lit = f'"{v}"'
                if isinstance(nq.object_value, bool):
                    lit = f'"{str(nq.object_value).lower()}"^^<xs:boolean>'
                elif isinstance(nq.object_value, int):
                    lit += "^^<xs:int>"
                elif isinstance(nq.object_value, float):
                    lit += "^^<xs:float>"
                elif nq.lang:
                    lit += f"@{nq.lang}"
                lines.append(f"<{s}> <{nq.predicate}> {lit} .")
        return "\n".join(lines)

    def fire(batch) -> None:
        rdf = to_rdf(batch)
        for attempt in range(max_retries):
            try:
                alpha.mutate(set_nquads=rdf, commit_now=True)
                stats.txns += 1
                return
            except TxnAborted:
                stats.aborts += 1
                time.sleep(0.01 * (attempt + 1))
        raise TxnAborted(f"batch failed after {max_retries} retries")

    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        list(pool.map(fire, batches))
    stats.elapsed_s = time.perf_counter() - t0
    return stats
