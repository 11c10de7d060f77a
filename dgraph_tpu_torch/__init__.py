"""PyTorch/CUDA port of dgraph_tpu for NVIDIA Hopper.

The package mirrors `dgraph_tpu/`'s module layout so each module's
counterpart is easy to find. It imports torch and numpy only, never jax
and nothing of `dgraph_tpu`. Two serving paths run end to end, DQL text
in and JSON out: `engine.Engine` serves one query at a time, expanding
large frontiers on the card through torch ops (`ops/hop.py`,
`ops/level.py`, `ops/uidalgebra.py`); `engine.batch.query_batch` packs
compatible `@recurse` queries into lane masks, with every ELL bucket of
every hop computed by the hand-written CUDA kernel in
`csrc/bucket_hop.cu` (wrapper: `ops/bucket_hop.py`). `server/api.Alpha`
is the single-node data server, and `server/http.make_http_server`
serves it over HTTP.
"""

__version__ = "0.1.0"
