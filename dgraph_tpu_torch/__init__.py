"""PyTorch/CUDA port of dgraph_tpu for NVIDIA Hopper.

The package mirrors `dgraph_tpu/`'s module layout so each module's
counterpart is easy to find. It imports torch and numpy only, never jax
and nothing of `dgraph_tpu`. The batched `@recurse` serving path runs
end to end: `engine.batch.query_batch` takes DQL text and returns JSON,
with every ELL bucket of every hop computed by the hand-written CUDA
kernel in `csrc/bucket_hop.cu` (wrapper: `ops/bucket_hop.py`).
"""
