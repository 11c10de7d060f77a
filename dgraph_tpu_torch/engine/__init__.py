"""Port of dgraph_tpu/engine (see the package docstring)."""
