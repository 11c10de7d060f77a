"""Mesh serving in one process: shards, their local programs and the
collectives between them (`mesh.py`, `pshard.py`, `dhop.py`, `dsort.py`,
`dbfs.py`)."""
