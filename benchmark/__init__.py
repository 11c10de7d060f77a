"""The port's benchmark: one cell of BENCHMARK.json per run.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (`configs/<name>.json`, whose `family`
picks the set-up in `families/<family>.py`) and a traffic mix
(`traffic/<name>.json`, whose `driver` picks the window loop in
`drivers/<driver>.py`); each per-layer metric is read by
`metrics/<name>.py`. `reference/` holds the generators, the plain
reference, the peaks and the bounds; `control.py` reads the controls of
`correct`; `candidates/` holds cells proven correct that BENCHMARK.json
does not hold yet. Nothing here imports JAX or the JAX package.

Tests: `python -m pytest benchmark/tests -q` on the CPU (the card tests
skip); `python3 -m pytest benchmark/tests -m cuda` on the card.
"""
