"""`python -m dgraph_tpu_torch <subcommand>` (see `cli.py`).

The guard matters: the bulk loader spawns its mappers, and a spawned
child re-imports the main module; without it, every mapper would start
the CLI again."""

if __name__ == "__main__":
    from dgraph_tpu_torch.cli import main
    raise SystemExit(main())
