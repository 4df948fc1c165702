"""The reference's examples as modules of the port: ``python -m
repro_torch.examples.quickstart`` and ``python -m
repro_torch.examples.dbench_whitebox`` (on the card; ``main(argv,
device="cpu")`` runs them on the CPU)."""
