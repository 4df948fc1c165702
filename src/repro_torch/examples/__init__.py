"""The reference's examples as modules of the port: ``python -m
repro_torch.examples.quickstart``, ``python -m
repro_torch.examples.dbench_whitebox`` and ``python -m
repro_torch.examples.train_100m`` (a (4 data × 2 model) world of ranks)
(on the card; ``main(argv, device="cpu")`` runs them on the CPU)."""
