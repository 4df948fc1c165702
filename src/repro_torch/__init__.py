"""PyTorch / CUDA port of the decentralized data-parallel training system.

Mirrors the layout of the reference package ``repro``: ``core`` (graphs,
mixing programs, topologies, DBench), ``optim``, ``data``, ``configs``,
``models``, ``kernels`` (hand-written CUDA kernels for Hopper, each beside
its plain PyTorch twin), ``launch`` (the trainer and its CLI),
``checkpoint`` (the reference's checkpoint files) and ``examples``.  It
imports ``torch`` and nothing of ``jax`` or ``repro``.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
