"""Batched serving demo: the counterpart of ``examples/serve_decode.py``.

A reduced architecture in float32 from seeded weights and prompts, greedy
and sampled ``generate`` through ``ServeEngine`` (the prompt's prefill run
and its tokens replayed into the KV cache), sampling from an explicit
``torch.Generator``; on the card unless ``main(..., device="cpu")``.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--arch granite-8b] [--new 16]
"""
from repro_torch.launch.serve import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
