"""The plain reference of each model: one module a configuration names by
its ``reference`` key (``perfbench.reference.model``)."""
