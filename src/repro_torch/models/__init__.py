"""Models: the dense transformer family (the counterpart of ``repro/models``)."""
