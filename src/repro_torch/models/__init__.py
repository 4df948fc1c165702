"""Models: the dense transformer family and the paper's own benchmark models
(the counterpart of ``repro/models``)."""
