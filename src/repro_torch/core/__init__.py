"""Core: graphs, the mixing-program IR, topologies, the flat state layout
and DBench (the counterparts of ``repro/core``)."""
