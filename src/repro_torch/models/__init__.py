"""Models: the model zoo's families (dense, moe, ssm, hybrid, audio, vlm)
and the paper's own benchmark models (the counterpart of ``repro/models``)."""
