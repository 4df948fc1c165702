"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain twin.

gossip_update    K1: fused momentum-SGD + weighted neighbor mix over G nodes;
                 K2: the same over one rank's node
stats            K3: segmented row L2 norms (the DBench per-tensor probe)
flash_attention  K4: forward online-softmax attention (causal, GQA, window)

``ref.py`` gives the plain twins the reference oracles' signatures, ``ops.py`` the public wrappers and launch
counters, ``_build.py`` the nvcc build and ctypes binding.
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import flash_attention
