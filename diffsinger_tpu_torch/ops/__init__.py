"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

* K1 ``depthwise_conv.depthwise_conv1d_prelu``
* K2 ``lynx_fused.fused_conv_module``
* K3 ``flash_attention.flash_attention``
* K4 ``wavenet_block.residual_stack``

A wrapper takes the plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises; it never falls back. ``native`` builds the
kernels from ``csrc/`` at first use.
"""
