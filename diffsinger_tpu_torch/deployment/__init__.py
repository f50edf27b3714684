"""Export of the port's models (counterpart of diffsinger_tpu/deployment/):
``.pt2`` programs from ``torch.export`` that launch the hand-written kernels
on the card, ONNX graphs lowered from the same programs, their attachments,
and the runtimes that serve a bundle."""
