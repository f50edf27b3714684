"""Self-contained ONNX emission for the port (no onnx package required).

- protowire: raw protobuf wire-format codec
- builder: ONNX ModelProto/GraphProto construction + parsing
- checker: an independent structural checker of serialized models
- lowering: ``torch.export`` program -> ONNX graph conversion
- interpreter: numpy evaluator used to validate emitted models

The first four are copies of the JAX package's numpy modules; the lowering
is the port's own.
"""

from .interpreter import run_model  # noqa: F401
from .lowering import EMITTED_OPS, LoweringError, lower_program  # noqa: F401
