"""Export of the port: int8 weight packs (write and read), the forward and
streaming-step programs (`torch.export`), ONNX and TorchScript artifacts of
the model with `torch.nn.GRU` recurrences, and the latency bench across
engines (`rt_bench`). The JAX package's exports, without TFLite, which is
TensorFlow's format (`export.py`)."""

from tinyrecurrentunet_torch.export.export import export_program, load_program  # noqa: F401
from tinyrecurrentunet_torch.export.onnx_export import (  # noqa: F401
    export_onnx,
    export_torchscript,
    onnx_parity_report,
    optimize_onnx,
)
from tinyrecurrentunet_torch.export.quantize import (  # noqa: F401
    dequantize_params,
    load_quantized,
    quantize_params,
    save_quantized,
)
