"""Post-training int8 quantization, as in ``veles_tpu/quant``:
:mod:`~veles_tpu_torch.quant.ptq` calibrates and quantizes a model
spec, :mod:`~veles_tpu_torch.quant.forward` builds the int8 forward
over ``ops/matmul_int8.py``."""

from veles_tpu_torch.quant.forward import (  # noqa: F401
    build_quantized_forward, is_quantized_entry, is_quantized_params)
from veles_tpu_torch.quant.ptq import (  # noqa: F401
    CalibrationResult, calibrate_activations, calibration_dir,
    quantize_model_spec, quantize_tensor, quantize_weights)

__all__ = ["CalibrationResult", "build_quantized_forward",
           "calibrate_activations", "calibration_dir",
           "is_quantized_entry", "is_quantized_params",
           "quantize_model_spec", "quantize_tensor",
           "quantize_weights"]
