"""W8A8 quantised matmul of the port (``repro.quant``'s exports)."""
from repro_torch.quant.aqt import QuantizedLinear, quantized_matmul, quantize_symmetric
