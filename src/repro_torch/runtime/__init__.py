"""The runtime of the port — the counterpart of ``repro.runtime``: the int8
error-feedback gradient sync and the fault-tolerant training loop, exported
as the JAX package exports them; GPipe is ``repro_torch.runtime.pipeline``.
Given the port's ``Mesh``, the sync and the pipeline run every mesh
position from one process, each on its own device (several positions may
share a card); given a ``torch.distributed`` ``DeviceMesh``, each rank
runs its own position over the process group."""
from repro_torch.runtime.compression import (quantize_int8, dequantize_int8,
                                             compressed_grad_sync,
                                             init_error_state)
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop, StepWatchdog
