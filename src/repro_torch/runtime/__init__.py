"""The fault-tolerant training loop of the port — the counterpart of
``repro.runtime.fault_tolerance``.  ``repro.runtime``'s compression and
pipeline modules need several devices and a process group and are not
ported yet."""
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop, StepWatchdog
