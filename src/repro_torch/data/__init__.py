"""The synthetic LM data stream of the port — the counterpart of
``repro.data``."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       batch_to_device)
