"""AdamW of the port — the counterpart of ``repro.optim``."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                    init_opt_state, schedule)
