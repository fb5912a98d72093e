from repro_torch.optim.adamw import (OptState, adamw, apply_updates,
                                     clip_by_global_norm, global_norm, sgd)
