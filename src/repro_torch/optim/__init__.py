"""AdamW and learning-rate schedules on the port's parameter trees."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,  # noqa: F401
                                     adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedules import (constant_schedule,  # noqa: F401
                                         cosine_schedule, linear_warmup)
