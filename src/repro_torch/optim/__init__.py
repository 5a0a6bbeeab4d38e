from repro_torch.optim.lora import apply_lora, init_lora, lora_param_count
from repro_torch.optim.optimizers import (OptState, adamw_init, adamw_update,
                                          make_optimizer, momentum_init,
                                          momentum_update, sgd_update)
from repro_torch.optim.schedules import constant, cosine, linear_warmup
