from repro_torch.optim.schedules import constant, lr_scale, one_cycle, warmup_multistep
from repro_torch.optim.sgd import Optimizer, get_optimizer, sgd
