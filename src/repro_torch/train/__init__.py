from repro_torch.train.optimizer import adamw_init, adamw_update, OptHParams  # noqa: F401
from repro_torch.train.steps import make_train_step, make_serve_step, make_prefill  # noqa: F401
from repro_torch.train.checkpoint import save_checkpoint, restore_checkpoint, latest_step  # noqa: F401
