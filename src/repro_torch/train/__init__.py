"""Training, port of `repro/train`: optimizers, the loss and train step,
checkpoints in the reference's layout and the fault-tolerant loop."""
from .optimizer import adafactor, adamw, make_optimizer  # noqa: F401
from .trainstep import loss_fn, make_train_step  # noqa: F401
