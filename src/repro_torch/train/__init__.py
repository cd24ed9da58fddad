"""The training substrate (port of ``repro.train``): the train step, the
fault-tolerant loop and its machinery."""

from repro_torch.train.fault_tolerance import (  # noqa: F401
    FailureInjector,
    Heartbeat,
    PreemptionHandler,
    StepTimer,
)
from repro_torch.train.loop import LoopResult, run_training  # noqa: F401
from repro_torch.train.step import (  # noqa: F401
    make_loss_fn,
    make_train_state,
    make_train_step,
    train_step,
    value_and_grad,
)
