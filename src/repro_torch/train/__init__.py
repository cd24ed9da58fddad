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
    abstract_train_state,
    make_loss_fn,
    make_train_state,
    make_train_step,
    shard_train_state,
    train_state_logical_axes,
    train_state_shardings,
    train_step,
    value_and_grad,
)
