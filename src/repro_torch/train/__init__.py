"""Training: state, step functions, checkpointing and the loop."""
from repro_torch.train.state import (TrainState,  # noqa: F401
                                     abstract_train_state, make_train_state,
                                     train_state_axes,
                                     train_state_from_params, train_state_to)
from repro_torch.train.step import make_eval_step, make_train_step  # noqa: F401
