from structured_alignment_vqa_tpu_torch.parallel.train_step import (
    TrainState,
    adam,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = ["TrainState", "adam", "create_train_state", "make_eval_step", "make_train_step"]
