from .infer import cut_windows, segment_tracks
from .train import TrainState, create_train_state, train_step, eval_step, weighted_bce, cls_iou
