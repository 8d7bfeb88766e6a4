from .pose_eval import (
    evaluate_sequence,
    load_pose_dir,
    read_sintel_cam,
    read_scannet_pose,
)
from .traj_iou import trajectory_label_metrics
