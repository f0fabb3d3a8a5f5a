from pathtrace_tpu_torch.data.collect import collect_dataset, random_pose, render_pair
from pathtrace_tpu_torch.data.patches import get_patches, patch_score

__all__ = [
    "collect_dataset",
    "random_pose",
    "render_pair",
    "get_patches",
    "patch_score",
]
