"""Training: the weight head (or the whole net) through the differentiable
homography fit on synthetic pairs, and the flow datasets and augmentors.
The exports of ``woft_tpu/training/__init__.py``."""

from .synth import synth_homography_batch, random_homography  # noqa: F401
from .train import TrainConfig, make_train_step, init_train_state  # noqa: F401
from .augment import FlowAugmentor  # noqa: F401
from .datasets import (FlowDataset, MpiSintel, FlyingChairs,  # noqa: F401
                       KITTI, batch_iterator)
