"""Training: the step, the host loop, evaluation, optimizer and checkpoints.

Counterpart of ``neural_raytracing_tpu/training`` on its host path (no
device mesh, no on-device data path yet).
"""

from .calibrate import calibrate_exposure
from .checkpoint import (
    load_scene, load_train_state, save_scene, save_train_state,
)
from .datasets import (
    ColocateDataset, NeRFDataset, NeRVDataset, load_colocate,
    load_colocate_relight_grid, load_nerf_synthetic, load_nerv,
)
from .eval import evaluate
from .loop import (
    TrainState, build_step_fn, default_extra_loss, init_train_state, rand_uv,
    rand_uv_mask, train,
)
from .loss_sampler import LossSampler
from .optim import (
    AdamWConfig, broadcast_state, clip_grads, global_norm, make_optimizer,
)
