"""Training: the step, the host loop, evaluation, optimizer and checkpoints.

Counterpart of ``neural_raytracing_tpu/training``: the host data path, the
on-device one (``device_dataset``, ``make_device_data_step``,
``train(device_data=)``) and data parallelism over a ``parallel.Mesh``
(``train(mesh=)``).
"""

from .calibrate import calibrate_exposure
from .checkpoint import (
    load_pytree, load_scene, load_train_state, save_pytree, save_scene, save_train_state,
)
from .datasets import (
    ColocateDataset, DTUDataset, NeRFDataset, NeRVDataset, decompose_projection,
    dtu_dataset, load_colocate, load_colocate_relight_grid, load_dtu,
    load_nerf_synthetic, load_nerv,
)
from .eval import evaluate
from .loop import (
    TrainState, build_step_fn, default_extra_loss, device_dataset,
    init_train_state, make_device_data_step, make_train_step, rand_uv, rand_uv_mask, train,
)
from .loss_sampler import LossSampler
from .optim import (
    AdamWConfig, broadcast_state, clip_grads, global_norm, make_optimizer,
)
