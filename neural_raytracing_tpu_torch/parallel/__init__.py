from .mesh import (
    Mesh, Sharding, all_gather, data_sharding, gather_views, initialize_multihost, make_mesh,
    make_parallel_train_step, pad_batch, padded_size, reduce_grads, replicate, replicated,
    shard_batch, sharded_render_rays,
)
